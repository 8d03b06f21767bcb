"""launches_per_step (``.train``, ``.small_batch``): kernel launches the host makes a training
step (runtime calls named ``*LaunchKernel*`` in the profiled steps)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.units:
        return None
    n = tr.launches()
    return n / len(tr.units) if n else None
