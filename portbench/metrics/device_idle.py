"""device_idle (``.train``, ``.small_batch``, ``.prefill``): the share of
the measured window's time in which no operation ran on the device, in %:
one less the device's busy time a token in the profiled stretch (the
union of its operations) over the window's time a token. The stretch
runs after the window, under the profiler, on work of the same kind and
mix; the window's time comes from the unprofiled host clock, since the
profiler's own host work stretches the traced wall time."""


def tokens(units) -> int:
    return sum(u["batch"] * u["seq"] for u in units)


def read(ctx):
    tr, w = ctx.trace, ctx.window
    if tr is None or not tr.ops or not tr.units or w["seconds"] <= 0:
        return None
    busy = tr.busy_s / tokens(tr.units)
    return 100.0 * (1.0 - busy / (w["seconds"] / tokens(w["units"])))
