"""optimizer_device_ms (``.train``, ``.small_batch``): device milliseconds a training step spends
on the work launched inside the trainer's ``train.optimizer`` range
(``optim/adamw.py``'s update and ``clip_by_global_norm``)."""
RANGE = "train.optimizer"


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.units:
        return None
    us = tr.device_us_in(RANGE)
    return None if us is None else us / 1e3 / len(tr.units)
