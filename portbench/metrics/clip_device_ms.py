"""clip_device_ms (``.train``, ``.small_batch``): device milliseconds a
training step spends on the work launched inside the span
``optim.clip``: ``optim/adamw.py``'s ``clip_by_global_norm`` (or
``clip_by_global_norm_on_mesh``): the sum of squares over every leaf,
the all-reduce where there is one, and the scaling. None where the
program opens no such span."""
from portbench.metrics._phase import device_ms

SPAN, PHASE = "optim.clip", "train.optimizer"


def read(ctx):
    return device_ms(ctx, SPAN, PHASE)
