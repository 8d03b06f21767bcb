"""adamw_device_ms (``.train``, ``.small_batch``): device milliseconds a
training step spends on the work launched inside the span
``optim.adamw``: ``optim/adamw.py``'s ``AdamW.update`` (the count, the
bias corrections, the learning rate and the float32 passes over every
leaf). None where the program opens no such span."""
from portbench.metrics._phase import device_ms

SPAN, PHASE = "optim.adamw", "train.optimizer"


def read(ctx):
    return device_ms(ctx, SPAN, PHASE)
