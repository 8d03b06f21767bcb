"""moe_combine_ms: device milliseconds a training step spends on the
work launched inside the span ``moe.combine`` (``models/moe.py``
``moe_apply``: the expert outputs put back in token order and summed
with their gate weights), summed over the MoE layers' forwards. None
where the program opens no such span."""
from portbench.metrics._phase import device_ms

SPAN, PHASE = "moe.combine", "train.forward"


def read(ctx):
    return device_ms(ctx, SPAN, PHASE)
