"""moe_route_ms: device milliseconds a training step spends on the work
launched inside the span ``moe.route`` (``models/moe.py`` ``moe_apply``:
the router, top-k, aux loss, the pairs' sort and the gather of their
rows), summed over the MoE layers' forwards. None where the program
opens no such span."""
from portbench.metrics._phase import device_ms

SPAN, PHASE = "moe.route", "train.forward"


def read(ctx):
    return device_ms(ctx, SPAN, PHASE)
