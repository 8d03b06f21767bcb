"""optimizer_idle_ms (``.train``, ``.small_batch``): milliseconds a
training step in which the device idles while the host is inside the
trainer's ``train.optimizer`` span (clipping and the AdamW update): the
span's host time less the device's busy time within it. Read under the
profiler, whose host work stretches the host's side, so it overstates
the unprofiled idle."""
from portbench.metrics._phase import idle_ms

SPAN = "train.optimizer"


def read(ctx):
    return idle_ms(ctx, SPAN)
