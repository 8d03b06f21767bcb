"""backward_idle_ms (``.train``, ``.small_batch``): milliseconds a
training step in which the device idles while the host is inside the
trainer's ``train.backward`` span (``torch.autograd.grad``, whose
kernels autograd launches from a thread of its own): the span's host
time less the device's busy time within it. Read under the profiler,
whose host work stretches the host's side, so it overstates the
unprofiled idle."""
from portbench.metrics._phase import idle_ms

SPAN = "train.backward"


def read(ctx):
    return idle_ms(ctx, SPAN)
