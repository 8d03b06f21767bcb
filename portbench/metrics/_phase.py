"""What the readers of the training step's phases share (no metric of its
own): the spans that ``repro_torch.obs.ranges`` opens, read from the
profiled stretch's host events, device ranges and device operations, so
that no look-back limit applies.

* The device time of a span: ``Trace.device_us_in`` (the span on the
  device's timeline, else the operations its host ops launched). A span
  nested in a phase (``optim.adamw`` in ``train.optimizer``) has no range
  of its own on the device, since the profiler gives each kernel to the
  innermost user annotation alone, and a profile may link no operation
  to its host op: then the phase's operations on the device, in launch
  order on the one stream, are matched one to one with the calls that
  enqueue device work inside the phase's host span, and the span's
  share is the operations whose call lies inside it.
* The idle of a span: the union of its host intervals in the stretch,
  less the union of the device's operations within them: the time the
  device waits while the host is inside that phase."""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

from portbench.trace import Trace, _merged, union_us

Interval = Tuple[float, float]
# the CUDA API calls that put one operation on a device queue
# (cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync, cudaMemsetAsync)
ENQUEUE = re.compile(r"^cu(da)?(Launch|Memcpy|Memset)")


def host_intervals(tr: Trace, name: str) -> List[Interval]:
    """The stretch's host events named ``name``, merged and clipped to
    the stretch."""
    return _merged((max(s, tr.start), min(t, tr.end)) for n, s, t in tr.host
                   if n == name and s < tr.end and t > tr.start)


def idle_us(tr: Trace, intervals: List[Interval]) -> float:
    """The time within ``intervals`` (disjoint) in which no operation ran
    on the device."""
    total = sum(t - s for s, t in intervals)
    busy = union_us((max(s, a), min(t, b)) for _, s, t, _ in tr.ops
                    for a, b in intervals if s < b and t > a)
    return total - busy


def in_launch_order_us(tr: Trace, name: str, phase: str) -> Optional[float]:
    """Device time of the work enqueued inside the host span ``name``,
    nested in ``phase``, by launch order within each of the phase's
    ranges; None unless each host span of the phase pairs with a device
    range holding as many operations as the span makes enqueue calls."""
    hosts = host_intervals(tr, phase)
    devs = sorted((s, t) for n, s, t in tr.device_ranges if n == phase)
    inner = host_intervals(tr, name)
    if not inner or not hosts or len(hosts) != len(devs):
        return None
    calls = sorted(s for n, s, _ in tr.host if ENQUEUE.match(n))
    ops = sorted((s, t) for _, s, t, _ in tr.ops)
    busy: List[Interval] = []
    for (ha, hb), (da, db) in zip(hosts, devs):
        mine = [c for c in calls if ha <= c <= hb]
        work = [op for op in ops if da <= op[0] <= db]
        if len(mine) != len(work):
            return None
        busy += [op for c, op in zip(mine, work)
                 if any(a <= c <= b for a, b in inner)]
    return union_us(busy)


def device_ms(ctx, name: str, phase: str) -> Optional[float]:
    """Device milliseconds a step of the work launched inside ``name``,
    a span nested in ``phase``."""
    tr = ctx.trace
    if tr is None or not tr.units:
        return None
    us = tr.device_us_in(name)
    if us is None:
        us = in_launch_order_us(tr, name, phase)
    return None if us is None else us / 1e3 / len(tr.units)


def idle_ms(ctx, name: str) -> Optional[float]:
    """Device idle milliseconds a step while the host is inside ``name``;
    None where the stretch holds no such span."""
    tr = ctx.trace
    if tr is None or not tr.units:
        return None
    spans = host_intervals(tr, name)
    if not spans:
        return None
    return idle_us(tr, spans) / 1e3 / len(tr.units)
