"""The profiled stretch of a run, read from ``torch.profiler``'s events:
the device's operations, the ``record_function`` ranges on the host and
on the device's timeline, the host's kernel launches, and the breakdown
of device time and idle gaps. The per-layer readers in ``metrics/`` take
their numbers from a :class:`Trace`."""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Tuple

STRETCH = "portbench.stretch"
Span = Tuple[str, float, float]          # name, start us, end us
# a device operation: name, start, end (us) and the start of the host op
# that launched it (None where the profile does not link them)
Op = Tuple[str, float, float, Optional[float]]

_NAME = re.compile(r"^(?:void\s+)?(?:[\w]+::)*(?:\(anonymous namespace\)::)?"
                   r"([A-Za-z_]\w*)")


def kernel_name(raw: str) -> str:
    """A device operation's base name: no ``void``, namespace, template
    arguments or parameter list."""
    raw = raw.replace("(anonymous namespace)::", "").strip()
    if raw.startswith(("Memcpy", "Memset")):
        return raw.split(" (")[0]
    m = _NAME.match(raw)
    return m.group(1) if m else raw


def union_us(spans: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    return sum(t - s for s, t in _merged(spans))


def _is_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)) != "CPU"


@dataclasses.dataclass
class Trace:
    ops: List[Op]                # device operations in the stretch
    device_ranges: List[Span]    # record_function ranges on the device
    host: List[Span]             # host events in the stretch
    start: float                 # the stretch, us on the profiler's clock
    end: float
    units: List[Dict]            # the steps or batches profiled

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us((s, t) for _, s, t, _ in self.ops) / 1e6

    def device_us(self, prefixes: Tuple[str, ...]) -> float:
        """Device time of the operations whose base name starts with one
        of ``prefixes``."""
        return sum(t - s for n, s, t, _ in self.ops
                   if kernel_name(n).startswith(prefixes))

    def device_us_in(self, range_name: str) -> Optional[float]:
        """Device busy time of the work launched inside the host ranges
        named ``range_name``: within those ranges on the device's
        timeline, or, where the profile has none there, the operations
        whose launching host op started inside them. None if neither
        can be read."""
        ranges = sorted((s, t) for n, s, t in self.device_ranges
                        if n == range_name)
        if ranges:
            return union_us((max(s, a), min(t, b))
                            for _, s, t, _ in self.ops for a, b in ranges
                            if s < b and t > a)
        host = sorted((s, t) for n, s, t in self.host if n == range_name)
        if not host or all(h is None for *_, h in self.ops):
            return None
        starts = [a for a, _ in host]

        def inside(h):
            i = bisect.bisect_right(starts, h) - 1
            return i >= 0 and h <= host[i][1]
        return union_us((s, t) for _, s, t, h in self.ops
                        if h is not None and inside(h))

    def launches(self) -> int:
        """Kernel launches the host made (runtime calls named
        ``*LaunchKernel*``)."""
        return sum(1 for n, _, _ in self.host if "LaunchKernel" in n)

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host event running at each gap's middle."""
        by_op: Dict[str, float] = {}
        for n, s, t, _ in self.ops:
            k = kernel_name(n)
            by_op[k] = by_op.get(k, 0.0) + (t - s) / 1e6
        host = sorted((s, t, n) for n, s, t in self.host if n != STRETCH)
        starts = [s for s, _, _ in host]
        gaps: Dict[str, float] = {}
        cursor = self.start
        for s, t in _merged((s, t) for _, s, t, _ in self.ops):
            if s > cursor:
                label = _covering(host, starts, (cursor + s) / 2)
                gaps[label] = gaps.get(label, 0.0) + (s - cursor) / 1e6
            cursor = max(cursor, t)
        if self.end > cursor:
            label = _covering(host, starts, (cursor + self.end) / 2)
            gaps[label] = gaps.get(label, 0.0) + (self.end - cursor) / 1e6
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa
        return {"device_ops": [list(kv) for kv in order(by_op)],
                "idle_gaps": [list(kv) for kv in order(gaps)]}


def _merged(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, t in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def _covering(host: List[Tuple[float, float, str]], starts: List[float],
              t: float, look: int = 4000) -> str:
    """The latest-starting host event that covers time ``t``: the
    innermost one where events nest."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "(no host event)"


def from_events(events, units: List[Dict]) -> Trace:
    """The stretch inside the host range :data:`STRETCH` (the run
    synchronises the device on entering and before leaving it)."""
    marks = [e for e in events if e.name == STRETCH and not _is_device(e)]
    if not marks:
        raise ValueError("trace: the profile holds no stretch range")
    a, b = marks[-1].time_range.start, marks[-1].time_range.end
    inside = [e for e in events if a <= e.time_range.start <= b]
    ranges = {e.name for e in inside if not _is_device(e)
              and getattr(e, "is_user_annotation", False)}
    ranges |= {"train.forward", "train.backward", "train.optimizer", STRETCH}
    launched = {e.id: float(e.time_range.start) for e in events
                if not _is_device(e) and hasattr(e, "id")}
    ops, dev_ranges, host = [], [], []
    for e in inside:
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if not _is_device(e):
            host.append(span)
        elif e.name in ranges or getattr(e, "is_user_annotation", False):
            dev_ranges.append(span)
        else:
            link = getattr(e, "linked_correlation_id", 0) or 0
            ops.append(span + (launched.get(link) if link > 0 else None,))
    return Trace(ops, dev_ranges, host, float(a), float(b), units)
