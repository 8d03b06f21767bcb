"""Structured tracing: nested spans in a bounded ring buffer.

A *span* is one timed region of the pipeline (``compile``, ``pnr``,
``cache.lookup``, ``schedule.flush``, ``dispatch.sim``, per-shot ``shot``
spans, ...). Spans nest lexically via context managers; each records its
parent span id and depth, so the recorded stream reconstructs the full
call tree of e.g. one ``Engine.flush`` without any runtime bookkeeping
beyond a per-thread stack.

Finished spans land in a ``deque(maxlen=capacity)`` ring buffer —
recording never allocates unboundedly and never blocks the traced code.
The buffer exports as Chrome-trace / Perfetto JSON (``to_chrome``):
complete ("ph": "X") events with microsecond timestamps, loadable in
``chrome://tracing`` or https://ui.perfetto.dev. ``spans_from_chrome``
round-trips the export back into ``Span`` records (schema test anchor).

Overhead contract: this module never installs itself. ``repro_torch.obs`` holds
the process-global tracer slot; when it is ``None`` (the default),
``obs.span()`` returns a shared no-op context manager and *nothing* here
runs — zero ring-buffer writes, no clock reads, no allocation.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Span:
    """One finished (or in-flight) timed region."""

    sid: int                       # unique per tracer, 1-based
    name: str
    t0_us: float                   # start, microseconds since tracer epoch
    dur_us: float                  # 0.0 while in flight
    parent: int                    # enclosing span's sid (0 = root)
    depth: int                     # nesting depth (0 = root)
    tid: int                       # OS thread id
    attrs: Dict[str, Any]


class _NullSpan:
    """Shared do-nothing context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class _SpanCtx:
    """Context manager recording one span into its tracer's ring."""

    __slots__ = ("_tracer", "_name", "_attrs", "span")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self.span: Optional[Span] = None

    def __enter__(self) -> "_SpanCtx":
        t = self._tracer
        stack = t._stack()
        parent = stack[-1].sid if stack else 0
        self.span = Span(sid=next(t._ids), name=self._name,
                         t0_us=(time.perf_counter() - t._epoch) * 1e6,
                         dur_us=0.0, parent=parent, depth=len(stack),
                         tid=threading.get_ident(), attrs=dict(self._attrs))
        stack.append(self.span)
        return self

    def __exit__(self, *exc) -> bool:
        t = self._tracer
        s = self.span
        s.dur_us = (time.perf_counter() - t._epoch) * 1e6 - s.t0_us
        stack = t._stack()
        if stack and stack[-1] is s:
            stack.pop()
        t._finish(s)
        return False

    def set(self, **attrs) -> "_SpanCtx":
        """Attach attributes to the live span (e.g. measured cycles)."""
        if self.span is not None:
            self.span.attrs.update(attrs)
        else:
            self._attrs.update(attrs)
        return self


class Tracer:
    """Span recorder: per-thread nesting stacks over one shared ring."""

    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._epoch = time.perf_counter()
        self.dropped = 0

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _finish(self, span: Span) -> None:
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(span)

    def span(self, name: str, attrs: Dict[str, Any]) -> _SpanCtx:
        return _SpanCtx(self, name, attrs)

    def spans(self) -> List[Span]:
        """Finished spans in completion order (children before parents)."""
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export
# ---------------------------------------------------------------------------

def to_chrome(spans: List[Span]) -> Dict[str, Any]:
    """Chrome-trace JSON document (complete 'X' events, ts/dur in µs).

    ``span_id`` / ``parent_id`` args make the recorded tree explicit —
    viewers infer nesting from timestamps, ``spans_from_chrome`` uses the
    ids for an exact round trip.
    """
    events = []
    for s in spans:
        events.append({
            "name": s.name, "cat": "strela", "ph": "X",
            "ts": s.t0_us, "dur": s.dur_us, "pid": 0, "tid": s.tid,
            "args": {**s.attrs, "span_id": s.sid, "parent_id": s.parent,
                     "depth": s.depth},
        })
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"producer": "repro_torch.obs"}}


def spans_from_chrome(doc: Dict[str, Any]) -> List[Span]:
    """Inverse of :func:`to_chrome` (ordered by span id)."""
    spans = []
    for e in doc["traceEvents"]:
        if e.get("ph") != "X":
            continue
        args = dict(e.get("args", {}))
        sid = args.pop("span_id")
        parent = args.pop("parent_id")
        depth = args.pop("depth")
        spans.append(Span(sid=sid, name=e["name"], t0_us=e["ts"],
                          dur_us=e["dur"], parent=parent, depth=depth,
                          tid=e["tid"], attrs=args))
    spans.sort(key=lambda s: s.sid)
    return spans


def write_chrome(spans: List[Span], path: str) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome(spans), f, indent=1)
        f.write("\n")
    return path
