"""``repro_torch.obs`` — zero-overhead-when-disabled observability.

Three layers (DESIGN.md §12), one switch:

  * **tracing** (``obs.span``) — nested spans into a ring buffer,
    exportable as Chrome-trace/Perfetto JSON (``trace.py``);
  * **metrics** (``obs.inc`` / ``obs.observe`` / ``obs.set_gauge``) —
    counters, gauges, and numpy-exact-percentile histograms with
    Prometheus-text and JSONL exporters (``metrics.py``);
  * **fabric profiler** (``obs.profiler``) — per-PE/IMN/OMN firing counts,
    occupancy, bubbles, and steady-state II from recorded timing data
    (``profiler.py``; CLI in ``report.py``).

Enablement: ``STRELA_OBS=1`` in the environment at import, or
:func:`enable` programmatically. **Disabled is the default and costs
nothing measurable**: the tracer and registry slots are ``None``, every
instrumentation helper is a single ``None``-check, ``obs.span()`` returns
one shared no-op context manager, and not a byte is written to the ring
buffer (asserted by tests/test_obs.py and benchmarks/perf_smoke.py).

Instrumented call sites live in ``engine/{scheduler,compiler,cache}``,
``core/{multishot,elastic_sim}`` and ``frontend/offload`` — the whole
compile -> cache -> P&R -> schedule -> dispatch pipeline of one
``Engine.flush`` is visually inspectable from one export.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry)
from repro_torch.obs.trace import (NULL_SPAN, Span, Tracer,      # noqa: F401
                                   spans_from_chrome, to_chrome, write_chrome)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Span", "Tracer",
    "disable", "enable", "enabled", "export_chrome", "inc", "observe",
    "registry", "ring_len", "set_gauge", "span", "spans",
    "spans_from_chrome", "to_chrome", "tracer", "write_chrome",
]

# process-global slots: None <=> observability disabled (the default)
_tracer: Optional[Tracer] = None
_registry: Optional[MetricsRegistry] = None


def enabled() -> bool:
    return _tracer is not None


def enable(capacity: int = 65536, fresh: bool = True) -> None:
    """Install a tracer + metrics registry. ``fresh=False`` keeps any
    existing ring/metrics (re-enabling after a temporary disable)."""
    global _tracer, _registry
    if fresh or _tracer is None:
        _tracer = Tracer(capacity=capacity)
    if fresh or _registry is None:
        _registry = MetricsRegistry()


def disable() -> None:
    """Uninstall: every instrumentation site reverts to its no-op path."""
    global _tracer, _registry
    _tracer = None
    _registry = None


def tracer() -> Optional[Tracer]:
    return _tracer


def registry() -> Optional[MetricsRegistry]:
    return _registry


# -- instrumentation helpers (hot-path safe: one None-check when off) -------

def span(name: str, **attrs):
    """Timed region context manager; the shared no-op when disabled."""
    t = _tracer
    if t is None:
        return NULL_SPAN
    return t.span(name, attrs)


def inc(name: str, n: int = 1) -> None:
    r = _registry
    if r is not None:
        r.counter(name).inc(n)


def observe(name: str, value: float) -> None:
    r = _registry
    if r is not None:
        r.histogram(name).observe(value)


def set_gauge(name: str, value: float) -> None:
    r = _registry
    if r is not None:
        r.gauge(name).set(value)


# -- export ----------------------------------------------------------------

def spans() -> List[Span]:
    """Finished spans in completion order ([] when disabled)."""
    t = _tracer
    return t.spans() if t is not None else []


def ring_len() -> int:
    t = _tracer
    return len(t) if t is not None else 0


def export_chrome(path: Optional[str] = None) -> Dict[str, Any]:
    """Chrome-trace document of the current ring (optionally written)."""
    doc = to_chrome(spans())
    if path:
        import json
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
    return doc


# env opt-in: one read at import, so instrumented modules see a stable state
if os.environ.get("STRELA_OBS", "0").lower() not in ("0", "", "false"):
    enable()
