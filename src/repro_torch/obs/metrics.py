"""Metrics registry: counters, gauges, histograms + text exporters.

Naming convention (DESIGN.md §12): dotted lowercase paths, layer first —
``engine.requests``, ``engine.request_latency_us``, ``artifact_cache.hit``,
``shot.trace_replays``, ``compile.cache_misses``. Units are spelled in the
name (``_us``, ``_cycles``) so exports need no unit metadata.

Exporters:
  * :meth:`MetricsRegistry.to_prometheus` — Prometheus text exposition
    (dots become underscores, a ``strela_`` prefix namespaces the repo;
    histograms export summary-style quantile samples + ``_count``/``_sum``);
  * :meth:`MetricsRegistry.dump_jsonl` — one JSON object per metric, the
    machine-readable sink benchmarks and CI artifacts consume.

Histogram percentiles use linear interpolation on the recorded samples —
bit-identical to ``numpy.percentile`` (asserted by tests/test_obs.py), so
latency p50/p90/p99 lines agree with any offline numpy analysis of the
same JSONL dump.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def to_dict(self) -> Dict[str, Any]:
        return {"type": "counter", "name": self.name, "value": self.value}


class Gauge:
    """Last-written value (queue depth, cycles saved, ...)."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def to_dict(self) -> Dict[str, Any]:
        return {"type": "gauge", "name": self.name, "value": self.value}


class Histogram:
    """Sample distribution with numpy-exact percentiles.

    Samples are kept verbatim up to ``max_samples`` (default 200k — a full
    bench run records a few thousand); past the cap only count/sum update,
    and ``saturated`` flags that percentiles describe the prefix.
    """

    __slots__ = ("name", "help", "max_samples", "count", "sum", "_samples")

    def __init__(self, name: str, help: str = "", max_samples: int = 200_000):
        self.name = name
        self.help = help
        self.max_samples = max_samples
        self.count = 0
        self.sum = 0.0
        self._samples: List[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if len(self._samples) < self.max_samples:
            self._samples.append(v)

    @property
    def saturated(self) -> bool:
        return self.count > len(self._samples)

    def samples(self) -> List[float]:
        return list(self._samples)

    def percentile(self, p: float) -> float:
        if not self._samples:
            return float("nan")
        return float(np.percentile(np.asarray(self._samples), p))

    def percentiles(self, ps: Sequence[float] = (50, 90, 99)
                    ) -> Dict[float, float]:
        return {p: self.percentile(p) for p in ps}

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def to_dict(self) -> Dict[str, Any]:
        d = {"type": "histogram", "name": self.name, "count": self.count,
             "sum": self.sum, "mean": self.mean}
        for p in (50, 90, 99):
            d[f"p{p}"] = self.percentile(p)
        return d


Metric = Any     # Counter | Gauge | Histogram


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors.

    A name is bound to one metric type forever; asking for the same name
    with a different type raises instead of silently shadowing.
    """

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _get(self, name: str, cls, help: str, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def histogram(self, name: str, help: str = "",
                  max_samples: int = 200_000) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Histogram(name, help,
                                                max_samples=max_samples)
        elif not isinstance(m, Histogram):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not Histogram")
        return m

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def metrics(self) -> List[Metric]:
        return list(self._metrics.values())

    # -- exporters ---------------------------------------------------------
    @staticmethod
    def _prom_name(name: str) -> str:
        clean = name.replace(".", "_").replace("-", "_")
        return f"strela_{clean}"

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines: List[str] = []
        for m in self._metrics.values():
            pn = self._prom_name(m.name)
            if m.help:
                lines.append(f"# HELP {pn} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pn} counter")
                lines.append(f"{pn} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pn} gauge")
                lines.append(f"{pn} {m.value}")
            else:
                lines.append(f"# TYPE {pn} summary")
                for q in (0.5, 0.9, 0.99):
                    v = m.percentile(q * 100)
                    lines.append(f'{pn}{{quantile="{q}"}} {v}')
                lines.append(f"{pn}_sum {m.sum}")
                lines.append(f"{pn}_count {m.count}")
        return "\n".join(lines) + "\n"

    def to_dicts(self) -> List[Dict[str, Any]]:
        return [m.to_dict() for m in self._metrics.values()]

    def dump_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for d in self.to_dicts():
                f.write(json.dumps(d) + "\n")
        return path
