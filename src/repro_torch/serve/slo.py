"""SLO tracking: per-class latency percentiles for the serving loop.

Latencies are recorded in serve-clock microseconds (virtual under
``VirtualClock`` — deterministic; wall under ``WallClock``). Percentiles
are ``numpy.percentile`` on the raw samples, the same definition the
``repro_torch.obs`` histograms use, so an SLO report agrees bit-for-bit
with any offline analysis of the mirrored ``serve.request_latency_us``
metric.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch import obs


class SLOTracker:
    """Collects served-request latencies and judges them against an
    optional p99 budget."""

    def __init__(self, p99_budget_us: Optional[float] = None):
        self.p99_budget_us = p99_budget_us
        self._all: List[float] = []
        self._by_class: Dict[str, List[float]] = {}

    def record(self, config_class: str, latency_us: float) -> None:
        latency_us = float(latency_us)
        self._all.append(latency_us)
        self._by_class.setdefault(config_class, []).append(latency_us)
        obs.observe("serve.request_latency_us", latency_us)

    @property
    def count(self) -> int:
        return len(self._all)

    def percentile(self, p: float,
                   config_class: Optional[str] = None) -> float:
        samples = self._all if config_class is None \
            else self._by_class.get(config_class, [])
        if not samples:
            return float("nan")
        return float(np.percentile(np.asarray(samples), p))

    def _stats(self, samples: List[float]) -> Dict[str, float]:
        a = np.asarray(samples)
        return {"count": len(samples),
                "mean_us": float(a.mean()),
                "p50_us": float(np.percentile(a, 50)),
                "p99_us": float(np.percentile(a, 99)),
                "max_us": float(a.max())}

    def report(self) -> Dict:
        if not self._all:
            return {"count": 0, "p99_budget_us": self.p99_budget_us,
                    "met": None, "per_class": {}}
        out = self._stats(self._all)
        out["per_class"] = {c: self._stats(s)
                            for c, s in sorted(self._by_class.items())}
        out["p99_budget_us"] = self.p99_budget_us
        out["met"] = None if self.p99_budget_us is None \
            else bool(out["p99_us"] <= self.p99_budget_us)
        return out
