"""The serving soak of ``benchmarks/bench_serve.py`` on the port: one
deterministic run of :class:`repro_torch.serve.ServeEngine` under the
virtual clock, and the capacity calibration that sets its offered rate.

:func:`calibrate` and :func:`soak` are the reference's functions of the
same names for the paper mix, with one addition: ``device``, where the
``"cuda"`` backend runs (the card unless the caller names another;
``device="cpu"`` takes the kernels' plain versions). The same
``(seed, ServeConfig)`` gives the same request stream, the same scheduling
trace and the same results digest in both packages. ``chip_smoke.py``
drives the soak on the card; the tests hold it to the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.engine import ArtifactCache, Engine
from repro_torch.serve import (ServeConfig, ServeEngine,
                               bursty_arrival_times, make_requests,
                               poisson_arrival_times, request_inputs,
                               serve_classes)


def fresh_engine(backend: str, device=None) -> Engine:
    """An engine with a memory-only artifact cache; ``device`` applies to
    the ``"cuda"`` backend only."""
    kw = {"device": device} if backend == "cuda" else {}
    return Engine(backend=backend, cache=ArtifactCache(memory_only=True),
                  **kw)


def calibrate(backend: str, length: int, device=None) -> float:
    """Mean modeled service time (us/request) of the paper mix, measured
    by one naive dispatch per class on a throwaway engine."""
    eng = fresh_engine(backend, device)
    classes = serve_classes(eng, length)
    rng = np.random.default_rng(0)
    before = eng.tally.total
    for label, art in classes.items():
        eng.run(art, request_inputs(art, length, rng, label=label))
    cycles = eng.tally.total - before
    return (cycles / len(classes)) * ServeConfig().us_per_cycle


def soak(seed: int, n_requests: int, length: int, backend: str,
         rate_per_us: float, config: Optional[ServeConfig] = None,
         bursty: bool = False, device=None) -> Tuple[ServeEngine, Dict]:
    """One deterministic serve run: seeded workload -> drive -> report
    (with ``results_digest``). Returns ``(serve_engine, report)``."""
    engine = fresh_engine(backend, device)
    classes = serve_classes(engine, length)
    rng = np.random.default_rng(seed)
    if bursty:
        times = bursty_arrival_times(rng, n_requests, burst_size=16,
                                     gap_us=8.0 / rate_per_us)
    else:
        times = poisson_arrival_times(rng, n_requests, rate_per_us)
    reqs = make_requests(classes, times, length, rng)
    serve = ServeEngine(engine, config or ServeConfig())
    report = serve.drive(reqs)
    report["results_digest"] = serve.results_digest()
    return serve, report
