"""The serving soak of ``benchmarks/bench_serve.py`` on the port: one
deterministic run of :class:`repro_torch.serve.ServeEngine` under the
virtual clock, and the capacity calibration that sets its offered rate.

:func:`calibrate`, :func:`soak` and :func:`verify_model_outputs` are the
reference's functions of the same names, with one addition: ``device``,
where the ``"cuda"`` backend runs (the card unless the caller names
another; ``device="cpu"`` takes the kernels' plain versions). ``mix``
selects the paper classes, the model-layer classes of
``repro_torch.workloads`` (``"model"``, drawn with the registry's arrival
weights) or both (``"all"``); a model-mix report re-verifies every served
response against its class's oracle (``oracle_checked`` /
``oracle_mismatches``). The same ``(seed, ServeConfig, mix)`` gives the
same request stream, the same scheduling decisions and the same served
values in both packages. ``chip_smoke.py`` drives the soak on the card;
the tests hold it to the reference.
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


def _mix_weights(mix: str) -> Optional[Dict[str, float]]:
    """The class-mix bias: model traffic uses the registry's arrival
    weights (transformer-block-heavy); the paper mix stays uniform."""
    if mix == "model":
        from repro_torch.workloads import model_weights
        return model_weights()
    return None


def calibrate(backend: str, length: int, device=None,
              mix: str = "paper") -> float:
    """Mean modeled service time (us/request) of the class mix, measured
    by one naive dispatch per class on a throwaway engine."""
    eng = fresh_engine(backend, device)
    classes = serve_classes(eng, length, mix=mix)
    rng = np.random.default_rng(0)
    before = eng.tally.total
    for label, art in classes.items():
        eng.run(art, request_inputs(art, length, rng, label=label))
    cycles = eng.tally.total - before
    return (cycles / len(classes)) * ServeConfig().us_per_cycle


def verify_model_outputs(serve: ServeEngine,
                         classes: Dict[str, object]) -> Tuple[int, int]:
    """Re-verify every served model-class response against its registered
    oracle; returns ``(checked, mismatches)``. What the serving loop
    returned under batching and preemption must be bit-exact with the
    independent closure, per class, per request."""
    from repro_torch.workloads import MODEL_CLASSES
    by_name = {a.name: l for l, a in classes.items()}
    checked = mismatches = 0
    for tk in serve.served:
        wc = MODEL_CLASSES.get(by_name.get(tk.artifact.name, ""))
        if wc is None:
            continue
        checked += 1
        want = wc.oracle(**tk.inputs)
        for i, w in enumerate(want):
            got = np.ravel(np.asarray(tk.outputs[f"out{i}"]))
            if not np.array_equal(got, np.ravel(w)):
                mismatches += 1
                break
    return checked, mismatches


def soak(seed: int, n_requests: int, length: int = 64, backend: str = "sim",
         rate_per_us: Optional[float] = None,
         config: Optional[ServeConfig] = None, bursty: bool = False,
         device=None, mix: str = "paper") -> Tuple[ServeEngine, Dict]:
    """One deterministic serve run: seeded workload -> drive -> report
    (with ``results_digest``; model-mix reports also carry
    ``oracle_checked`` / ``oracle_mismatches``). ``rate_per_us=None``
    offers the calibrated capacity. Returns ``(serve_engine, report)``."""
    engine = fresh_engine(backend, device)
    classes = serve_classes(engine, length, mix=mix)
    rng = np.random.default_rng(seed)
    if rate_per_us is None:
        rate_per_us = 1.0 / calibrate(backend, length, device, mix=mix)
    if bursty:
        times = bursty_arrival_times(rng, n_requests, burst_size=16,
                                     gap_us=8.0 / rate_per_us)
    else:
        times = poisson_arrival_times(rng, n_requests, rate_per_us)
    reqs = make_requests(classes, times, length, rng,
                         weights=_mix_weights(mix))
    serve = ServeEngine(engine, config or ServeConfig())
    report = serve.drive(reqs)
    report["results_digest"] = serve.results_digest()
    if mix != "paper":
        checked, bad = verify_model_outputs(serve, classes)
        report["oracle_checked"] = checked
        report["oracle_mismatches"] = bad
    return serve, report
