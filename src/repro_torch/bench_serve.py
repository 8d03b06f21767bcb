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
values in both packages. The ``gpu`` tests drive the soak on the card;
the CPU tests hold it to the reference.

On the card, :func:`server_rates` times a wall-clock ``Server`` and
:func:`flush_profile` profiles the engine's flush of PolyBench gemm
MEDIUM; from the repository root:

    PYTHONPATH=src python3 -m repro_torch.bench_serve

prints one JSON line each (the Server for the paper and the model mix),
then the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
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


def server_session(engine: Engine, classes: Dict[str, object], reqs,
                   config: ServeConfig, poll_s: float) -> Tuple[Dict, float]:
    """One client thread submits ``reqs`` (``(time, label, inputs)``) to a
    wall-clock ``Server`` as fast as it can; returns the server's report
    and the seconds from the first submission to the last answer.
    ``poll_s`` is the server's wait on an empty ingress queue."""
    from repro_torch.serve import Server
    tickets = []
    srv = Server(engine, config, poll_s=poll_s)
    try:
        def client():
            for _, label, ins in reqs:
                tickets.append(srv.submit(classes[label], ins))
        t0 = time.perf_counter()
        th = threading.Thread(target=client, name="serve-client")
        th.start()
        th.join(120)
        if th.is_alive():
            raise TimeoutError("the client did not finish submitting")
        for tk in tickets:
            tk.result(timeout=300)
        wall = time.perf_counter() - t0
    finally:
        srv.stop(timeout=300)
    return srv.core.report(), wall


def server_rates(mix: str = "paper", n: int = 256, length: int = 4096,
                 device=None, seed: int = 0) -> Dict:
    """A warm ``Server`` on ``Engine(backend="cuda")`` answering ``n``
    requests of ``mix`` from one client, back to back, at the default
    ``poll_s`` (2 ms) and at 0.1 ms: requests/s each, and the device's idle
    share at the default, its profiled device time over the unprofiled
    wall. Warm: one request a class first records each class's timing
    trace."""
    from repro_torch.bench_kernels import device_ms
    from repro_torch.serve import make_labeled_requests
    eng = fresh_engine("cuda", device)
    classes = serve_classes(eng, length, mix=mix)
    rng = np.random.default_rng(seed)
    cfg = ServeConfig(queue_capacity=n)
    server_session(eng, classes, [
        (0.0, label, request_inputs(classes[label], length, rng, label=label))
        for label in sorted(classes)], cfg, 0.002)
    reqs = make_labeled_requests(classes, np.zeros(n), length, rng,
                                 weights=_mix_weights(mix))
    walls = {}
    for poll_s in (0.002, 1e-4):
        rep, walls[poll_s] = server_session(eng, classes, reqs, cfg, poll_s)
        if rep["served"] != n or rep["failed"]:
            raise RuntimeError(f"the Server answered {rep['served']} of {n} "
                               f"({rep['failed']} failed)")
    busy_ms, by_name = device_ms(lambda: server_session(
        eng, classes, reqs, cfg, 0.002), reps=1, per_call=True)
    return {"case": f"Server {mix} mix, {n} requests at length {length}",
            "requests_per_s_poll_2ms": n / walls[0.002],
            "requests_per_s_poll_0.1ms": n / walls[1e-4],
            "wall_s": walls[0.002], "device_busy_ms": busy_ms,
            "idle_share": None if busy_ms is None
            else 1 - busy_ms / 1e3 / walls[0.002],
            "device_ms_by_name": by_name}


def flush_profile(device=None, seed: int = 3) -> Dict:
    """PolyBench gemm MEDIUM (200 x 220 x 240) through
    ``Engine(backend="cuda")``, its artifacts compiled first: the wall of
    one ``clients.run_gemm`` and the device's time in it by name, copies
    included."""
    from repro_torch.bench_kernels import device_ms
    from repro_torch.core import kernels_lib as K
    from repro_torch.engine import clients
    rng = np.random.default_rng(seed)
    A, B, C = (rng.integers(-1000, 1000, s).astype(np.int32)
               for s in ((200, 240), (240, 220), (200, 220)))
    eng = fresh_engine("cuda", device)
    eng.compile(K.mac3(240))
    eng.compile(K.axpby(3, 2))
    t0 = time.perf_counter()
    clients.run_gemm(eng, 3, A, B, 2, C.copy())
    wall = time.perf_counter() - t0
    busy_ms, by_name = device_ms(lambda: clients.run_gemm(
        eng, 3, A, B, 2, C.copy()), reps=1, per_call=True)
    return {"case": "Engine flush, PolyBench gemm MEDIUM", "wall_s": wall,
            "device_busy_ms": busy_ms, "device_ms_by_name": by_name}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_serve: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build()
    for out in (server_rates("paper"), server_rates("model"),
                flush_profile()):
        print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
