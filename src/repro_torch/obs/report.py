"""Profiler CLI: per-kernel fabric utilization heat-tables + exports.

Runs the paper kernels through the real execution pipeline (one
``Engine`` with obs enabled: compile -> artifact cache -> P&R -> one
batched ``flush`` over every submitted request), then derives per-PE /
per-IMN / per-OMN occupancy from the recorded timing data — a
``TimingTrace`` when the artifact carries one (static-rate kernels), the
representative ``SimResult`` otherwise — and names each kernel's
bottleneck resource. Optionally exports the whole run's span tree as
Chrome-trace JSON plus the metrics registry in Prometheus text / JSONL.

    PYTHONPATH=src python -m repro_torch.obs.report --kernel fft --kernel dither \
        --length 64 --chrome-trace obs_trace.json --metrics obs_metrics.prom

Load the trace JSON in chrome://tracing or https://ui.perfetto.dev to see
the compile/cache.lookup/pnr/schedule.flush/dispatch span hierarchy.
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.core import kernels_lib as K
from repro_torch.core.dfg import DFG
from repro_torch.core.fabric import Fabric
from repro_torch.obs.profiler import FabricProfile, profile_sim, profile_trace

# paper kernels runnable straight from kernels_lib (length-parametric)
KERNELS: Dict[str, Callable[[int], DFG]] = {
    "fft": lambda n: K.fft_butterfly(),
    "dither": lambda n: K.dither(),
    "find2min": lambda n: K.find2min(),
    "relu": lambda n: K.relu(),
    "vadd": lambda n: K.vadd(),
    "axpby": lambda n: K.axpby(3, 5),
    "mac1": lambda n: K.mac1(n),
    "div_loop": lambda n: K.div_loop(7),
}


def _inputs(g: DFG, length: int, rng) -> Dict[str, np.ndarray]:
    lo, hi = (0, 100) if g.has_recirculation() else (-64, 64)
    return {name: rng.integers(lo, hi, length).astype(np.int32)
            for name in g.inputs}


def profile_artifact(engine, art, length: int) -> List[FabricProfile]:
    """One profile per shot, preferring the artifact's recorded
    ``TimingTrace`` (bit-identical firing counts by construction) and
    falling back to the runner's representative ``SimResult`` for
    data-dependent kernels."""
    sims = engine.runner.rep_sims()
    mappings = engine.runner.mappings()
    profs: List[FabricProfile] = []
    for shot in art.plan.shots:
        cfg = art.config_class if art.n_shots == 1 else shot.key
        label = art.name if art.n_shots == 1 else f"{art.name}/{shot.key}"
        m = mappings.get(cfg, shot.mapping)
        tr = art.trace_for(cfg, length)
        if tr is not None:
            profs.append(profile_trace(m, tr, kernel=label))
            continue
        sim = None
        for (key, slen, layout), s in sims.items():
            if key == cfg and slen == length:
                sim = s
                break
        if sim is not None:
            profs.append(profile_sim(m, sim, kernel=label, length=length))
    return profs


def run_report(kernels: List[str], length: int = 64, requests: int = 4,
               rows: int = 4, cols: int = 4,
               chrome_trace: Optional[str] = None,
               metrics_path: Optional[str] = None,
               jsonl_path: Optional[str] = None,
               out=sys.stdout) -> List[FabricProfile]:
    """Compile + batch-dispatch the kernels, print utilization tables."""
    from repro_torch.engine import ArtifactCache, Engine

    obs.enable(fresh=True)
    eng = Engine(fabric=Fabric(rows=rows, cols=cols),
                 cache=ArtifactCache(memory_only=True))
    rng = np.random.default_rng(0)

    arts = {}
    for name in kernels:
        if name not in KERNELS:
            raise SystemExit(f"unknown kernel {name!r}; choose from "
                             f"{sorted(KERNELS)}")
        arts[name] = eng.compile(KERNELS[name](length))
    handles = []
    for name, art in arts.items():
        for _ in range(requests):
            handles.append(eng.submit(art, _inputs(art.dfg, length, rng)))
    eng.flush()                      # one batched flush over all classes

    profiles: List[FabricProfile] = []
    for name, art in arts.items():
        for prof in profile_artifact(eng, art, length):
            profiles.append(prof)
            print(prof.table(), file=out)
            print(file=out)

    t = eng.tally
    print(f"flush: {len(handles)} requests / {len(arts)} config classes — "
          f"config={t.config} rearm={t.rearm} exec={t.exec} cycles "
          f"(saved {eng.stats.config_cycles_saved} vs naive)", file=out)

    if chrome_trace:
        obs.export_chrome(chrome_trace)
        print(f"wrote {chrome_trace} ({obs.ring_len()} spans)", file=out)
    reg = obs.registry()
    if metrics_path and reg is not None:
        with open(metrics_path, "w") as f:
            f.write(reg.to_prometheus())
        print(f"wrote {metrics_path}", file=out)
    if jsonl_path and reg is not None:
        reg.dump_jsonl(jsonl_path)
        print(f"wrote {jsonl_path}", file=out)
    return profiles


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", action="append", default=None,
                    metavar="NAME", help=f"kernel to profile (repeatable; "
                    f"default fft + dither; known: {sorted(KERNELS)})")
    ap.add_argument("--length", type=int, default=64)
    ap.add_argument("--requests", type=int, default=4,
                    help="requests per kernel in the batched flush")
    ap.add_argument("--geometry", default="4x4", metavar="RxC")
    ap.add_argument("--chrome-trace", default=None,
                    help="write the span tree as Chrome-trace JSON")
    ap.add_argument("--metrics", default=None,
                    help="write the metrics registry as Prometheus text")
    ap.add_argument("--jsonl", default=None,
                    help="write the metrics registry as JSONL")
    args = ap.parse_args(argv)
    r, c = (int(v) for v in args.geometry.lower().split("x"))
    run_report(args.kernel or ["fft", "dither"], length=args.length,
               requests=args.requests, rows=r, cols=c,
               chrome_trace=args.chrome_trace, metrics_path=args.metrics,
               jsonl_path=args.jsonl)
    return 0


if __name__ == "__main__":
    sys.exit(main())
