#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/csrc`` and runs, in
order: (1) the card's name, power limit and count; (2) the build; (3) every
kernel against its plain PyTorch version, bit-exact, on the card; (4) the
port's main path through ``Engine(backend="cuda")``: PolyBench gemm and
gesummv at MEDIUM size, 256 requests per class of six one-shot kernels at
length 4096, a multi-shot plan and ``fabric_stream``, each checked against
numpy or the port's executor, with the kernels' launch counts read around
it; (5) each kernel's time at the main path's shapes beside its plain
version's time and its bound, and the device time per launch from
``torch.profiler``; (6) one profiled gemm run: wall time against the time
the device was busy. It exits non-zero, printing no result line,
when there is no CUDA device, when the port is missing, or when any phase
fails. The last line is ``{"ok": true, "device": {...}}``.

It imports neither ``jax`` nor the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
# H100 SXM int32 rate outside the tensor cores: 64 INT32 units per SM beside
# 128 FP32 ones, so half the data sheet's 67 TFLOP/s float32 rate.
INT_OPS_PER_S = 33.5e12
SEED = 0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def full_range(rng, shape):
    import numpy as np
    return rng.integers(-2 ** 31, 2 ** 31, size=shape,
                        dtype=np.int64).astype(np.int32)


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

def parity_kernels():
    """The 13 capable kernels_lib DFGs of the reference parity suite."""
    from repro_torch.core import kernels_lib as K
    return {
        "fft": lambda n: K.fft_butterfly(),
        "relu": lambda n: K.relu(),
        "mac1": K.mac1,
        "mac3": K.mac3,
        "mac2x": K.mac2x,
        "axpby": lambda n: K.axpby(3, 5),
        "scale": lambda n: K.scale(7),
        "scale_add": lambda n: K.scale_add(4),
        "vadd": lambda n: K.vadd(),
        "conv2d_row3": lambda n: K.conv2d_row3(1, -2, 3),
        "conv2d_row": lambda n: K.conv2d_row(1, -2, 3),
        "outer_row": lambda n: K.outer_row(2, -3),
        "outer_row2": lambda n: K.outer_row2(2, -3, 5, 1),
    }


def branch_merge_dfg():
    """Branch/Merge with ops on both legs: x > 0 ? (x*3)^y : (x-y)<<2."""
    from repro_torch.core.dfg import DFG
    from repro_torch.core.isa import AluOp, CmpOp
    b = DFG.build("legs")
    x, y = b.inp("x"), b.inp("y")
    c = b.cmp("c", CmpOp.GTZ, x)
    bx = b.branch("bx", x, c)
    by = b.branch("by", y, c)
    t1 = b.alu("t1", AluOp.MUL, bx, const_b=3, a_port="t")
    t2 = b.alu("t2", AluOp.XOR, t1, by, b_port="t")
    f1 = b.alu("f1", AluOp.SUB, bx, by, a_port="f", b_port="f")
    f2 = b.alu("f2", AluOp.SHL, f1, const_b=2)
    m = b.merge("m", t2, f2)
    b.out("out", m)
    return b.done()


def reduction_dfg(op):
    """One single-emission reduction of op over x*y, nonzero acc_init,
    beside a full-rate output."""
    from repro_torch.core.dfg import DFG
    from repro_torch.core.isa import AluOp
    b = DFG.build(f"red_{op.name.lower()}")
    x, y = b.inp("x"), b.inp("y")
    m = b.alu("m", AluOp.ADD, x, y)
    s = b.alu("s", op, m, acc_init=-7 if op != AluOp.AND else 0x7FFF7FFF,
              emit_every=0)
    b.out("sum", s)
    b.out("m_out", m)
    return b.done()


def max_err(a, b) -> int:
    import torch
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def compare_lanes(g, ins, errs) -> None:
    from repro_torch.kernels import fabric_reduce as fr
    kf, kr = fr.reduce_lanes(g, ins)
    pf, pr = fr.reduce_lanes_plain(g, ins)
    for o in pf:
        e = max_err(kf[o], pf[o])
        errs["fabric_reduce_lanes"] = max(errs["fabric_reduce_lanes"], e)
        check(e == 0 and kf[o].shape == pf[o].shape,
              f"{g.name} output {o}: kernel != plain (max err {e})")
    for r in pr:
        e = max_err(kr[r], pr[r])
        errs["fabric_reduce_lanes"] = max(errs["fabric_reduce_lanes"], e)
        check(e == 0, f"{g.name} reduction {r}: kernel != plain "
                      f"(max err {e})")


def compare_stream(g, ins, errs) -> None:
    from repro_torch.kernels import fabric_stream as fs
    k = fs.stream_kernel(g, ins)
    p = fs.stream_plain(g, ins)
    for o in p:
        e = max_err(k[o], p[o])
        errs["fabric_stream"] = max(errs["fabric_stream"], e)
        check(e == 0 and k[o].shape == p[o].shape,
              f"fabric_stream {g.name} output {o}: kernel != plain "
              f"(max err {e})")


def phase_parity(device, lanes=(1, 3, 512),
                 lengths=(0, 1, 127, 1024, 3000, 4096)):
    import numpy as np
    import torch
    from repro_torch.core.isa import AluOp
    rng = np.random.default_rng(SEED)
    errs = {"fabric_reduce_lanes": 0, "fabric_stream": 0}
    graphs = [mk(16) for mk in parity_kernels().values()]
    graphs.append(branch_merge_dfg())
    graphs += [reduction_dfg(op) for op in (AluOp.ADD, AluOp.SUB,
                                            AluOp.MUL, AluOp.AND, AluOp.OR,
                                            AluOp.XOR)]
    n_cmp = 0
    for g in graphs:
        streamable = not any(n.is_reduction() for n in g.nodes.values())
        for length in lengths:
            for n_lanes in lanes:
                ins = {k: torch.from_numpy(full_range(rng, (n_lanes, length)))
                       .to(device) for k in g.inputs}
                compare_lanes(g, ins, errs)
                n_cmp += 1
            if streamable:
                ins = {k: torch.from_numpy(full_range(rng, (length,)))
                       .to(device) for k in g.inputs}
                compare_stream(g, ins, errs)
                n_cmp += 1
    torch.cuda.synchronize() if device.type == "cuda" else None
    print(f"[parity] {len(graphs)} DFGs, {n_cmp} kernel-vs-plain "
          f"comparisons, lanes {list(lanes)}, lengths {list(lengths)}: "
          f"bit-exact (max abs err {errs})")
    return errs


# ---------------------------------------------------------------------------
# phase 4: the main path through Engine(backend="cuda")
# ---------------------------------------------------------------------------

ONE_SHOT_CLASSES = ("relu", "vadd", "fft_butterfly", "axpby", "scale_add",
                    "mac1")


def one_shot_dfgs(length):
    from repro_torch.core import kernels_lib as K
    return {"relu": K.relu(), "vadd": K.vadd(),
            "fft_butterfly": K.fft_butterfly(), "axpby": K.axpby(3, 5),
            "scale_add": K.scale_add(4), "mac1": K.mac1(length)}


def wrap32(x):
    import numpy as np
    return ((np.asarray(x, dtype=np.int64) + 2 ** 31) % 2 ** 32
            - 2 ** 31).astype(np.int32)


def phase_main(device, gemm=(200, 220, 240), gesummv_n=250, per_class=256,
               length=4096, stream_sizes=(4096, 1 << 24)):
    import numpy as np
    import torch
    from repro_torch.core.executor import execute
    from repro_torch.core import kernels_lib as K
    from repro_torch.engine import ArtifactCache, Engine, clients
    from repro_torch.kernels import fabric_reduce as fr
    from repro_torch.kernels import fabric_stream as fs

    def engine(backend):
        kw = {"device": device} if backend == "cuda" else {}
        return Engine(backend=backend, cache=ArtifactCache(memory_only=True),
                      **kw)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(SEED + 1)
    fr.launches = fr.plain_calls = fs.launches = fs.plain_calls = 0
    engines = []
    t_all = time.perf_counter()

    # PolyBench gemm: C = alpha*A@B + beta*C
    NI, NJ, NK = gemm
    A = rng.integers(-1000, 1000, (NI, NK)).astype(np.int32)
    B = rng.integers(-1000, 1000, (NK, NJ)).astype(np.int32)
    C = rng.integers(-1000, 1000, (NI, NJ)).astype(np.int32)
    want = wrap32(3 * (A.astype(np.int64) @ B) + 2 * C.astype(np.int64))
    eng = engine("cuda")
    engines.append(eng)
    t0 = time.perf_counter()
    clients.run_gemm(eng, 3, A, B, 2, C)
    sync()
    t_gemm = time.perf_counter() - t0
    check(np.array_equal(C, want), "gemm: result != numpy int64 reference")
    print(f"[main] gemm NI={NI} NJ={NJ} NK={NK}: {eng.stats.requests} "
          f"requests, {eng.stats.lane_batches} lane grids "
          f"({eng.stats.lane_requests} lanes), {t_gemm:.3f} s wall, "
          f"tally {eng.tally}")

    # PolyBench gesummv: y = alpha*A@x + beta*B@x
    N = gesummv_n
    Ag = rng.integers(-1000, 1000, (N, N)).astype(np.int32)
    Bg = rng.integers(-1000, 1000, (N, N)).astype(np.int32)
    x = rng.integers(-1000, 1000, N).astype(np.int32)
    y = np.zeros(N, dtype=np.int32)
    want = wrap32(2 * (Ag.astype(np.int64) @ x) + 3 * (Bg.astype(np.int64)
                                                      @ x))
    eng = engine("cuda")
    engines.append(eng)
    t0 = time.perf_counter()
    clients.run_gesummv(eng, 2, 3, Ag, Bg, x, y)
    sync()
    t_ges = time.perf_counter() - t0
    check(np.array_equal(y, want), "gesummv: result != numpy reference")
    print(f"[main] gesummv N={N}: {eng.stats.requests} requests, "
          f"{eng.stats.lane_batches} lane grids, {t_ges:.3f} s wall")

    # one-shot traffic: per_class requests of each class, interleaved
    # arrivals, one flush; the same stream through Engine("sim") must
    # account the same cycles
    dfgs = one_shot_dfgs(length)
    eng, sim = engine("cuda"), engine("sim")
    engines.append(eng)
    arts = {c: eng.compile(g) for c, g in dfgs.items()}
    sim_arts = {c: sim.compile(g) for c, g in dfgs.items()}
    reqs = []
    for _ in range(per_class):
        for c in ONE_SHOT_CLASSES:
            ins = {k: full_range(rng, length) for k in dfgs[c].inputs}
            reqs.append((c, ins))
    t0 = time.perf_counter()
    handles = [(c, ins, eng.submit(arts[c], ins)) for c, ins in reqs]
    eng.flush()
    sync()
    t_one = time.perf_counter() - t0
    for c, ins, h in handles:
        ref = execute(dfgs[c], ins)
        got = h.result()
        for o in ref:
            check(np.array_equal(got[o], ref[o]),
                  f"one-shot {c} output {o}: engine != executor")
    t0 = time.perf_counter()
    for c, ins in reqs:
        sim.submit(sim_arts[c], ins)
    sim.flush()
    t_sim = time.perf_counter() - t0
    check(eng.tally == sim.tally,
          f"one-shot tally {eng.tally} != sim {sim.tally}")
    check(eng.stats.config_cycles_paid == sim.stats.config_cycles_paid and
          eng.stats.config_cycles_naive == sim.stats.config_cycles_naive,
          f"one-shot config cycles {eng.stats} != sim {sim.stats}")
    print(f"[main] one-shot {len(ONE_SHOT_CLASSES)} classes x {per_class} "
          f"requests at length {length}: {eng.stats.requests} requests, "
          f"{eng.stats.lane_batches} lane grids, {t_one:.3f} s wall "
          f"(sim engine {t_sim:.3f} s); tally {eng.tally} == sim")

    # one multi-shot plan (pe_limit=1 forces a partition)
    eng = engine("cuda")
    engines.append(eng)
    art = eng.compile(K.axpby(3, 5), pe_limit=1)
    check(art.n_shots > 1, "pe_limit=1 axpby did not partition")
    xa, ya = full_range(rng, length), full_range(rng, length)
    t0 = time.perf_counter()
    got = eng.run(art, {"x": xa, "y": ya})["out"]
    t_ms = time.perf_counter() - t0
    check(np.array_equal(got, wrap32(3 * xa.astype(np.int64)
                                     + 5 * ya.astype(np.int64))),
          "multi-shot axpby != numpy")
    print(f"[main] multi-shot axpby: {art.n_shots} shots, {t_ms:.3f} s")

    # fabric_stream on relu
    for n in stream_sizes:
        xs = torch.from_numpy(full_range(rng, n)).to(device)
        t0 = time.perf_counter()
        out = fs.fabric_stream(K.relu(), {"x": xs})["out"]
        sync()
        dt = time.perf_counter() - t0
        check(torch.equal(out.cpu(), torch.clamp(xs.cpu(), min=0)),
              f"fabric_stream relu n={n} != max(x, 0)")
        print(f"[main] fabric_stream relu n={n}: {dt * 1e3:.3f} ms wall")

    launches = {"fabric_reduce_lanes": fr.launches,
                "fabric_stream": fs.launches}
    plain = {"fabric_reduce_lanes": fr.plain_calls,
             "fabric_stream": fs.plain_calls}
    for e in engines:
        check(e.stats.lane_batch_failures == 0,
              f"lane grid failures: {e.stats}")
    check(sum(e.stats.lane_batches for e in engines) > 0,
          "no lane grid ran")
    if device.type == "cuda":
        check(all(v > 0 for v in launches.values()),
              f"a kernel was never launched on the main path: {launches}")
        check(all(v == 0 for v in plain.values()),
              f"a plain version ran on the main path: {plain}")
    print(f"[main] kernel launches {launches}, plain calls {plain}, "
          f"{time.perf_counter() - t_all:.3f} s total")
    return launches


# ---------------------------------------------------------------------------
# phase 5: times at the main path's shapes
# ---------------------------------------------------------------------------

def time_ms(fn, reps=20, warm=3):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_in_bytes, n_out_bytes, n_ops):
    t_bytes = (n_in_bytes + n_out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def elementwise_ops(g):
    """Integer operations per element: every ALU/CMP/MUX/Branch/Merge."""
    from repro_torch.core import dfg as D
    return sum(1 for n in g.nodes.values()
               if n.kind in (D.ALU, D.CMP, D.MUX, D.BRANCH, D.MERGE))


def phase_times(device, gemm=(200, 220, 240), per_class=256, length=4096,
                stream_n=1 << 24):
    import numpy as np
    import torch
    from repro_torch.core import kernels_lib as K
    from repro_torch.kernels import fabric_reduce as fr
    from repro_torch.kernels import fabric_stream as fs
    rng = np.random.default_rng(SEED + 2)
    NI, NJ, NK = gemm
    rows = {}

    def lanes_case(label, g, n_lanes, n):
        ins = {k: torch.from_numpy(full_range(rng, (n_lanes, n))).to(device)
               for k in g.inputs}
        kf, kr = fr.reduce_lanes(g, ins)
        pf, pr = fr.reduce_lanes_plain(g, ins)
        err = max([max_err(kf[o], pf[o]) for o in pf] +
                  [max_err(kr[r], pr[r]) for r in pr])
        check(err == 0, f"{label}: kernel != plain at main-path shape")
        ms = time_ms(lambda: fr.reduce_lanes(g, ins))
        plain_ms = time_ms(lambda: fr.reduce_lanes_plain(g, ins), reps=5)
        n_el = n_lanes * n
        b_ms, b_by = bound(4 * n_el * len(g.inputs),
                           4 * (n_el * len(pf) + n_lanes * len(pr)),
                           n_el * elementwise_ops(g))
        rows[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, max_abs_err=err)

    lanes_case("fabric_reduce_lanes gemm mac3 grid", K.mac3(NK),
               NI * -(-NJ // 3), NK)
    lanes_case("fabric_reduce_lanes fft grid", K.fft_butterfly(), per_class,
               length)
    g = K.relu()
    xs = {"x": torch.from_numpy(full_range(rng, stream_n)).to(device)}
    k, p = fs.stream_kernel(g, xs), fs.stream_plain(g, xs)
    err = max_err(k["out"], p["out"])
    check(err == 0, "fabric_stream: kernel != plain at main-path shape")
    ms = time_ms(lambda: fs.stream_kernel(g, xs))
    plain_ms = time_ms(lambda: fs.stream_plain(g, xs), reps=5)
    b_ms, b_by = bound(4 * stream_n, 4 * stream_n,
                       stream_n * elementwise_ops(g))
    rows[f"fabric_stream relu n={stream_n}"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        max_abs_err=err)
    for label, r in rows.items():
        print(f"[times] {label}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), share of bound "
              f"{r['bound_ms'] / r['ms']:.3f}, library_ms: none")

    # device time per launch from the profiler: the event times above
    # include the wrapper's host work whenever it outlasts the kernel
    reps = 5
    grids = {}
    for label, gg, n_lanes, n in (("gemm mac3 grid", K.mac3(NK),
                                   NI * -(-NJ // 3), NK),
                                  ("fft grid", K.fft_butterfly(), per_class,
                                   length)):
        ins = {k: torch.from_numpy(full_range(rng, (n_lanes, n))).to(device)
               for k in gg.inputs}
        grids[label] = (lambda gg=gg, ins=ins: fr.reduce_lanes(gg, ins))
    grids[f"relu n={stream_n}"] = lambda: fs.stream_kernel(g, xs)
    for label, fn in grids.items():
        fn()
        prof = profile_run(lambda: [fn() for _ in range(reps)])
        per = {n: us / reps / 1e3 for n, us in prof["by_name"].items()}
        print(f"[profile] {label}: device ms per launch "
              f"{ {n: round(v, 5) for n, v in per.items()} or 'not measured'}")
    return rows


def profile_run(fn):
    """Run ``fn`` under ``torch.profiler``; return the wall time, the time
    the device was busy (union of kernel and copy intervals) and the
    device time per kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].strip()
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    busy, end = 0.0, None
    for s, t in sorted(spans):
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return {"wall_s": wall, "busy_s": busy / 1e6, "by_name": by_name}


def phase_profile(device, gemm=(200, 220, 240)):
    """Where the time of the gemm MEDIUM workload goes: wall vs device
    busy, from one profiled run through Engine(backend="cuda")."""
    import numpy as np
    from repro_torch.core import kernels_lib as K
    from repro_torch.engine import ArtifactCache, Engine, clients
    rng = np.random.default_rng(SEED + 3)
    NI, NJ, NK = gemm
    A = rng.integers(-1000, 1000, (NI, NK)).astype(np.int32)
    B = rng.integers(-1000, 1000, (NK, NJ)).astype(np.int32)
    C = rng.integers(-1000, 1000, (NI, NJ)).astype(np.int32)
    eng = Engine(backend="cuda", device=device,
                 cache=ArtifactCache(memory_only=True))
    eng.compile(K.mac3(NK))              # warm artifact cache: place &
    eng.compile(K.axpby(3, 2))           # route stay outside the window
    prof = profile_run(lambda: clients.run_gemm(eng, 3, A, B, 2, C))
    if not prof["by_name"]:
        print("[profile] gemm MEDIUM: device time not measured (the "
              "profiler recorded no device activity)")
        return
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:6]
    print(f"[profile] gemm MEDIUM through Engine(cuda): wall "
          f"{prof['wall_s']:.4f} s, device busy {prof['busy_s'] * 1e3:.4f} "
          f"ms, device idle share "
          f"{1 - prof['busy_s'] / prof['wall_s']:.5f}; device ms by name "
          f"{ {n: round(us / 1e3, 4) for n, us in top} }")


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[device] {nvidia_smi()}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{count} device(s), device 0: {name}")

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    print(f"[build] {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s")

    errs = phase_parity(device)
    launches = phase_main(device)
    rows = phase_times(device)
    phase_profile(device)

    src = "src/repro_torch/csrc/fabric.cu"
    main_rows = {"fabric_reduce_lanes": (
                     "fabric_reduce_lanes gemm mac3 grid",
                     "src/repro/kernels/fabric_reduce.py:183"),
                 "fabric_stream": (
                     f"fabric_stream relu n={1 << 24}",
                     "src/repro/kernels/fabric_stream.py:86")}
    kernels = []
    for kname, (label, replaces) in main_rows.items():
        r = rows[label]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max(errs[kname], r["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    print(nvidia_smi())                  # name, power limit: a line alone
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
