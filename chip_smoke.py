#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/csrc`` and runs, in
order: (1) the card's name, power limit and count, and the TF32 switches
(both off); (2) the build; (4, run before (3) so that its first calls are
the process's first) the engine's path through
``Engine(backend="cuda")``: PolyBench gemm and gesummv at MEDIUM size, 256
requests per class of six one-shot kernels at length 4096, a multi-shot
plan and ``fabric_stream`` on relu at n = 4096 and 2^24 (the first call,
then the median and range of 7 warm calls, by the host clock), each
checked against numpy or the port's executor, with the kernels' launch
counts read around it (no fold: every lane there fits one block); (3)
every fabric kernel against its plain PyTorch version, bit-exact, on the
card, at lane lengths on both sides of the lane kernel's units (a warp's
lane of 256 elements, a block's of 4096, past which lanes split into
slices and a fold kernel runs), for the stream kernel also at its tile's
edges, past the card's resident blocks and on streams 4, 8 and 12 bytes
past 16-byte alignment, with 64-slot tables among the DFGs; (5) the
serving loop ``repro_torch.serve`` on
``Engine(backend="cuda")``: (a) a virtual-clock soak of the paper mix at
length 4096 (seed 0, 256 requests at load 2.0 of the calibrated
capacity), every answer bit-exact against the executor and both digests
equal to the same soak on the CPU, and (b) a wall-clock ``Server``
answering 256 requests from one client thread, timed, then profiled for
the device's idle share, each with the launch counts read around it and
no failed request, failed lane grid, plain call or fold allowed; (6) each
fabric kernel's time at that path's shapes beside its plain version's
time and its bound; for ``fabric_stream`` (relu and vadd at n = 2^24
beside ``torch.relu`` and ``torch.add``, ``fft_butterfly`` at 2^22, a
copy DFG at 2^24 beside ``clone``) both
over one input set and over a rotation of 4 input and output sets that
the card's L2 cannot hold; and
the device time per launch from ``torch.profiler``; (7) one
profiled gemm run: wall time against the time the device was busy; (8) the
dense kernels (``stream_matmul``, ``stream_conv2d``, ``flash_attention``)
against their plain versions at the reference tests' shapes and ragged
ones (for the float32 SGEMM: K around its 16-deep k tile, M and N around
its 128 x 128 tile, A or B one float past 16-byte alignment), the
bfloat16 product at the edges of its ``wgmma`` route (K = 8,
K = 72, ragged M and N, N = 8) and on a misaligned A, which must take the
``mma_sync`` route, with the route counters read around each call, and
attention at the edges of its 128-query tile; (9) the dense path through
``repro_torch.kernels.ops`` at realistic widths (minicpm-2b's gate/up
projection over 4,096 tokens in float32 and bfloat16, its causal
attention at 4k context, a 16-megapixel frame), with the launch counts
and the matmul's route counters read around it (the bfloat16 product goes
through ``wgmma`` once, ``mma_sync`` never) and each result then held
against its plain version; (10) the dense kernels' times beside their plain
versions', their bounds and one PyTorch library call each, the bfloat16
product's ``wgmma`` and ``mma_sync`` routes timed in turns on the same
inputs, and its bf16-out time beside ``torch.matmul``'s, each of those two
results then held against the plain version; (11, run after (5)) the
traced frontend: torch functions (the one-shot mix at length 4096, a
two-way ``torch.cond``, the demo's epilogue also at 2^22 elements, a graph
larger than the fabric) traced on this machine's torch and run through
``@offload(backend="cuda")`` with the launch counts read around them,
every output bit-exact against ``backend="sim"`` and the eager function,
the multi-shot tally equal to sim's, the torch loop kernels refused with
a ``CapabilityError`` naming their feature, then each kernel's trace+key,
cold compile and warm call times and the device's idle share over 20 warm
calls; (12, after (11)) the model-layer mix of ``repro_torch.workloads``
served on ``Engine(backend="cuda")``: (a) a virtual-clock soak at length
4096 (seed 0, 256 requests at load 2.0 of the calibrated model-mix
capacity, the registry's arrival weights), the SSM classes dropped by
name, every answer bit-exact against its class's oracle and the executor,
at least one preemption, both digests equal to the same soak on the CPU,
and (b) a warm wall-clock ``Server`` answering 256 model requests, timed,
then profiled for the device's idle share; (13) ``repro_torch.fleet``:
three ``"cuda"`` fabrics over the 11 classes ``"cuda"`` serves (256
requests at length 4096, ``f1`` scripted to die 40% through the
arrivals), with no failed request, a drain, every request accounted for,
both digests equal to the same fleet on the CPU and the results digest
equal to one engine serving the same stream request by request; its wall
time, launches and the device's idle share. Phases 5, 11, 12 and 13 set
the counts to 0 before their runs and read them after, and allow no
plain call, fold or failed lane grid there. It exits non-zero,
printing no result line, when there is no CUDA device, when the port is
missing, or when any phase fails. The last line is
``{"ok": true, "device": {...}}``.

It imports neither ``jax`` nor the JAX package.
"""
from __future__ import annotations

import dataclasses
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
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bfloat16 tensor cores
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


def reset_fabric_counts():
    from repro_torch.kernels import fabric_reduce as fr
    from repro_torch.kernels import fabric_stream as fs
    fr.launches = fr.plain_calls = fr.fold_launches = 0
    fs.launches = fs.plain_calls = 0


def fabric_counts():
    from repro_torch.kernels import fabric_reduce as fr
    from repro_torch.kernels import fabric_stream as fs
    return {"lane_kernel": fr.launches - fr.fold_launches,
            "fold_kernel": fr.fold_launches, "stream_kernel": fs.launches,
            "plain": fr.plain_calls + fs.plain_calls}


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


def wide_dfg(merge):
    """A table of 64 wire slots, the most the kernels hold: x, y and a chain
    of ALU ops; where ``merge``, the chain ends in a Branch/Merge on x > 0
    (tracked validity bits, so the stream kernel runs it with one stage)."""
    from repro_torch.core.dfg import DFG
    from repro_torch.core.isa import AluOp, CmpOp
    b = DFG.build("wide_merge" if merge else "wide")
    x, y = b.inp("x"), b.inp("y")
    w = x
    ops = (AluOp.ADD, AluOp.XOR, AluOp.MUL, AluOp.SUB)
    for i in range(56 if merge else 62):
        w = b.alu(f"w{i}", ops[i % 4], w, y if i % 3 else None,
                  const_b=None if i % 3 else 2 * i + 1)
    if merge:
        c = b.cmp("c", CmpOp.GTZ, x)
        bw = b.branch("bw", w, c)
        t = b.alu("t", AluOp.MUL, bw, const_b=3, a_port="t")
        f = b.alu("f", AluOp.SHR, bw, const_b=2, a_port="f")
        w = b.merge("m", t, f)
    b.out("out", w)
    return b.done()


def stream_edges(g):
    """Stream lengths at the edges of the stream kernel's tile for g's
    table: one short of a tile, a tile, one past, and more tiles than the
    card can hold blocks at once (an SM holds at most 2048 threads) plus 3,
    ragged."""
    import torch
    from repro_torch.kernels import fabric_stream as fs
    _, tile = fs.stream_geometry(fs.lower(g).n_slots)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (tile - 1, tile, tile + 1,
            (sms * (2048 // fs.THREADS) + 3) * tile + 1)


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
    launches, x = fs.launches, ins[g.inputs[0]]
    k = fs.stream_kernel(g, ins)
    check(fs.launches == launches + (x.is_cuda and x.numel() > 0),
          f"fabric_stream {g.name}: launch not counted")
    p = fs.stream_plain(g, ins)
    for o in p:
        e = max_err(k[o], p[o])
        errs["fabric_stream"] = max(errs["fabric_stream"], e)
        check(e == 0 and k[o].shape == p[o].shape,
              f"fabric_stream {g.name} output {o}: kernel != plain "
              f"(max err {e})")


def phase_parity(device, lanes=(1, 3, 512),
                 lengths=(0, 1, 127, 255, 256, 257, 1024, 3000, 4096, 4097,
                          9000)):
    import numpy as np
    import torch
    from repro_torch.core.isa import AluOp
    rng = np.random.default_rng(SEED)
    errs = {"fabric_reduce_lanes": 0, "fabric_stream": 0}
    graphs = [mk(16) for mk in parity_kernels().values()]
    graphs += [branch_merge_dfg(), wide_dfg(False), wide_dfg(True)]
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
        if not streamable:
            continue
        # the stream kernel's tile edges, and streams 4, 8 and 12 bytes
        # past 16-byte alignment (every stream, or only the first)
        edges = stream_edges(g)
        for length in edges:
            ins = {k: torch.from_numpy(full_range(rng, (length,)))
                   .to(device) for k in g.inputs}
            compare_stream(g, ins, errs)
            n_cmp += 1
        for off in (1, 2, 3):
            for length in (edges[2], 3000):
                for first_only in (False, True):
                    ins = {k: torch.from_numpy(full_range(
                        rng, (length + off,))).to(device)[
                            off if i == 0 or not first_only else 0:][:length]
                           for i, k in enumerate(g.inputs)}
                    check(ins[g.inputs[0]].data_ptr() % 16 == 4 * off,
                          "an unaligned slice came out aligned")
                    compare_stream(g, ins, errs)
                    n_cmp += 1
    torch.cuda.synchronize() if device.type == "cuda" else None
    print(f"[parity] {len(graphs)} DFGs, {n_cmp} kernel-vs-plain "
          f"comparisons, lanes {list(lanes)}, lengths {list(lengths)}; "
          f"streams also at their tile's edges (relu: "
          f"{list(stream_edges(graphs[1]))}) and at 4, 8 and 12 bytes past "
          f"16-byte alignment: bit-exact (max abs err {errs})")
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
    reset_fabric_counts()
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

    # fabric_stream on relu: the process's first call at each n (a fresh
    # DFG: lowering, table upload, the output's first allocation and, at
    # the first n, the kernel's first launch under CUDA's lazy loading),
    # then warm calls of one DFG, then one call of another fresh DFG (its
    # lowering and upload, nothing else new); each timed to its synchronise
    def segments():
        return torch.cuda.memory_stats(device).get(
            "segment.all.allocated", 0) if device.type == "cuda" else 0

    def timed(g, xs, want):
        # checked on the device, so that the card is not left idle for a
        # host-side comparison between timed calls
        t0 = time.perf_counter()
        out = fs.fabric_stream(g, {"x": xs})["out"]
        sync()
        dt = (time.perf_counter() - t0) * 1e3
        check(torch.equal(out, want),
              f"fabric_stream relu n={xs.numel()} != max(x, 0)")
        return dt

    for n in stream_sizes:
        xs = torch.from_numpy(full_range(rng, n)).to(device)
        want = torch.from_numpy(np.maximum(xs.cpu().numpy(), 0)).to(device)
        sync()
        before = (fs.lowerings, fs.table_uploads, segments())
        g = K.relu()
        first = timed(g, xs, want)
        news = [a - b for a, b in zip((fs.lowerings, fs.table_uploads,
                                       segments()), before)]
        warm = [timed(g, xs, want) for _ in range(7)]
        fresh = timed(K.relu(), xs, want)
        print(f"[main] fabric_stream relu n={n}: first call {first:.3f} ms "
              f"wall (+{news[0]} lowering, +{news[1]} table upload, "
              f"+{news[2]} device segments); warm median "
              f"{float(np.median(warm)):.4f} ms, range {min(warm):.4f}-"
              f"{max(warm):.4f} ms over {len(warm)} calls; a fresh DFG's "
              f"call {fresh:.3f} ms")

    launches = {"fabric_reduce_lanes": fr.launches,
                "fabric_stream": fs.launches}
    plain = {"fabric_reduce_lanes": fr.plain_calls,
             "fabric_stream": fs.plain_calls}
    for e in engines:
        check(e.stats.lane_batch_failures == 0,
              f"lane grid failures: {e.stats}")
    check(sum(e.stats.lane_batches for e in engines) > 0,
          "no lane grid ran")
    folds = fr.fold_launches
    if device.type == "cuda":
        check(all(v > 0 for v in launches.values()),
              f"a kernel was never launched on the main path: {launches}")
        check(all(v == 0 for v in plain.values()),
              f"a plain version ran on the main path: {plain}")
        check(folds == 0, f"{folds} fold launches on the main path, whose "
                          f"lanes all fit one block")
    print(f"[main] kernel launches {launches} (fabric_reduce_lanes: "
          f"{launches['fabric_reduce_lanes'] - folds} lane grids + {folds} "
          f"folds), plain calls {plain}, "
          f"{time.perf_counter() - t_all:.3f} s total")
    return launches


# ---------------------------------------------------------------------------
# phase 5: the serving loop, repro_torch.serve on Engine(backend="cuda")
# ---------------------------------------------------------------------------

SERVE_LENGTH = 4096     # the one-shot mix's stream length (phase 4)
SERVE_REQUESTS = 256
SERVE_LOAD = 2.0        # offered load, in units of the calibrated capacity


def check_served(tickets, label):
    """Every served result bit-exact against the port's executor."""
    import numpy as np
    from repro_torch.core.executor import execute
    for tk in tickets:
        want = execute(tk.artifact.dfg, tk.inputs)
        check(set(want) == set(tk.outputs),
              f"{label}: request {tk.rid} ({tk.cls}) outputs "
              f"{sorted(tk.outputs)} != executor's {sorted(want)}")
        for o in want:
            check(np.array_equal(tk.outputs[o], want[o]),
                  f"{label}: request {tk.rid} ({tk.cls}) output {o} != "
                  f"executor")


def check_serve_path(counts, stats, report, label):
    check(report["failed"] == 0, f"{label}: {report['failed']} failed")
    check(report["offered"] == report["served"] + report["rejected"] +
          report["failed"], f"{label}: requests lost: {report}")
    check(stats.lane_batch_failures == 0,
          f"{label}: a lane grid failed and fell back: {stats}")
    check(counts["plain"] == 0,
          f"{label}: a plain version ran on the card's path: {counts}")
    check(counts["lane_kernel"] > 0, f"{label}: no lane kernel: {counts}")
    check(counts["fold_kernel"] == 0,
          f"{label}: folds on lanes of {SERVE_LENGTH}: {counts}")


def serve_session(eng, classes, reqs, cfg, poll_s=0.002):
    """One client thread submits ``reqs`` to a ``Server`` (wall clock) as
    fast as it can; returns the server, its tickets and the wall seconds
    from the first submission to the last answer. ``poll_s`` is the
    server's wait on an empty ingress queue (its default)."""
    import threading
    from repro_torch.serve import Server
    tickets = []
    srv = Server(eng, cfg, poll_s=poll_s)
    try:
        def client():
            for _, label, ins in reqs:
                tickets.append(srv.submit(classes[label], ins))

        t0 = time.perf_counter()
        th = threading.Thread(target=client, name="serve-client")
        th.start()
        th.join(120)
        check(not th.is_alive(), "serve client did not finish submitting")
        for tk in tickets:
            tk.result(timeout=300)
        wall = time.perf_counter() - t0
    finally:
        srv.stop(timeout=300)
    return srv, tickets, wall


def phase_serve(device, length=SERVE_LENGTH, n=SERVE_REQUESTS,
                load=SERVE_LOAD):
    """(a) a virtual-clock soak of the paper mix on the card, held to the
    executor and to the same soak on the CPU; (b) a wall-clock ``Server``
    answering one client's requests, timed, then profiled."""
    import numpy as np
    import torch
    from repro_torch import bench_serve
    from repro_torch.serve import (ServeConfig, make_labeled_requests,
                                   request_inputs, serve_classes)
    print(f"[serve] card: {nvidia_smi()}")

    # (a) the soak: seed 0, load 2.0 of the cuda capacity, calibrated as
    # benchmarks/bench_serve.py calibrates
    mean_us = bench_serve.calibrate("cuda", length, device=device)
    kw = dict(seed=SEED, n_requests=n, length=length, backend="cuda",
              rate_per_us=load / mean_us)
    t0 = time.perf_counter()
    skipped = {}
    serve_classes(bench_serve.fresh_engine("cuda", device), length,
                  skipped=skipped)
    t_compile = time.perf_counter() - t0
    reset_fabric_counts()
    t0 = time.perf_counter()
    serve, rep = bench_serve.soak(device=device, **kw)
    torch.cuda.synchronize()
    t_soak = time.perf_counter() - t0
    counts = fabric_counts()
    st = serve.engine.stats
    check_serve_path(counts, st, rep, "serve soak")
    check(serve.engine.device == device, f"soak engine on "
                                         f"{serve.engine.device}")
    check_served(serve.served, "serve soak")
    _, cpu = bench_serve.soak(device="cpu", **kw)
    for k in ("served", "rejected", "failed", "preemptions",
              "trace_digest", "results_digest"):
        check(rep[k] == cpu[k], f"serve soak {k}: card {rep[k]} != cpu "
                                f"{cpu[k]}")
    lat = rep["latency"]
    print(f"[serve] (a) virtual-clock soak, paper mix at length {length}, "
          f"seed {SEED}, {n} requests at load {load} of the cuda capacity "
          f"({mean_us:.4f} us a request, {kw['rate_per_us']:.6f} "
          f"requests/us); skipped {skipped}: served {rep['served']}, "
          f"rejected {rep['rejected']}, failed {rep['failed']}, "
          f"preemptions {rep['preemptions']}, batches {rep['batches']} "
          f"{rep['close_reasons']}; virtual p50 {lat['p50_us']:.2f} us, "
          f"p99 {lat['p99_us']:.2f} us; engine {st.requests} requests, "
          f"{st.lane_batches} lane grids ({st.lane_requests} lanes), "
          f"lane_batch_failures {st.lane_batch_failures}; kernels "
          f"{counts}; host wall {t_soak:.3f} s (place & route of the "
          f"classes about {t_compile:.3f} s of it); bit-exact against the "
          f"executor; trace {rep['trace_digest'][:16]} results "
          f"{rep['results_digest'][:16]} == the cpu run's")

    # (b) the wall-clock Server: one client, n requests back to back; the
    # queue holds them all, so every request is answered. An always-on
    # server is warm: one request per class first, on the same engine,
    # records each class's timing trace (the cycle simulation of a shot,
    # run once per config class and length)
    eng = bench_serve.fresh_engine("cuda", device)
    classes = serve_classes(eng, length)
    rng = np.random.default_rng(SEED + 7)
    cfg = ServeConfig(queue_capacity=n)
    first = [(0.0, label, request_inputs(classes[label], length, rng,
                                         label=label))
             for label in sorted(classes)]
    _, first_tickets, first_wall = serve_session(eng, classes, first, cfg)
    check_served(first_tickets, "first server session")
    reqs = make_labeled_requests(classes, np.zeros(n), length, rng)
    before = dataclasses.replace(eng.stats)
    reset_fabric_counts()
    srv, tickets, wall = serve_session(eng, classes, reqs, cfg)
    torch.cuda.synchronize()
    server_counts = fabric_counts()
    wrep = srv.core.report()
    check(wrep["served"] == n and wrep["rejected"] == 0,
          f"server answered {wrep['served']} of {n}: {wrep}")
    check_serve_path(server_counts, eng.stats, wrep, "server")
    check(eng.device == device, f"server engine on {eng.device}")
    check_served(tickets, "server")
    wlat = wrep["latency"]
    units = wrep["batches"] + sum(ev[0] == "resume" for ev in srv.core.trace)
    grids = eng.stats.lane_batches - before.lane_batches
    print(f"[serve] (b) Server under WallClock, one client thread, on a "
          f"warm engine (its first session, one request per class: "
          f"{first_wall:.4f} s): {n} paper-mix requests at length "
          f"{length}, {n} answered, bit-exact against the executor; wall "
          f"{wall:.4f} s, {n / wall:.1f} requests/s; wall latency p50 "
          f"{wlat['p50_us']:.1f} us, p99 {wlat['p99_us']:.1f} us; batches "
          f"{wrep['batches']} {wrep['close_reasons']}, preemptions "
          f"{wrep['preemptions']}, {units} dispatch units (batches and "
          f"resumes), {wall / units * 1e3:.3f} ms of wall a unit; {grids} "
          f"lane grids ({eng.stats.lane_requests - before.lane_requests} "
          f"lanes) in {eng.stats.flushes - before.flushes} flushes; "
          f"kernels {server_counts}")

    # the worker waits up to poll_s on an empty ingress queue before each
    # dispatch, work queued or not: the same session at a 20x shorter wait
    _, short_tickets, short_wall = serve_session(eng, classes, reqs, cfg,
                                                 poll_s=1e-4)
    check_served(short_tickets, "server, short poll")
    print(f"[serve] (b) the same session with the server's ingress wait "
          f"(poll_s) at 0.1 ms instead of 2 ms: wall {short_wall:.4f} s, "
          f"{n / short_wall:.1f} requests/s")

    # the same session once more under the profiler: the device's share
    out = []
    prof = profile_run(lambda: out.append(
        serve_session(eng, classes, reqs, cfg)))
    check(out[0][0].core.report()["served"] == n, "profiled server run")
    check_served(out[0][1], "profiled server")
    if prof["by_name"]:
        check(any("lane_kernel" in k for k in prof["by_name"]),
              f"the profiler saw no lane kernel: {list(prof['by_name'])}")
        top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:5]
        print(f"[serve] (b) profiled Server session: wall "
              f"{prof['wall_s']:.4f} s, device busy "
              f"{prof['busy_s'] * 1e3:.4f} ms, device idle share "
              f"{1 - prof['busy_s'] / prof['wall_s']:.5f}; device ms by "
              f"name {({k: round(v / 1e3, 4) for k, v in top})}")
    else:
        print("[serve] (b) device idle share not measured (the profiler "
              "recorded no device activity)")
    print(f"[serve] card: {nvidia_smi()}")
    return {"soak": counts, "server": server_counts}


# ---------------------------------------------------------------------------
# phase 6: times at the main path's shapes
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


def phase_times(device, gemm=(200, 220, 240), per_class=256, length=4096):
    import numpy as np
    import torch
    from repro_torch import bench_kernels
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
    # fabric_stream: over one input set (the loop kept from earlier
    # slices, whose data the card's 50 MB L2 partly holds from launch to
    # launch) and over a rotation of input and output sets too large for it
    stream_loops = {}
    for name, g, n, library in bench_kernels.stream_cases():
        sets = [{k: torch.from_numpy(full_range(rng, n)).to(device)
                 for k in g.inputs} for _ in range(bench_kernels.ROTATE)]
        k, p = fs.stream_kernel(g, sets[0]), fs.stream_plain(g, sets[0])
        err = max(max_err(k[o], p[o]) for o in p)
        check(err == 0, f"fabric_stream {name}: kernel != plain at n={n}")
        if library is not None:
            check(torch.equal(library(sets[0]), k[g.outputs[0]]),
                  f"fabric_stream {name}: library call != kernel")
        plain_ms = time_ms(lambda: fs.stream_plain(g, sets[0]), reps=5)
        b_ms, b_by = bound(4 * n * len(g.inputs), 4 * n * len(p),
                           n * elementwise_ops(g))
        kernel = lambda x, g=g: fs.stream_kernel(g, x)     # noqa: E731
        loops = {"one set": lambda fn, x=sets[0]: lambda: fn(x),
                 f"{len(sets)} sets rotated":
                     lambda fn, sets=sets: bench_kernels.rotation(fn, sets)}
        for loop, wrap in loops.items():
            label = f"fabric_stream {name} n={n}, {loop}"
            fns = (wrap(kernel), wrap(library) if library else None)
            # two rounds first: every output buffer allocated before timing
            warm = 2 * len(sets)
            rows[label] = dict(
                ms=time_ms(fns[0], warm=warm), plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                library_ms=time_ms(fns[1], warm=warm) if library else None)
            stream_loops[label] = fns
        del k, p
    for label, r in rows.items():
        lib = r.get("library_ms")
        print(f"[times] {label}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), share of bound "
              f"{r['bound_ms'] / r['ms']:.3f}, library_ms: "
              + (f"{lib:.4f} (kernel / library {r['ms'] / lib:.3f})"
                 if lib else "none"))

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
    for label, (kernel, library) in stream_loops.items():
        grids[label] = kernel
        if library is not None:
            grids[f"{label}: library call"] = library
    for label, fn in grids.items():
        fn()
        prof = profile_run(lambda: [fn() for _ in range(reps)])
        print(f"[profile] {label}: device ms per launch (launches recorded "
              f"of {reps}) {per_launch(prof) or 'not measured'}")
    return rows


def profile_run(fn):
    """Run ``fn`` under ``torch.profiler``; return the wall time, the time
    the device was busy (union of kernel and copy intervals), the device
    time per kernel name and the launches recorded per name (in a long
    process the profiler may record fewer launches than were made, so a
    time per launch divides by this count, never by the calls made)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name, count = [], {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].strip()
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
            count[name] = count.get(name, 0) + 1
    busy, end = 0.0, None
    for s, t in sorted(spans):
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return {"wall_s": wall, "busy_s": busy / 1e6, "by_name": by_name,
            "count": count}


def per_launch(prof):
    """Device ms per launch by kernel name, and the launches recorded."""
    return {n: (round(us / prof["count"][n] / 1e3, 5), prof["count"][n])
            for n, us in prof["by_name"].items()}


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


# ---------------------------------------------------------------------------
# phase 8: the dense kernels against their plain versions
# ---------------------------------------------------------------------------

def normal(rng, shape, device, dtype=None):
    import torch
    x = torch.from_numpy(rng.standard_normal(shape, dtype="float32"))
    x = x.to(device)
    return x if dtype is None else x.to(dtype)


def close(got, want, atol, rtol, label):
    """max |got - want|, failing unless |got - want| <= atol + rtol |want|
    everywhere (the reference tests' allclose)."""
    import torch
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    ok = bool(torch.isfinite(g).all()) and bool(
        ((g - w).abs() <= atol + rtol * w.abs()).all())
    check(ok and got.shape == want.shape,
          f"{label}: kernel != plain (max abs err {err}, atol {atol}, "
          f"rtol {rtol})")
    return err


def phase_dense_parity(device):
    """Each dense kernel against its plain version at the reference tests'
    shapes and ragged ones, with the tests' tolerances (atol = rtol)."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import stream_conv2d as sc
    from repro_torch.kernels import stream_matmul as sm
    rng = np.random.default_rng(SEED + 5)
    f32, bf16 = torch.float32, torch.bfloat16
    by_limit = {}                  # (kernel, limit) -> max abs err

    def note(kernel, limit, err):
        key = (kernel, limit)
        by_limit[key] = max(by_limit.get(key, 0.0), err)

    routes = ("sgemm", "mma_sync", "wgmma")

    def route_counts():
        return {r: getattr(sm, f"{r}_launches") for r in routes}

    def matmul_case(a, b, out, dt, label):
        tol, limit = ((2 ** -7, "bf16 out: 2^-7, one ulp") if out == bf16
                      else (1e-4, "f32 in: 1e-4") if dt == f32
                      else (5e-2, "bf16 in: 5e-2"))
        r, before = sm.route(a, b), route_counts()
        got = sm.matmul_kernel(a, b, out)
        moved = {k: v - before[k] for k, v in route_counts().items()}
        check(moved == {x: int(x == r) for x in routes},
              f"{label}: route {r} expected, counters moved {moved}")
        kname = "stream_matmul" if dt == f32 else "stream_matmul bf16"
        note(kname, limit, close(got, sm.matmul_plain(a, b, out), tol, tol,
                                 f"{label} ({r})"))
        return r

    taken = {}
    for (m, k, n), dt, out in (
            ((70, 90, 50), f32, f32), ((1, 1, 1), f32, f32),
            ((300, 300, 300), f32, f32), ((70, 90, 50), bf16, f32),
            ((1, 1, 1), bf16, f32), ((300, 300, 300), bf16, f32),
            ((129, 67, 131), f32, bf16), ((136, 64, 200), bf16, bf16),
            # the wgmma route's edges: K = 8, K not a multiple of 64, M
            # and N not multiples of the 128 x 256 tile, N = 8
            ((130, 8, 40), bf16, f32), ((100, 72, 96), bf16, f32),
            ((200, 136, 264), bf16, f32), ((200, 136, 264), bf16, bf16),
            ((300, 72, 8), bf16, f32), ((64, 64, 8), bf16, bf16),
            # the SGEMM's edges: K below, at and past its 16-deep k tile and
            # its 4-stage ring, M and N around its 128 x 128 tile
            ((127, 15, 129), f32, f32), ((129, 16, 127), f32, f32),
            ((128, 17, 128), f32, bf16), ((257, 65, 255), f32, f32)):
        a, b = normal(rng, (m, k), device, dt), normal(rng, (k, n), device, dt)
        label = f"stream_matmul {m}x{k}x{n} {dt}->{out}"
        taken[label] = matmul_case(a, b, out, dt, label)
    # float32 A, then B, one float past a 16-byte boundary: B then takes the
    # SGEMM's 4-byte copies
    m, k, n = 200, 64, 136
    for which in ("A", "B"):
        a = normal(rng, (m * k + 1,), device)[1:].view(m, k) if which == "A" \
            else normal(rng, (m, k), device)
        b = normal(rng, (k * n + 1,), device)[1:].view(k, n) if which == "B" \
            else normal(rng, (k, n), device)
        label = f"stream_matmul {m}x{k}x{n} f32, {which} misaligned by 4 bytes"
        taken[label] = matmul_case(a, b, f32, f32, label)
    # a contiguous A one element past a 16-byte boundary: TMA cannot
    # address it, so the rule picks mma_sync
    m, k, n = 100, 64, 128
    a = normal(rng, (m * k + 1,), device, bf16)[1:].view(m, k)
    b = normal(rng, (k, n), device, bf16)
    label = f"stream_matmul {m}x{k}x{n} bf16, A misaligned by 2 bytes"
    taken[label] = matmul_case(a, b, f32, bf16, label)
    check(taken[label] == "mma_sync", f"{label}: took {taken[label]}")
    n_routes = {r: sum(v == r for v in taken.values()) for r in routes}
    print(f"[dense-parity] stream_matmul routes over {len(taken)} shapes: "
          f"{n_routes}")
    exact = True
    for h, w in ((3, 200), (64, 200), (300, 517)):
        img, kern = normal(rng, (h, w), device), normal(rng, (3, 3), device)
        got, want = sc.conv_kernel(img, kern), sc.conv_plain(img, kern)
        note("stream_conv2d", "atol 1e-4, rtol 1e-3",
             close(got, want, 1e-4, 1e-3, f"stream_conv2d {h}x{w}"))
        exact = exact and bool(torch.equal(got, want))
    for h, sq, sk, d, causal, dt in (
            (2, 200, 200, 80, True, f32), (2, 128, 1000, 64, False, f32),
            (2, 1, 4096, 64, True, f32), (2, 200, 200, 16, True, f32),
            (2, 256, 256, 128, True, f32), (3, 150, 70, 16, False, f32),
            (2, 100, 300, 128, True, bf16),
            # the edges of the 128-query tile
            (2, 127, 127, 64, True, f32), (2, 129, 300, 80, False, f32),
            (2, 257, 257, 128, True, f32), (2, 129, 129, 16, True, f32),
            (2, 130, 200, 64, True, bf16)):
        q = normal(rng, (h, sq, d), device, dt)
        k, v = (normal(rng, (h, sk, d), device, dt) for _ in range(2))
        tol, limit = ((3e-5, "f32: 3e-5") if dt == f32
                      else (2 ** -7, "bf16: 2^-7, one ulp"))
        note("flash_attention", limit, close(
            fa.attention_kernel(q, k, v, causal),
            fa.attention_plain(q, k, v, causal), tol, tol,
            f"flash_attention h={h} sq={sq} sk={sk} d={d} causal={causal} "
            f"{dt}"))
    torch.cuda.synchronize()
    errs = {"stream_matmul": 0.0, "stream_matmul bf16": 0.0,
            "stream_conv2d": 0.0, "flash_attention": 0.0}
    for (kernel, limit), err in by_limit.items():
        errs[kernel] = max(errs[kernel], err)
        print(f"[dense-parity] {kernel} ({limit}): max abs err {err}")
    print(f"[dense-parity] {len(by_limit)} groups of kernel-vs-plain "
          f"comparisons, each within its limit (atol = rtol); conv "
          f"bit-exact: {exact}")
    return errs


# ---------------------------------------------------------------------------
# phase 9: the dense path through repro_torch.kernels.ops
# ---------------------------------------------------------------------------

MM = (4096, 2304, 5760)        # minicpm-2b gate/up projection, 4,096 tokens
ATTN_CAUSAL = (36, 4096, 4096, 64)   # minicpm-2b attention at 4k context
ATTN_FULL = (8, 1024, 1024, 64)      # benchmarks/bench_kernels.py:90
CONV_BIG, CONV_SMALL = (4096, 4096), (256, 256)
# path tolerances: float32 matmul at K=2304 against cuBLAS in another order,
# relative to max|C| (TF32 would show about 1e-3); bfloat16 inputs on the
# tensor cores, whose accumulation order and rounding differ again
MM_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-4}


def phase_dense_path(device):
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import stream_conv2d as sc
    from repro_torch.kernels import stream_matmul as sm
    rng = np.random.default_rng(SEED + 6)
    M, K, N = MM
    a = rng.standard_normal((M, K), dtype="float32")
    b = rng.standard_normal((K, N), dtype="float32")
    h, sq, sk, d = ATTN_CAUSAL
    q, k, v = (rng.standard_normal((h, s, d), dtype="float32")
               for s in (sq, sk, sk))
    hn, sqn, skn, dn = ATTN_FULL
    qn, kn, vn = (rng.standard_normal((hn, s, dn), dtype="float32")
                  for s in (sqn, skn, skn))
    img = rng.standard_normal(CONV_BIG, dtype="float32")
    img_s = rng.standard_normal(CONV_SMALL, dtype="float32")
    kern = rng.standard_normal((3, 3), dtype="float32")
    # bfloat16 has no numpy type: the same values, rounded on the card
    a16 = torch.from_numpy(a).to(device).to(torch.bfloat16)
    b16 = torch.from_numpy(b).to(device).to(torch.bfloat16)
    torch.cuda.synchronize()

    mods = {"stream_matmul": sm, "stream_conv2d": sc, "flash_attention": fa}
    for mod in mods.values():
        mod.launches = mod.plain_calls = 0
    sm.sgemm_launches = sm.mma_sync_launches = sm.wgmma_launches = 0
    t0 = time.perf_counter()
    out = {"mm": ops.matmul(a, b), "mm16": ops.matmul(a16, b16),
           "attn": ops.attention(q, k, v, causal=True),
           "attn_full": ops.attention(qn, kn, vn, causal=False),
           "conv": ops.conv2d_3x3(img, kern),
           "conv_s": ops.conv2d_3x3(img_s, kern)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: m.launches for n, m in mods.items()}
    plain = {n: m.plain_calls for n, m in mods.items()}
    routes = {"sgemm": sm.sgemm_launches, "mma_sync": sm.mma_sync_launches,
              "wgmma": sm.wgmma_launches}
    check(all(t.device.type == device.type for t in out.values()),
          f"ops returned a result off {device}")
    check(all(v > 0 for v in launches.values()),
          f"a dense kernel was never launched on its path: {launches}")
    check(all(v == 0 for v in plain.values()),
          f"a plain version ran on the dense path: {plain}")
    check(routes == {"sgemm": 1, "mma_sync": 0, "wgmma": 1},
          f"the f32 product must take sgemm once and the bf16 one wgmma "
          f"once, never mma_sync: {routes}")
    print(f"[dense-path] ops.matmul f32 and bf16 {M}x{K}x{N}, ops.attention "
          f"causal h={h} s={sq} d={d} and full h={hn} s={sqn}, "
          f"ops.conv2d_3x3 {CONV_BIG} and {CONV_SMALL}: {wall:.3f} s wall "
          f"(host-to-device copies included); launches {launches}, "
          f"stream_matmul by route {routes}, plain calls {plain}")

    # now, outside the counted run, each result against its plain version
    ins = {"a": out["mm"].new_tensor(a), "b": out["mm"].new_tensor(b),
           "a16": a16, "b16": b16, "q": out["attn"].new_tensor(q),
           "k": out["attn"].new_tensor(k), "v": out["attn"].new_tensor(v),
           "img": out["conv"].new_tensor(img),
           "kern": out["conv"].new_tensor(kern)}
    errs = {}
    for key, want, rel in (
            ("mm", sm.matmul_plain(ins["a"], ins["b"]), MM_REL_TOL["float32"]),
            ("mm16", sm.matmul_plain(a16, b16), MM_REL_TOL["bfloat16"])):
        scale = float(want.abs().max())
        e = close(out[key], want, rel * scale, 0.0,
                  f"ops.matmul {key} at {M}x{K}x{N} (limit {rel} max|C| = "
                  f"{rel * scale})")
        errs[key] = e
        print(f"[dense-path] {key}: max abs err {e} = {e / scale:.3e} "
              f"max|C| (limit {rel})")
    errs["attn"] = close(out["attn"], fa.attention_plain(
        ins["q"], ins["k"], ins["v"], True), 3e-5, 3e-5, "ops.attention causal")
    errs["attn_full"] = close(out["attn_full"], fa.attention_plain(
        *(out["attn"].new_tensor(x) for x in (qn, kn, vn)), False),
        3e-5, 3e-5, "ops.attention full")
    errs["conv"] = close(out["conv"], sc.conv_plain(ins["img"], ins["kern"]),
                         1e-4, 1e-3, "ops.conv2d_3x3 4096x4096")
    errs["conv_s"] = close(out["conv_s"], sc.conv_plain(
        out["conv"].new_tensor(img_s), ins["kern"]), 1e-4, 1e-3,
        "ops.conv2d_3x3 256x256")
    torch.cuda.synchronize()
    print(f"[dense-path] every result within its tolerance of the plain "
          f"version on the card: max abs err {errs}")
    launches["stream_matmul"] = routes["sgemm"]
    launches["stream_matmul bf16"] = routes["wgmma"]
    kernel_errs = {"stream_matmul": errs["mm"],
                   "stream_matmul bf16": errs["mm16"],
                   "flash_attention": max(errs["attn"], errs["attn_full"]),
                   "stream_conv2d": max(errs["conv"], errs["conv_s"])}
    return launches, kernel_errs, ins


# ---------------------------------------------------------------------------
# phase 10: the dense kernels' times
# ---------------------------------------------------------------------------

def dense_bound(n_bytes, n_flop, flop_per_s):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flop / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_dense_times(ins):
    """Kernel, plain and library times at the first realistic shape of each
    dense kernel, with the bound from this run's shapes: bytes read once
    and written once over 3.35 TB/s, or the multiply-adds (2 flop each) over
    the peak rate of their type."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import stream_conv2d as sc
    from repro_torch.kernels import stream_matmul as sm
    M, K, N = MM
    h, sq, sk, d = ATTN_CAUSAL
    H, W = CONV_BIG
    a, b, a16, b16 = ins["a"], ins["b"], ins["a16"], ins["b16"]
    q, k, v, img, kern = ins["q"], ins["k"], ins["v"], ins["img"], ins["kern"]
    q_off = sk - sq
    pairs = h * sum(min(sk, q_off + i + 1) for i in range(sq))
    cases = {
        "stream_matmul f32": (
            lambda: sm.matmul_kernel(a, b), lambda: sm.matmul_plain(a, b),
            lambda: torch.matmul(a, b),
            dense_bound(4 * (M * K + K * N + M * N), 2 * M * N * K,
                        FP32_FLOP_PER_S)),
        "stream_matmul bf16": (
            lambda: sm.matmul_kernel(a16, b16),
            lambda: sm.matmul_plain(a16, b16),
            lambda: torch.matmul(a16, b16),      # its result is bfloat16
            dense_bound(2 * (M * K + K * N) + 4 * M * N, 2 * M * N * K,
                        BF16_FLOP_PER_S)),
        "flash_attention causal": (
            lambda: fa.attention_kernel(q, k, v, True),
            lambda: fa.attention_plain(q, k, v, True),
            lambda: F.scaled_dot_product_attention(q[None], k[None],
                                                   v[None], is_causal=True),
            dense_bound(4 * h * d * (2 * sq + 2 * sk), 4 * d * pairs,
                        FP32_FLOP_PER_S)),
        "stream_conv2d 4096x4096": (
            lambda: sc.conv_kernel(img, kern), lambda: sc.conv_plain(img, kern),
            lambda: F.conv2d(img[None, None], kern[None, None]),
            dense_bound(4 * (H * W + (H - 2) * (W - 2) + 9),
                        18 * (H - 2) * (W - 2), FP32_FLOP_PER_S)),
    }
    rows = {}
    for label, (kernel, plain, library, (b_ms, b_by)) in cases.items():
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, reps=5, warm=1)
        library_ms = time_ms(library)
        kernel()
        prof = profile_run(lambda: [kernel() for _ in range(5)])
        dev = per_launch(prof)
        rows[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=library_ms)
        print(f"[dense-times] {label}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), share of bound {b_ms / ms:.3f}, "
              f"kernel / library {ms / library_ms:.3f}; profiler device ms "
              f"per launch (launches recorded of 5) "
              f"{dev or 'not measured'}")

    # the two bfloat16 designs on the same inputs, in turns (old, new,
    # new, old), and the wgmma route with a bf16 result beside cuBLAS's
    # bf16-out call, which is like for like
    f32, bf16 = torch.float32, torch.bfloat16
    turns = {"mma_sync": [], "wgmma": []}
    for r in ("mma_sync", "wgmma", "wgmma", "mma_sync"):
        turns[r].append(
            time_ms(lambda: sm._launch_route(a16, b16, f32, r)))
    mma_ms, wg_ms = (sum(turns[r]) / 2 for r in ("mma_sync", "wgmma"))
    # the results of the two timed calls not checked on the path, against
    # the plain version: within 1e-4 of max|C|, and one bf16 ulp more for
    # the bf16 result
    want = sm.matmul_plain(a16, b16)
    tol = MM_REL_TOL["bfloat16"] * float(want.abs().max())
    e_mma = close(sm._launch_route(a16, b16, f32, "mma_sync"), want, tol,
                  0.0, f"stream_matmul bf16 {M}x{K}x{N} (mma_sync)")
    e_out16 = close(sm.matmul_kernel(a16, b16, bf16), want.to(bf16), tol,
                    2 ** -7, f"stream_matmul bf16 -> bf16 {M}x{K}x{N}")
    del want
    print(f"[dense-times] {M}x{K}x{N} against the plain version: mma_sync "
          f"route max abs err {e_mma}, bf16 out (wgmma) {e_out16} (atol "
          f"{MM_REL_TOL['bfloat16']} max|C| = {tol}, rtol 0 and 2^-7)")
    r16 = rows["stream_matmul bf16"]
    print(f"[dense-times] stream_matmul bf16 in, f32 out, {M}x{K}x{N}, "
          f"in turns: wgmma {turns['wgmma']} ms, mma_sync "
          f"{turns['mma_sync']} ms; wgmma / mma_sync {wg_ms / mma_ms:.3f}, "
          f"bound {r16['bound_ms']:.4f} ms, torch.matmul (bf16 out) "
          f"{r16['library_ms']:.4f} ms")
    out16_ms = time_ms(lambda: sm.matmul_kernel(a16, b16, bf16))
    lib16_ms = time_ms(lambda: torch.matmul(a16, b16))
    b16_ms, b16_by = dense_bound(2 * (M * K + K * N + M * N), 2 * M * N * K,
                                 BF16_FLOP_PER_S)
    print(f"[dense-times] stream_matmul bf16 in, bf16 out (wgmma): kernel "
          f"{out16_ms:.4f} ms, torch.matmul {lib16_ms:.4f} ms, bound "
          f"{b16_ms:.4f} ms ({b16_by}), share of bound {b16_ms / out16_ms:.3f}"
          f", kernel / library {out16_ms / lib16_ms:.3f}")
    return rows


# ---------------------------------------------------------------------------
# phase 11: the traced frontend on the card, @offload(backend="cuda")
# ---------------------------------------------------------------------------

FRONTEND_LENGTH = 4096          # the one-shot mix's stream length (phase 4)
FRONTEND_BIG = 1 << 22          # the demo epilogue at 16 MB a stream
EPI_ALPHA, EPI_BETA = 3, 2      # examples/strela_offload.py's alpha, beta


def frontend_forms():
    """name -> (torch function, stream count, hand-built kernels_lib DFG or
    None): the one-shot mix written as plain torch, a two-way
    ``torch.cond``, the demo's epilogue and a graph larger than the
    fabric (a multi-shot plan)."""
    import torch
    from repro_torch.core import kernels_lib as K
    wr, wi = 23170, -23170

    def fft(ar, ai, br, bi):
        tr = br * wr - bi * wi
        ti = br * wi + bi * wr
        return ar + tr, ai + ti, ar - tr, ai - ti

    def cond2(x):
        return torch.cond(x > 0, lambda v: v * 3 - 1, lambda v: v + 7, (x,))

    def epilogue(d, y):
        return torch.relu(EPI_ALPHA * d + EPI_BETA * y)

    def big(x, y):
        t = x
        for i in range(1, 23):           # 66 PEs against the fabric's 16
            t = t * 3 + y + i
        return t

    return {
        "relu_where": (lambda x: torch.where(x > 0, x, 0), 1, K.relu()),
        "relu_clamp": (lambda x: torch.clamp(x, min=0), 1, K.relu()),
        "vadd": (lambda x, y: x + y, 2, K.vadd()),
        "fft": (fft, 4, K.fft_butterfly()),
        "axpby": (lambda x, y: 3 * x + 5 * y, 2, K.axpby(3, 5)),
        "scale_add": (lambda x, y: 4 * x + y, 2, K.scale_add(4)),
        "mac1_sum": (lambda a, b0: (a * b0).sum(), 2,
                     K.mac1(FRONTEND_LENGTH)),
        "mac1_dot": (lambda a, b: torch.dot(a, b), 2,
                     K.mac1(FRONTEND_LENGTH)),
        "cond": (cond2, 1, None),
        "epilogue": (epilogue, 2, None),
        "big": (big, 2, None),
    }


def leaves_of(result):
    import numpy as np
    from torch.utils import _pytree as pytree
    return [np.asarray(v) for v in pytree.tree_leaves(result)]


def phase_frontend(device):
    """Trace torch functions and run them through
    ``@offload(backend="cuda")``: each output bit-exact against
    ``backend="sim"`` and the eager function, signatures equal to the
    hand-built DFGs, the multi-shot tally equal to sim's, the lane kernel
    launched and the plain version never; the loop kernels refused by
    name. Then each kernel's trace+key, cold compile and warm call times,
    and the device's idle share over 20 warm calls."""
    import numpy as np
    import torch
    from repro_torch.core import kernels_lib as K
    from repro_torch.core.executor import execute
    from repro_torch.engine import ArtifactCache, CapabilityError
    from repro_torch.engine.compiler import fn_cache_key, geometry_of
    from repro_torch.frontend import offload
    from repro_torch.frontend.tracer import arg_names_of
    from repro_torch.kernels import fabric_reduce as fr
    from repro_torch.kernels.fabric_stream import lower

    L = FRONTEND_LENGTH
    forms = frontend_forms()
    rng = np.random.default_rng(SEED + 9)
    cases = [(name, L) for name in forms] + [("epilogue", FRONTEND_BIG)]
    ins = {(name, n): [rng.integers(-1000, 1000, n).astype(np.int32)
                       for _ in range(forms[name][1])] for name, n in cases}

    # trace + key and a cold compile (a fresh artifact cache), host clock
    kernels, host = {}, {}
    for name, n in cases:
        fn, _, hand = forms[name]
        k = offload(fn, backend="cuda", device=device, name=name,
                    cache=ArtifactCache(memory_only=True))
        args = arg_names_of(fn, name)
        t0 = time.perf_counter()
        fn_cache_key(fn, n, "auto", "cuda", geometry_of(k.fabric), args)
        t_key = time.perf_counter() - t0
        t0 = time.perf_counter()
        ck = k.compile(n)
        t_compile = time.perf_counter() - t0
        kernels[(name, n)] = (k, ck)
        host[(name, n)] = {"trace_key_ms": t_key * 1e3,
                           "cold_compile_ms": t_compile * 1e3}
        if hand is not None:
            check(ck.dfg.canonical_signature() == hand.canonical_signature(),
                  f"traced {name}: canonical signature differs from its "
                  f"hand-built kernels_lib DFG {hand.name}")
    shots = {c: kernels[c][1].plan.n_shots for c in cases}
    check(shots[("big", L)] > 1, f"big: expected a multi-shot plan, {shots}")

    # the main path: every count at 0, each kernel once through @offload
    reset_fabric_counts()
    t0 = time.perf_counter()
    outs, infos = {}, {}
    for c in cases:
        outs[c] = kernels[c][0](*ins[c])
        infos[c] = kernels[c][0].last
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fabric_counts()
    check(counts["plain"] == 0,
          f"frontend: a plain version ran on the card's path: {counts}")
    check(counts["lane_kernel"] > 0, f"frontend: no lane kernel: {counts}")
    check(counts["lane_kernel"] + counts["fold_kernel"] ==
          sum(shots.values()),
          f"frontend: one launch a shot expected, {counts}, shots {shots}")
    print(f"[frontend] @offload(backend='cuda') of {len(cases)} traced "
          f"kernels ({', '.join(f'{c[0]}@{c[1]}' for c in cases)}): wall "
          f"{wall:.4f} s; shots {sum(shots.values())}; launches {counts}")

    # gates: the eager function, offload(backend="sim") and, for the
    # multi-shot plan, sim's tally
    for (name, n) in cases:
        k, ck = kernels[(name, n)]
        got = leaves_of(outs[(name, n)])
        want = k.reference(ins[(name, n)], ck)
        check(len(got) == len(want) and all(
            np.array_equal(g.reshape(-1), w.reshape(-1))
            for g, w in zip(got, want)),
            f"{name}@{n}: cuda output differs from the eager torch function")
        ks = offload(forms[name][0], backend="sim", name=name,
                     cache=ArtifactCache(memory_only=True))
        if n == L:
            sim_leaves = leaves_of(ks(*ins[(name, n)]))
            check(all(np.array_equal(g, s) for g, s in zip(got, sim_leaves)),
                  f"{name}@{n}: cuda output differs from backend='sim'")
            if shots[(name, n)] > 1:
                check(vars(infos[(name, n)].tally) == vars(ks.last.tally),
                      f"{name}: tally {infos[(name, n)].tally} != sim's "
                      f"{ks.last.tally}")
                print(f"[frontend] {name}: {shots[(name, n)]} shots, tally "
                      f"equal to sim's: {ks.last.tally}")
        else:
            # the cycle simulation of 2^22 elements would take minutes: the
            # executor (sim's value semantics) on every element, the cycle
            # simulation on the first and last 4096 (elementwise kernel)
            ex = execute(ck.dfg, dict(zip(ck.dfg.inputs, ins[(name, n)])))
            check(np.array_equal(ex["out0"], got[0]),
                  f"{name}@{n}: cuda output differs from the executor")
            for sl in (slice(0, L), slice(n - L, n)):
                s = ks(*[a[sl] for a in ins[(name, n)]])
                check(np.array_equal(np.asarray(s), got[0][sl]),
                      f"{name}@{n}: cuda output differs from sim on {sl}")
    print(f"[frontend] every output bit-exact against the eager torch "
          f"function and backend='sim' (at n={FRONTEND_BIG}: the executor "
          f"on every element, sim on the first and last {L}); signatures "
          f"equal to kernels_lib's for "
          f"{[c for c, f in forms.items() if f[2] is not None]}")

    # the loop kernels are outside the cuda capability set
    before = fabric_counts()
    feature = {"div_iter": "recirculation edge",
               "isqrt": "recirculation edge",
               "clip_scan": "loop-carried back edge",
               "gemv_early": "loop-carried back edge"}
    for lname, (make, n_in) in K.TRACED_LOOPS.items():
        k = offload(make(), backend="cuda", device=device, name=lname,
                    cache=ArtifactCache(memory_only=True))
        try:
            k(*[np.arange(L, dtype=np.int32)] * n_in)
        except CapabilityError as e:
            check(feature[lname] in str(e), f"{lname}: {e}")
            print(f"[frontend] {lname} on cuda: CapabilityError: {e}")
        else:
            raise SmokeFailure(f"{lname} ran on cuda; a CapabilityError "
                               f"naming {feature[lname]!r} was expected")
    check(fabric_counts() == before, "a refused loop kernel launched")

    # a warm call split: the whole call (host clock, ending in the result's
    # copy to the host), its dispatch (the call's "offload" span: the lane
    # kernel's wrapper or the shot runner), the rest before it (trace, key,
    # cache hit), and the lane kernel alone at the call's shapes (CUDA
    # events, inputs already on the card)
    from repro_torch import obs
    for (name, n) in cases:
        k, ck = kernels[(name, n)]
        dispatches, calls = [], []
        for _ in range(5):
            obs.enable(fresh=True)
            t0 = time.perf_counter()
            k(*ins[(name, n)])
            calls.append(time.perf_counter() - t0)
            (sp,) = [s for s in obs.spans() if s.name == "offload"]
            dispatches.append(sp.dur_us / 1e6)
            obs.disable()
        kernel_ms = 0.0
        for shot in ck.plan.shots:
            g = shot.dfg
            dev = {s: torch.from_numpy(rng.integers(
                       -1000, 1000, (1, n)).astype(np.int32)).to(device)
                   for s in lower(g).in_names}
            kernel_ms += time_ms(lambda: fr.reduce_lanes(g, dev))
        call_ms = float(np.median(calls)) * 1e3
        disp_ms = float(np.median(dispatches)) * 1e3
        key_ms = float(np.median(np.subtract(calls, dispatches))) * 1e3
        host[(name, n)]["kernel_ms"] = kernel_ms
        h = host[(name, n)]
        print(f"[frontend] {name}@{n} ({shots[(name, n)]} shot(s), est. "
              f"{infos[(name, n)].cycles} fabric cycles): trace+key "
              f"{h['trace_key_ms']:.3f} ms, cold compile "
              f"{h['cold_compile_ms']:.3f} ms; warm call {call_ms:.4f} ms: "
              f"trace+key+lookup {key_ms:.4f} ms, dispatch {disp_ms:.4f} ms "
              f"(host clock, medians of 5); lane kernel {kernel_ms:.5f} ms "
              f"(events)")
    n_big = FRONTEND_BIG
    b_ms, b_by = bound(2 * 4 * n_big, 4 * n_big, 5 * n_big)
    print(f"[frontend] epilogue@{n_big} lane kernel "
          f"{host[('epilogue', n_big)]['kernel_ms']:.5f} ms against its "
          f"bound {b_ms:.5f} ms ({b_by})")

    # the device's idle share over 20 warm calls of the epilogue at 4096
    k_epi = kernels[("epilogue", L)][0]
    prof = profile_run(lambda: [k_epi(*ins[("epilogue", L)])
                                for _ in range(20)])
    if prof["by_name"]:
        top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:4]
        print(f"[frontend] 20 warm @offload calls of epilogue@{L} under the "
              f"profiler: wall {prof['wall_s']:.4f} s, device busy "
              f"{prof['busy_s'] * 1e3:.4f} ms, device idle share "
              f"{1 - prof['busy_s'] / prof['wall_s']:.5f}; device ms by "
              f"name {({kk: round(v / 1e3, 4) for kk, v in top})}")
    else:
        print("[frontend] device idle share not measured (the profiler "
              "recorded no device activity)")
    print(f"[frontend] card: {nvidia_smi()}")
    return counts


# ---------------------------------------------------------------------------
# phase 12: the model-layer mix, repro_torch.serve on Engine(backend="cuda")
# ---------------------------------------------------------------------------

# the SSM recurrences need loop state on the fabric, which "cuda" lacks
MODEL_SKIPS = {"ssm_scan": "loop-state",
               "ssm_relax": "loop-state+recirculation"}


def check_oracles(tickets, classes, label):
    """Every served model-class answer bit-exact against its oracle."""
    import numpy as np
    from repro_torch.workloads import MODEL_CLASSES
    by_name = {a.name: lb for lb, a in classes.items()}
    for tk in tickets:
        wc = MODEL_CLASSES[by_name[tk.artifact.name]]
        for i, want in enumerate(wc.oracle(**tk.inputs)):
            check(np.array_equal(np.ravel(tk.outputs[f"out{i}"]),
                                 np.ravel(want)),
                  f"{label}: request {tk.rid} ({wc.label}) out{i} != "
                  f"its oracle")


def idle_share_line(prof, what):
    if not prof["by_name"]:
        return (f"{what}: device idle share not measured (the profiler "
                f"recorded no device activity)")
    check(any("lane_kernel" in k for k in prof["by_name"]),
          f"{what}: the profiler saw no lane kernel: {list(prof['by_name'])}")
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:4]
    return (f"{what}: wall {prof['wall_s']:.4f} s, device busy "
            f"{prof['busy_s'] * 1e3:.4f} ms, device idle share "
            f"{1 - prof['busy_s'] / prof['wall_s']:.5f}; device ms by name "
            f"{({k: round(v / 1e3, 4) for k, v in top})}")


def phase_model_serve(device, length=SERVE_LENGTH, n=SERVE_REQUESTS,
                      load=SERVE_LOAD):
    """(a) a virtual-clock soak of the model-layer mix on the card, held to
    the classes' oracles and to the same soak on the CPU; (b) a warm
    wall-clock ``Server`` answering one client's model requests, timed,
    then profiled."""
    import numpy as np
    import torch
    from repro_torch import bench_serve
    from repro_torch.serve import (ServeConfig, make_labeled_requests,
                                   request_inputs, serve_classes)
    from repro_torch.workloads import model_weights
    print(f"[model] card: {nvidia_smi()}")

    # (a) the soak: seed 0, load 2.0 of the cuda model-mix capacity, with
    # the registry's arrival weights
    t0 = time.perf_counter()
    mean_us = bench_serve.calibrate("cuda", length, device=device,
                                    mix="model")
    t_cal = time.perf_counter() - t0
    skipped = {}
    serve_classes(bench_serve.fresh_engine("cuda", device), length,
                  mix="model", skipped=skipped)
    check(skipped == MODEL_SKIPS, f"model mix skipped {skipped}, expected "
                                  f"{MODEL_SKIPS}")
    kw = dict(seed=SEED, n_requests=n, length=length, backend="cuda",
              rate_per_us=load / mean_us, mix="model")
    reset_fabric_counts()
    t0 = time.perf_counter()
    serve, rep = bench_serve.soak(device=device, **kw)
    torch.cuda.synchronize()
    t_soak = time.perf_counter() - t0
    counts = fabric_counts()
    st = serve.engine.stats
    check_serve_path(counts, st, rep, "model soak")
    check(serve.engine.device == device,
          f"model soak engine on {serve.engine.device}")
    check(rep["oracle_checked"] == rep["served"] > 0 and
          rep["oracle_mismatches"] == 0,
          f"model soak: {rep['oracle_mismatches']} of "
          f"{rep['oracle_checked']} answers differ from their oracles "
          f"({rep['served']} served)")
    check(rep["preemptions"] >= 1, "model soak: no preemption of the "
                                   "multi-shot swiglu_ms plan")
    check_served(serve.served, "model soak")
    _, cpu = bench_serve.soak(device="cpu", **kw)
    for k in ("served", "rejected", "failed", "preemptions",
              "oracle_checked", "trace_digest", "results_digest"):
        check(rep[k] == cpu[k], f"model soak {k}: card {rep[k]} != cpu "
                                f"{cpu[k]}")
    lat = rep["latency"]
    print(f"[model] (a) virtual-clock soak, model mix at length {length}, "
          f"seed {SEED}, {n} requests at load {load} of the cuda capacity "
          f"({mean_us:.4f} us a request, {kw['rate_per_us']:.6f} "
          f"requests/us, calibrated in {t_cal:.3f} s); skipped {skipped}: "
          f"served {rep['served']}, rejected {rep['rejected']}, failed "
          f"{rep['failed']}, preemptions {rep['preemptions']}, batches "
          f"{rep['batches']} {rep['close_reasons']}; virtual p50 "
          f"{lat['p50_us']:.2f} us, p99 {lat['p99_us']:.2f} us; engine "
          f"{st.requests} requests, {st.lane_batches} lane grids "
          f"({st.lane_requests} lanes); kernels {counts}; host wall "
          f"{t_soak:.3f} s; {rep['oracle_checked']} answers bit-exact "
          f"against their oracles and the executor; trace "
          f"{rep['trace_digest'][:16]} results {rep['results_digest'][:16]} "
          f"== the cpu run's")

    # (b) the wall-clock Server on a warm engine: one request per class
    # first records each class's timing trace, then n model requests
    eng = bench_serve.fresh_engine("cuda", device)
    classes = serve_classes(eng, length, mix="model")
    rng = np.random.default_rng(SEED + 12)
    cfg = ServeConfig(queue_capacity=n)
    first = [(0.0, label, request_inputs(classes[label], length, rng,
                                         label=label))
             for label in sorted(classes)]
    _, first_tickets, first_wall = serve_session(eng, classes, first, cfg)
    check_oracles(first_tickets, classes, "first model session")
    reqs = make_labeled_requests(classes, np.zeros(n), length, rng,
                                 weights=model_weights())
    reset_fabric_counts()
    srv, tickets, wall = serve_session(eng, classes, reqs, cfg)
    torch.cuda.synchronize()
    server_counts = fabric_counts()
    wrep = srv.core.report()
    check(wrep["served"] == n and wrep["rejected"] == 0,
          f"model server answered {wrep['served']} of {n}: {wrep}")
    check_serve_path(server_counts, eng.stats, wrep, "model server")
    check_oracles(tickets, classes, "model server")
    wlat = wrep["latency"]
    units = wrep["batches"] + sum(ev[0] == "resume" for ev in srv.core.trace)
    print(f"[model] (b) Server under WallClock, one client thread, on a "
          f"warm engine (first session, one request per class: "
          f"{first_wall:.4f} s): {n} model-mix requests at length {length}, "
          f"{n} answered, bit-exact against their oracles; wall "
          f"{wall:.4f} s, {n / wall:.1f} requests/s; wall latency p50 "
          f"{wlat['p50_us']:.1f} us, p99 {wlat['p99_us']:.1f} us; batches "
          f"{wrep['batches']} {wrep['close_reasons']}, preemptions "
          f"{wrep['preemptions']}, {units} dispatch units (batches and "
          f"resumes), {wall / units * 1e3:.3f} ms of wall a unit; kernels "
          f"{server_counts}")
    out = []
    prof = profile_run(lambda: out.append(
        serve_session(eng, classes, reqs, cfg)))
    check(out[0][0].core.report()["served"] == n, "profiled model server")
    check_oracles(out[0][1], classes, "profiled model server")
    print("[model] (b) " + idle_share_line(prof, "profiled Server session"))
    print(f"[model] card: {nvidia_smi()}")
    return {"soak": counts, "server": server_counts}


# ---------------------------------------------------------------------------
# phase 13: the multi-fabric fleet, repro_torch.fleet on "cuda" fabrics
# ---------------------------------------------------------------------------

# every class a "cuda" fabric serves: the paper mix without div_loop and
# the model mix without the SSM recurrences (a loop class makes an
# all-"cuda" fleet refuse to start, by name)
FLEET_CLASSES = ("relu", "vadd", "fft", "mac1", "axpby_ms", "attn_score",
                 "ln_affine", "moe_gate", "silu_q", "softmax_den",
                 "swiglu_ms")
FLEET_FABRICS = 3
FLEET_LOAD = 1.0        # offered load per fabric, in calibrated capacities
FLEET_FAIL_AT = 0.4     # f1 dies this far through the expected arrivals


def phase_fleet(device, length=SERVE_LENGTH, n=SERVE_REQUESTS):
    """A three-fabric ``"cuda"`` fleet soak on the card with ``f1``
    scripted to die part-way through the arrivals: accounting, the
    executor and the oracles, both digests equal to the same fleet on the
    CPU, and the results digest equal to one engine serving the same
    stream request by request. Then its wall time and idle share."""
    import numpy as np
    import torch
    from repro_torch import bench_serve
    from repro_torch.engine import ArtifactCache
    from repro_torch.fleet import fleet_soak, fleet_workload, homogeneous
    from repro_torch.serve import serve_classes
    from repro_torch.workloads import MODEL_CLASSES, model_weights
    print(f"[fleet] card: {nvidia_smi()}")
    mean_us = bench_serve.calibrate("cuda", length, device=device, mix="all")
    rate = FLEET_FABRICS * FLEET_LOAD / mean_us
    fail_us = round(FLEET_FAIL_AT * n / rate, 3)
    weights = tuple(sorted((l, w) for l, w in model_weights().items()
                           if l in FLEET_CLASSES))
    cfg = homogeneous(FLEET_FABRICS, backend="cuda", length=length,
                      n_requests=n, rate_per_us=rate, classes=FLEET_CLASSES,
                      weights=weights, fail_at=(("f1", fail_us),))

    def soak(dev):
        return fleet_soak(SEED, cfg, cache=ArtifactCache(memory_only=True),
                          device=dev)

    reset_fabric_counts()
    t0 = time.perf_counter()
    fleet, rep = soak(device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fabric_counts()
    check(all(w.engine.device == device for w in fleet.workers),
          f"fleet engines on {[str(w.engine.device) for w in fleet.workers]}")
    check(rep["failed"] == 0, f"fleet: {rep['failed']} failed")
    check(rep["dead"] == ["f1"] and rep["drained"] > 0,
          f"fleet: dead {rep['dead']}, drained {rep['drained']}")
    check(rep["unroutable"] == 0 and rep["offered"] == n ==
          rep["served"] + rep["rejected"] + rep["failed"],
          f"fleet: requests lost: {rep}")
    check(counts["plain"] == 0 and counts["fold_kernel"] == 0,
          f"fleet: a plain version or a fold on the card's path: {counts}")
    check(counts["lane_kernel"] > 0, f"fleet: no lane kernel: {counts}")
    check(all(w.engine.stats.lane_batch_failures == 0
              for w in fleet.workers), "fleet: a lane grid failed")
    served = fleet.served_tickets()
    check_served(served, "fleet")
    model = [tk for tk in served if fleet._rid_label[tk.rid] in MODEL_CLASSES]
    for tk in model:
        wc = MODEL_CLASSES[fleet._rid_label[tk.rid]]
        for i, want in enumerate(wc.oracle(**tk.inputs)):
            check(np.array_equal(np.ravel(tk.outputs[f"out{i}"]),
                                 np.ravel(want)),
                  f"fleet: request {tk.rid} ({wc.label}) out{i} != oracle")
    cpu_fleet, cpu = soak("cpu")
    for k in ("served", "rejected", "drained", "steals", "trace_digest"):
        check(rep[k] == cpu[k], f"fleet {k}: card {rep[k]} != cpu {cpu[k]}")
    digest = fleet.results_digest()
    check(digest == cpu_fleet.results_digest(),
          "fleet results digest: card != cpu")

    # the single-engine oracle: the same fleet_workload stream, one
    # Engine.run a request on one engine on the card, outputs swapped in
    oracle = bench_serve.fresh_engine("cuda", device)
    arts = serve_classes(oracle, length, mix="all")
    stream = fleet_workload(SEED, cfg)
    for tk in served:
        _, label, ins = stream[tk.rid]
        check(label == fleet._rid_label[tk.rid], f"rid {tk.rid}: label")
        tk.outputs = oracle.run(arts[label], ins)
    check(fleet.results_digest() == digest,
          "fleet results digest != the single-engine oracle's")
    lat = rep["latency"]
    busy = {w: round(f["utilization"], 4)
            for w, f in rep["per_fabric"].items()}
    print(f"[fleet] {FLEET_FABRICS} cuda fabrics, {len(FLEET_CLASSES)} "
          f"classes at length {length}, seed {SEED}, {n} requests at "
          f"{rate:.6f} requests/us ({FLEET_LOAD} of the calibrated "
          f"{mean_us:.4f} us a request, per fabric), f1 dies at "
          f"{fail_us} us: served {rep['served']}, rejected "
          f"{rep['rejected']}, failed {rep['failed']}, steals "
          f"{rep['steals']}, drained {rep['drained']}; virtual p50 "
          f"{lat['p50_us']:.2f} us, p99 {lat['p99_us']:.2f} us; modelled "
          f"utilization {busy}; placements {rep['placements']}; kernels "
          f"{counts}; soak wall {wall:.3f} s (cost probes, place & route "
          f"and first-shot cycle simulation included); {len(served)} "
          f"answers bit-exact against the executor ({len(model)} also "
          f"against their oracles); trace {rep['trace_digest'][:16]} and "
          f"results {digest[:16]} == the cpu run's; results == the "
          f"single-engine oracle's")
    prof = profile_run(lambda: soak(device))
    print("[fleet] " + idle_share_line(prof, "profiled fleet soak"))
    print(f"[fleet] card: {nvidia_smi()}")
    return counts


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
    # the plain versions and the library yardsticks in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    print(f"[build] {len(_build.sources())} sources into "
          f"{_build.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s")

    launches = phase_main(device)       # first: its first calls are the
    errs = phase_parity(device)         # process's first
    serve_launches = phase_serve(device)
    for path in serve_launches.values():
        launches["fabric_reduce_lanes"] += path["lane_kernel"]
    launches["fabric_reduce_lanes"] += phase_frontend(device)["lane_kernel"]
    for path in phase_model_serve(device).values():
        launches["fabric_reduce_lanes"] += path["lane_kernel"]
    launches["fabric_reduce_lanes"] += phase_fleet(device)["lane_kernel"]
    rows = phase_times(device)
    phase_profile(device)
    dense_errs = phase_dense_parity(device)
    dense_launches, path_errs, ins = phase_dense_path(device)
    dense_rows = phase_dense_times(ins)

    from repro_torch.bench_kernels import ROTATE
    main_rows = {"fabric_reduce_lanes": (
                     "fabric_reduce_lanes gemm mac3 grid",
                     "src/repro/kernels/fabric_reduce.py:183"),
                 "fabric_stream": (
                     f"fabric_stream relu n={1 << 24}, {ROTATE} sets rotated",
                     "src/repro/kernels/fabric_stream.py:86")}
    kernels = []
    for kname, (label, replaces) in main_rows.items():
        r = rows[label]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/csrc/fabric.cu",
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max(errs[kname], r["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms")})
    dense = {"stream_matmul": ("stream_matmul f32",
                               "src/repro/kernels/stream_matmul.py:68"),
             "stream_matmul bf16": ("stream_matmul bf16",
                                    "src/repro/kernels/stream_matmul.py:68"),
             "stream_conv2d": ("stream_conv2d 4096x4096",
                               "src/repro/kernels/stream_conv2d.py:51"),
             "flash_attention": ("flash_attention causal",
                                 "src/repro/kernels/flash_attention.py:68")}
    for kname, (label, replaces) in dense.items():
        r = dense_rows[label]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{kname.split()[0]}.cu",
            "replaces": replaces, "launches": dense_launches[kname],
            "max_abs_err": max(dense_errs[kname], path_errs[kname]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(nvidia_smi())                  # name, power limit: a line alone
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
