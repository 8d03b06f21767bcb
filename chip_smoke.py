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
time, launches and the device's idle share; (14) the LM serving path,
``repro_torch.launch.serve_lm`` on minicpm-2b: (a) the flash kernel
against its plain version at the model's attention shapes (144 heads of
64, one query against 1, 17 and 49 keys, and sq = sk = 1024), (b) the
model at full width cut to 2 layers, its prefill and decode logits on the
card within the reference's decode tolerance of the same parameters on
the CPU, (c) the full 40-layer model serving batch 4 x (32 + 16) tokens
through ``serve_lm.main``, with exactly one flash launch per layer and
step and no plain call, its tokens in the vocabulary and its logits
finite, timed, and (d) the device's idle share over 8 profiled decode
steps and the flash kernel's time at the decode shape and at 1024 beside
its plain version, its bound and SDPA; (15) the MoE and vlm LM paths
(``repro_torch.models.moe``): (a) the MoE layer at granite-moe-3b-a800m's
widths (D 1536, F 512, 40 experts top-8, bf16) on the card against the
CPU at 4 and 128 tokens (C = 1 and 32): the same routing, outputs within
the decode tolerance, two card runs bit-identical, no host sync under
sync-debug "error", the share of routed pairs dropped; (b) granite at full
width cut to 2 layers, decode steps on the card against the CPU from the
same parameters, each batch row compared up to its first routing flip
(read with ``route`` by a forward pre-hook), a flip accepted only where
the CPU's top-k margin is under 1e-4; (c) the full 32-layer granite
through ``serve_lm.main`` with exactly one flash launch per layer and
step and no plain call; (d) 8 profiled decode steps: idle share, kernel
launches a layer split into its attention and MoE parts, the top device
operations, and the host syncs of one step under sync-debug "warn";
(e) internvl2-76b (``api.prefill`` of 256 patches + 32 tokens, flash at
d = 128, sq = sk = 288) and llama4-scout-17b-a16e (4 decode steps) at
full width cut to 2 layers; and the flash kernel at granite's decode
shape and internvl2's prefill shape against its plain version, timed
beside it, its bound and SDPA; (16) the Mamba-2 SSD layer and the Zamba-2
hybrid (``repro_torch.models.ssm``, ``hybrid``): (a) the SSD layer at
mamba2-1.3b's and zamba2-2.7b's widths in float32 and bf16, chunked at
S = 256 and 512 and 4 decode steps from the carried state, on the card
against the CPU within the LM tolerance, two card runs bit-identical, no
host sync under sync-debug "error"; (b) both models at full width cut to
2 and 6 layers (one shared-block site) through ``serve_lm.generate``
and (e) their ``api.prefill`` at S = 256 (the chunked form on the card),
the same weights in float32 and bf16: float32 on the card against the
CPU within the LM tolerance (each row up to its first greedy flip, a
flip accepted only within twice the tolerance of the CPU's top logit),
and bf16, whose rounding differs between the card's and the CPU's GEMMs
and adds up over layers, no farther from the float32 CPU run than twice
the CPU's own bf16 run;
(c) the full 48-layer mamba2-1.3b (no flash launch) and 54-layer
zamba2-2.7b (exactly 9 sites x 48 steps = 432 flash launches, no plain
call) through ``serve_lm.main``, timed; (d) 8 profiled decode steps of
each: idle share, launches a step split by ranges into SSD layers and
shared-block calls, no host sync; (f) the flash kernel at zamba2's
decode shape (128 heads, sq = 1, sk = 49, d = 80) against its plain
version, timed beside it, its bound and SDPA; (17) the Whisper
encoder-decoder (``repro_torch.models.encdec``): (a) whisper-base reduced,
the same weights in float32 and bf16, its encoder, decoder, loss,
``api.prefill`` and decode steps on the card against the CPU (float32
within the LM tolerance, bf16 no farther from the float32 CPU run than
twice the CPU's own bf16 run); (b) the flash kernel at whisper-base's
shapes at batch 4 (32 heads of 64: the encoder non-causal at sq = sk =
1500, cross-attention of 1 and 32 queries against 1500 frames, a decode
step's causal self-attention over 49 keys) against its plain version;
(c) the full model through ``serve_lm.main`` at batch 4 x (32 + 16),
with exactly 6 + 48 x 12 = 582 flash launches (the encoder once a layer,
then self- and cross-attention once a layer and step) and no plain call,
timed, the encoder inside the prefill; (d) 8 profiled decode steps: idle
share, launches a step and a decoder layer, no host sync, and the
cross-attention's recomputed k and v timed alone; (e) the flash kernel
at the encoder's and the cross-attention decode shape, non-causal,
timed beside its plain version, its bound and SDPA; (18) training
(``repro_torch.launch.train``): (a) the flash backward kernels
(``flash_bwd_preprocess``, ``flash_bwd_dkdv_kernel``,
``flash_bwd_dq_kernel``) against autograd of the plain version at every
shape training reaches (minicpm-2b causal at h = 144, sq = sk = 512,
d = 64; d = 80 and 128; whisper-base's encoder at sq = sk = 1500 and its
cross-attention at sq = 512, sk = 1500, non-causal), float32 and bf16,
two runs bit-identical, the forward's lse against logsumexp, timed in
float32 beside the plain backward, the bound (5 products) and SDPA's
forward plus backward, and each kernel alone at minicpm-2b's shape; (b)
2 ``make_step`` steps of minicpm-2b and whisper-base reduced in float32
on the card against the CPU from one set of parameters, with and
without gradient compression; (c) minicpm-2b at full width through
``launch.train.main`` (batch 4 x 512, 6 steps, wsd): finite losses,
exactly 40 forward and 40 of each backward kernel's launches a step and
no plain call, s/step, tokens/s, peak memory, and 2 profiled steps (idle
share, launches a step split into forward, backward and optimizer); (d)
a resume at reduced size (4 steps with a checkpoint at step 2, then a
restart to 6) against 6 uninterrupted steps. Phases 5, 11, 12, 13, 14,
15, 16, 17 and 18 set the counts to 0 before their runs and read them
after, and allow no plain call, fold or failed lane grid there.
It exits non-zero, printing no result line, when there is no CUDA
device, when the port is missing, or when any phase fails. The last line is
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
# float32-grade products on the TF32 tensor cores (495 TFLOP/s dense) in
# three passes (hi hi + hi lo + lo hi), as the flash backward runs them
TF32X3_FLOP_PER_S = 495e12 / 3
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


# the record_function ranges that phase 15 (d) opens around each layer
# and its MoE part, and phase 16 (d) around each SSD layer and each call
# of the shared block
RANGES = ("strela_layer", "strela_moe")
SSM_RANGES = ("strela_ssd", "strela_shared")


def profile_run(fn):
    """Run ``fn`` under ``torch.profiler``; return the wall time, the time
    the device was busy (union of kernel and copy intervals), the device
    time per kernel name and the launches recorded per name (in a long
    process the profiler may record fewer launches than were made, so a
    time per launch divides by this count, never by the calls made), and
    the profiler's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return profile_summary(prof.events(), wall)


def profile_summary(events, wall):
    """:func:`profile_run`'s result from a profiler's events and the
    window's wall time."""
    from torch.autograd import DeviceType
    # and the trainer's ranges around a step's forward, backward, optimizer
    from repro_torch.launch.train import RANGES as TRAIN_RANGES
    spans, by_name, count = [], {}, {}
    for e in events:
        # a record_function range shows on the device's timeline too
        if e.device_type == DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or e.name in RANGES + SSM_RANGES + TRAIN_RANGES):
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
            "count": count, "events": events}


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


# ---------------------------------------------------------------------------
# phase 14: the LM serving path, repro_torch.launch.serve_lm on the card
# ---------------------------------------------------------------------------

LM_ARCH = "minicpm-2b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 32, 16      # serve_lm's defaults
# (sq, sk) of the flash kernel on that path: one query against 1..48
# cached keys while serving (49 is the caches' length), sq = sk for a
# prefill
LM_FLASH_SHAPES = ((1, 1), (1, 17), (1, 49), (1024, 1024))
LM_TIMED = ((1, 49), (1024, 1024))
# the reference's decode tolerance (tests/test_models.py:73-75): the same
# bfloat16 model on the card and on the CPU sums in other orders
LM_TOL = 3e-2
LM_PROFILED_STEPS = 8


def allowed_pairs(h, sq, sk, causal):
    """(query, key) pairs the end-aligned mask allows, over h heads."""
    if not causal:
        return h * sq * sk
    return h * sum(min(sk, sk - sq + i + 1) for i in range(sq))


def time_flash(q, k, v, tag, causal=True):
    """The flash kernel's events time on (q, k, v), causal or not, beside
    its plain version's, SDPA's on the same inputs (checked to compute the
    same function) and the bound (``h * sq * sk`` pairs without the mask);
    the profiler's device time per launch."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    h, sq, d = q.shape
    sk = k.shape[1]
    # SDPA's is_causal aligns the mask to the first key; with one
    # query the end-aligned mask hides nothing, so it runs unmasked
    library = lambda c=causal and sq == sk: (  # noqa: E731
        F.scaled_dot_product_attention(q[None], k[None], v[None],
                                       is_causal=c)[0])
    e_lib = close(library(), fa.attention_plain(q, k, v, causal), 1e-4,
                  1e-4, f"SDPA at sq={sq} sk={sk} is another function")
    pairs = allowed_pairs(h, sq, sk, causal)
    b_ms, b_by = dense_bound(4 * h * d * (2 * sq + 2 * sk), 4 * d * pairs,
                             FP32_FLOP_PER_S)
    kernel = lambda: fa.attention_kernel(q, k, v, causal)  # noqa: E731
    ms = time_ms(kernel)
    plain_ms = time_ms(lambda: fa.attention_plain(q, k, v, causal),
                       reps=5, warm=1)
    library_ms = time_ms(library)
    kernel()
    dev = per_launch(profile_run(lambda: [kernel() for _ in range(5)]))
    print(f"[{tag}] flash_attention {'causal' if causal else 'non-causal'} "
          f"f32 h={h} sq={sq} sk={sk} "
          f"d={d}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
          f"{library_ms:.4f} ms (max abs err against plain {e_lib}), "
          f"bound {b_ms:.5f} ms ({b_by}), share of bound "
          f"{b_ms / ms:.3f}, kernel / SDPA {ms / library_ms:.3f}; "
          f"profiler device ms per launch (launches recorded of 5) "
          f"{dev or 'not measured'}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def phase_lm(device):
    """(a) the flash kernel at minicpm-2b's attention shapes against its
    plain version; (b) minicpm-2b at full width cut to 2 layers, on the
    card and on the CPU from the same parameters; (c) the full 40-layer
    model through ``serve_lm.main`` with the flash counts read around it;
    (d) the device's idle share over profiled decode steps, and the flash
    kernel's time at the decode shape and at sq = sk = 1024 beside its
    plain version, its bound and SDPA on the same inputs."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model
    cfg = get_arch(LM_ARCH)
    h, d = LM_BATCH * cfg.n_heads, cfg.hd
    rng = np.random.default_rng(SEED + 14)
    print(f"[lm] card: {nvidia_smi()}")

    # (a) the kernel at the model's shapes
    cases, err = {}, 0.0
    for sq, sk in LM_FLASH_SHAPES:
        q = normal(rng, (h, sq, d), device)
        k, v = (normal(rng, (h, sk, d), device) for _ in range(2))
        e = close(fa.attention_kernel(q, k, v, True),
                  fa.attention_plain(q, k, v, True), 3e-5, 3e-5,
                  f"flash_attention h={h} sq={sq} sk={sk} d={d}")
        cases[sq, sk], err = (q, k, v), max(err, e)
    print(f"[lm] (a) flash_kernel against its plain version on the card at "
          f"h={h}, d={d}, causal, (sq, sk) in {LM_FLASH_SHAPES}: max abs "
          f"err {err} (limit 3e-5)")

    # (b) full width, 2 layers: the card against the CPU
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    api2 = build_model(cfg2)
    cpu_params = api2.init_params(torch.Generator().manual_seed(SEED))
    runs = {}
    prompt = rng.integers(0, cfg.vocab, (LM_BATCH, 8)).astype(np.int32)
    for label, params in (("cpu", cpu_params),
                          ("card", copy.deepcopy(cpu_params).to(device))):
        toks = torch.from_numpy(prompt).to(params.embed.device)
        with torch.inference_mode():
            logits, state = api2.prefill(params, {"tokens": toks[:, :4],
                                                  "max_len": 8})
            runs[label] = [logits] + [
                api2.decode_step(params, state, toks[:, t:t + 1], t)[0]
                for t in range(4, 8)]
    check(all(x.device.type == device.type for x in runs["card"]),
          "the 2-layer model's logits are not on the card")
    errs = [close(g.cpu(), c, LM_TOL, LM_TOL,
                  f"{LM_ARCH} 2 layers, step {i}: card != CPU")
            for i, (g, c) in enumerate(zip(runs["card"], runs["cpu"]))]
    print(f"[lm] (b) {LM_ARCH} at full width cut to 2 layers ({cfg.dtype}): "
          f"prefill of 4 tokens and 4 decode steps on the card against the "
          f"CPU from the same parameters: max abs err per step {errs} "
          f"(limit {LM_TOL} + {LM_TOL} |logit|)")
    del cpu_params, runs
    torch.cuda.empty_cache()

    # (c) the full model through serve_lm.main: every count at 0 just
    # before, read just after
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.plain_calls = 0
    t0 = time.perf_counter()
    res = serve_lm.main(["--arch", LM_ARCH, "--batch", str(LM_BATCH),
                         "--prompt-len", str(LM_PROMPT), "--gen",
                         str(LM_GEN), "--seed", str(SEED),
                         "--device", str(device)])
    wall = time.perf_counter() - t0
    launches, plain = fa.launches, fa.plain_calls
    tokens, logits = res["tokens"], res["logits"]
    want = cfg.n_layers * (LM_PROMPT + LM_GEN)
    check(tokens.shape == (LM_BATCH, LM_GEN) and tokens.min() >= 0
          and tokens.max() < cfg.vocab, f"serve_lm tokens out of the "
          f"vocab or misshapen: {tokens.shape}")
    check(logits.device.type == device.type and logits.shape == (
        LM_BATCH, cfg.vocab_padded) and bool(torch.isfinite(
            logits[:, :cfg.vocab].float()).all()),
          "serve_lm's last logits are not finite on the card")
    check(launches == want and plain == 0,
          f"serve_lm: flash launches {launches} (want {cfg.n_layers} "
          f"layers x {LM_PROMPT + LM_GEN} steps = {want}), plain calls "
          f"{plain} (want 0)")
    n_params = sum(p.numel() for p in res["params"].parameters())
    print(f"[lm] (c) serve_lm.main --arch {LM_ARCH} ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads x {d}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab} padded to {cfg.vocab_padded}; "
          f"{n_params} parameters in {cfg.dtype}), batch {LM_BATCH}, prompt "
          f"{LM_PROMPT}, gen {LM_GEN}, seed {SEED}: prefill "
          f"{res['prefill_s']:.4f} s ({res['prefill_s'] / LM_PROMPT * 1e3:.3f}"
          f" ms/step), decode {res['ms_per_token']:.4f} ms/token/batch; "
          f"call wall {wall:.3f} s with the weights' init; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; flash "
          f"launches {launches}, plain calls {plain}; row 0 "
          f"{tokens[0].tolist()}")

    # (d) the device's idle share over decode steps at the last positions
    # (they rewrite positions 40..47 of the caches)
    api, params, state = res["api"], res["params"], res["state"]
    cur = torch.argmax(logits, -1)[:, None]
    first = LM_PROMPT + LM_GEN - LM_PROFILED_STEPS

    def steps():
        with torch.inference_mode():
            for i in range(LM_PROFILED_STEPS):
                api.decode_step(params, state, cur, first + i)
    steps()
    prof = profile_run(steps)
    if prof["by_name"]:
        check(any("flash_kernel" in n for n in prof["by_name"]),
              f"the profiler saw no flash kernel: {list(prof['by_name'])}")
        top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:6]
        print(f"[lm] (d) {LM_PROFILED_STEPS} profiled decode steps: wall "
              f"{prof['wall_s']:.4f} s "
              f"({prof['wall_s'] / LM_PROFILED_STEPS * 1e3:.3f} ms/step), "
              f"device busy {prof['busy_s'] * 1e3:.4f} ms, device idle "
              f"share {1 - prof['busy_s'] / prof['wall_s']:.5f}; device ms "
              f"by name {({n: round(v / 1e3, 4) for n, v in top})}; "
              f"launches recorded {sum(prof['count'].values())}")
    else:
        print("[lm] (d) device idle share not measured (the profiler "
              "recorded no device activity)")
    del res, api, params, state, logits
    torch.cuda.empty_cache()

    rows = {(sq, sk): time_flash(*cases[sq, sk], "lm-times")
            for sq, sk in LM_TIMED}
    print(f"[lm] card: {nvidia_smi()}")
    decode = rows[LM_TIMED[0]]
    return dict(decode, launches=launches, max_abs_err=err)


# ---------------------------------------------------------------------------
# phase 15: the MoE and vlm LM paths (repro_torch.models.moe) on the card
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-3b-a800m"
# the MoE layer's tokens per call: granite's decode at batch 4 (C = 1) and
# a 128-token prefill (C = 32)
MOE_TOKENS = (4, 128)
# card and CPU may route a token apart only where the CPU's k-th and
# (k+1)-th probabilities nearly tie
MOE_FLIP_MARGIN = 1e-4
MOE_PROMPT, MOE_DECODE = 8, 4            # (b): decode steps on 2 layers
VLM_ARCH, VLM_BATCH, VLM_TEXT = "internvl2-76b", 2, 32
SCOUT_ARCH, SCOUT_BATCH, SCOUT_STEPS = "llama4-scout-17b-a16e", 4, 4


def moved(tree, device):
    return {k: moved(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def capture_routing(params, record):
    """A forward pre-hook on each layer's MoE module: ``route`` on the
    layer's input, kept on the host as (layer, probs, gate_idx)."""
    from repro_torch.models import moe as M
    for i, block in enumerate(params.layers):
        def hook(mod, args, i=i):
            probs, _, idx = M.route(mod, mod.spec, args[0])
            record.append((i, probs.cpu(), idx.cpu()))
        block.moe.register_forward_pre_hook(hook)


def first_flips(cpu_rec, card_rec, n_rows, k):
    """Walk the routing of both runs call by call (steps, then layers).
    A row whose chosen experts differ is where the runs part: that row and
    every later one (the capacity's positions run by token) are not
    compared from that step on. Returns each row's first step apart (None
    where never) and the flips with the CPU's top-k margin."""
    apart, flips = [None] * n_rows, []
    n_layers = 1 + max(rec[0] for rec in cpu_rec)
    for call, ((layer, probs, ci), (_, _, gi)) in enumerate(
            zip(cpu_rec, card_rec)):
        step = call // n_layers
        # a row's routing in this call depends on its own input only, so
        # every row not yet apart is checked before any is set apart
        flipped = [b for b in range(n_rows) if apart[b] is None
                   and not same_experts(ci[b], gi[b])]
        for b in flipped:
            top = probs[b].sort(descending=True).values
            flips.append((step, layer, b, float(top[k - 1] - top[k])))
        for r in range(min(flipped, default=n_rows), n_rows):
            if apart[r] is None:
                apart[r] = step
    return apart, flips


def same_experts(a, b):
    """One token's chosen experts, as sets: an order swap inside the top-k
    changes nothing downstream."""
    import torch
    return torch.equal(a.sort().values, b.sort().values)


def launches_in(events, names):
    """Kernel launches (runtime calls named ``*LaunchKernel*``) made
    inside each ``record_function`` range of ``names`` and in all."""
    import bisect
    from torch.autograd import DeviceType
    spans = {n: [] for n in names}
    calls = []
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name in spans:
            spans[e.name].append((e.time_range.start, e.time_range.end))
        elif "LaunchKernel" in e.name:
            calls.append(e.time_range.start)
    counts = {}
    for n, ranges in spans.items():
        ranges.sort()
        starts = [a for a, _ in ranges]
        counts[n] = sum(1 for t in calls
                        if (i := bisect.bisect_right(starts, t) - 1) >= 0
                        and t <= ranges[i][1])
    counts["all"] = len(calls)
    return counts


def mark_ranges(pairs):
    """``record_function`` ranges around each call of each module of the
    (module, range name) ``pairs``, opened and closed by forward hooks."""
    import torch
    open_ranges = []

    def enter(name):
        def pre(mod, args):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            open_ranges.append(rf)
        return pre

    def leave(mod, args, out):
        open_ranges.pop().__exit__(None, None, None)
    handles = []
    for mod, name in pairs:
        handles.append(mod.register_forward_pre_hook(enter(name)))
        handles.append(mod.register_forward_hook(leave))
    return handles


def phase_moe(device):
    """(a) the MoE layer at granite's widths, card against CPU; (b) granite
    at full width cut to 2 layers, card against CPU up to each row's first
    routing flip; (c) the full 32-layer granite through ``serve_lm.main``
    with the flash counts read around it; (d) a profile of 8 decode steps
    with the launches a layer split into attention and MoE, and the host
    syncs of one step; (e) internvl2-76b's prefill and llama4-scout's
    decode at full width cut to 2 layers; the flash kernel's times at
    granite's decode shape and internvl2's prefill shape."""
    import copy
    import warnings
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    cfg = get_arch(MOE_ARCH)
    spec, k = cfg.moe, cfg.moe.top_k
    print(f"[moe] card: {nvidia_smi()}")

    # (a) the layer at granite's widths
    p = M.moe_init(torch.Generator().manual_seed(SEED), cfg.d_model,
                   cfg.d_ff, spec, torch.bfloat16)
    pc = moved(p, device)
    gen = torch.Generator().manual_seed(SEED + 15)
    for n in MOE_TOKENS:
        x = torch.randn(4, n // 4, cfg.d_model, generator=gen)
        x = x.to(torch.bfloat16)
        want, want_aux = M.moe_apply(p, spec, cfg.d_ff, x)
        _, _, want_idx = M.route(p, spec, x)
        xc = x.to(device)
        out, aux = M.moe_apply(pc, spec, cfg.d_ff, xc)
        again, again_aux = M.moe_apply(pc, spec, cfg.d_ff, xc)
        _, _, idx = M.route(pc, spec, xc)
        check(torch.equal(idx.cpu(), want_idx),
              f"moe_apply at N={n}: the card routes otherwise than the CPU")
        check(torch.equal(out, again) and torch.equal(aux, again_aux),
              f"moe_apply at N={n}: two card runs differ")
        err = close(out.cpu(), want, LM_TOL, LM_TOL,
                    f"moe_apply at N={n}: card != CPU")
        close(aux.cpu()[None], want_aux[None], 0.0, 1e-5,
              f"moe_apply at N={n}: aux card != CPU")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            quiet, _ = M.moe_apply(pc, spec, cfg.d_ff, xc)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(torch.equal(quiet, out), f"moe_apply at N={n}: the run under "
              f"sync-debug differs")
        C = M.capacity(spec, n)
        _, keep = M.dispatch_slots(want_idx, spec.n_experts, C)
        print(f"[moe] (a) moe_apply at {MOE_ARCH}'s widths (D {cfg.d_model}, "
              f"F {cfg.d_ff}, {spec.n_experts} experts top-{k}, bf16), "
              f"N={n} (C={C}): routing equal to the CPU's, max abs err "
              f"{err} (limit {LM_TOL} + {LM_TOL} |x|), two card runs "
              f"bit-identical, no sync under sync-debug \"error\"; routed "
              f"pairs dropped {int((~keep).sum())} of {keep.numel()} "
              f"(share {float((~keep).float().mean()):.4f})")
    del p, pc

    # (b) full width, 2 layers: the card against the CPU up to each row's
    # first routing flip
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    api2 = build_model(cfg2)
    cpu_params = api2.init_params(torch.Generator().manual_seed(SEED))
    card_params = copy.deepcopy(cpu_params).to(device)
    rng = np.random.default_rng(SEED + 15)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (
        LM_BATCH, MOE_PROMPT)).astype(np.int32))
    runs, recs, fed = {}, {}, []
    for label, params in (("cpu", cpu_params), ("card", card_params)):
        recs[label] = []
        capture_routing(params, recs[label])
        dev = params.embed.device
        state = T.init_caches(cfg2, LM_BATCH, MOE_PROMPT + MOE_DECODE,
                              device=dev)
        logits, steps = None, []
        with torch.inference_mode():
            for t in range(MOE_PROMPT + MOE_DECODE):
                if t < MOE_PROMPT:
                    tok = prompt[:, t:t + 1]
                elif label == "cpu":
                    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
                    fed.append(tok)
                else:
                    tok = fed[t - MOE_PROMPT]
                logits, state = api2.decode_step(params, state, tok.to(dev),
                                                 t)
                steps.append(logits)
        runs[label] = steps
    check(all(x.device.type == device.type for x in runs["card"]),
          "the 2-layer MoE model's logits are not on the card")
    apart, flips = first_flips(recs["cpu"], recs["card"], LM_BATCH, k)
    for step, layer, row, margin in flips:
        check(margin < MOE_FLIP_MARGIN,
              f"{MOE_ARCH} 2 layers: row {row} routes apart at step {step} "
              f"layer {layer} where the CPU's top-{k} margin is {margin} "
              f"(a flip is accepted under {MOE_FLIP_MARGIN})")
    errs, compared = [], 0
    for t, (g, c) in enumerate(zip(runs["card"], runs["cpu"])):
        rows = [b for b in range(LM_BATCH) if apart[b] is None or
                t < apart[b]]
        compared += len(rows)
        if rows:
            errs.append(close(g.cpu()[rows], c[rows], LM_TOL, LM_TOL,
                              f"{MOE_ARCH} 2 layers, step {t}: card != "
                              f"CPU"))
    check(compared > 0, f"{MOE_ARCH} 2 layers: no row left to compare")
    print(f"[moe] (b) {MOE_ARCH} at full width cut to 2 layers "
          f"({cfg.dtype}): {MOE_PROMPT} prompt and {MOE_DECODE} greedy "
          f"decode steps on the card against the CPU from the same "
          f"parameters; routing flips {len(flips)} (step, layer, row, CPU "
          f"top-{k} margin: {flips}; accepted under {MOE_FLIP_MARGIN}); "
          f"rows x steps compared {compared} of "
          f"{LM_BATCH * (MOE_PROMPT + MOE_DECODE)}; max abs err per step "
          f"{errs} (limit {LM_TOL} + {LM_TOL} |logit|)")
    del cpu_params, card_params, runs, recs
    torch.cuda.empty_cache()

    # (c) the full model through serve_lm.main: every count at 0 just
    # before, read just after
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.plain_calls = 0
    t0 = time.perf_counter()
    res = serve_lm.main(["--arch", MOE_ARCH, "--batch", str(LM_BATCH),
                         "--prompt-len", str(LM_PROMPT), "--gen",
                         str(LM_GEN), "--seed", str(SEED),
                         "--device", str(device)])
    wall = time.perf_counter() - t0
    launches, plain = fa.launches, fa.plain_calls
    tokens, logits = res["tokens"], res["logits"]
    want = cfg.n_layers * (LM_PROMPT + LM_GEN)
    check(tokens.shape == (LM_BATCH, LM_GEN) and tokens.min() >= 0
          and tokens.max() < cfg.vocab, f"serve_lm {MOE_ARCH} tokens out of "
          f"the vocab or misshapen: {tokens.shape}")
    check(logits.device.type == device.type and bool(torch.isfinite(
        logits[:, :cfg.vocab].float()).all()),
          f"serve_lm {MOE_ARCH}'s last logits are not finite on the card")
    check(launches == want and plain == 0,
          f"serve_lm {MOE_ARCH}: flash launches {launches} (want "
          f"{cfg.n_layers} layers x {LM_PROMPT + LM_GEN} steps = {want}), "
          f"plain calls {plain} (want 0)")
    n_params = sum(q.numel() for q in res["params"].parameters())
    print(f"[moe] (c) serve_lm.main --arch {MOE_ARCH} ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads x {cfg.hd} "
          f"(kv {cfg.n_kv_heads}), {spec.n_experts} experts top-{k} of "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab} padded to "
          f"{cfg.vocab_padded}; {n_params} parameters in {cfg.dtype}, "
          f"routers float32), batch {LM_BATCH}, prompt {LM_PROMPT}, gen "
          f"{LM_GEN}, seed {SEED}: prefill {res['prefill_s']:.4f} s "
          f"({res['prefill_s'] / LM_PROMPT * 1e3:.3f} ms/step), decode "
          f"{res['ms_per_token']:.4f} ms/token/batch; call wall "
          f"{wall:.3f} s with the weights' init; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; flash "
          f"launches {launches}, plain calls {plain}; row 0 "
          f"{tokens[0].tolist()}")

    # (d) a profile of decode steps at the last positions (they rewrite
    # positions 40..47 of the caches), launches split by layer part
    api, params, state = res["api"], res["params"], res["state"]
    cur = torch.argmax(logits, -1)[:, None]
    first = LM_PROMPT + LM_GEN - LM_PROFILED_STEPS

    def steps():
        with torch.inference_mode():
            for i in range(LM_PROFILED_STEPS):
                api.decode_step(params, state, cur, first + i)
    steps()
    prof = profile_run(steps)
    handles = mark_ranges([pair for block in params.layers
                           for pair in zip((block, block.moe), RANGES)])
    try:
        split = launches_in(profile_run(steps)["events"], RANGES)
    finally:
        for h in handles:
            h.remove()
    per_layer = LM_PROFILED_STEPS * cfg.n_layers
    if prof["by_name"]:
        top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:8]
        print(f"[moe] (d) {LM_PROFILED_STEPS} profiled decode steps: wall "
              f"{prof['wall_s']:.4f} s "
              f"({prof['wall_s'] / LM_PROFILED_STEPS * 1e3:.3f} ms/step), "
              f"device busy {prof['busy_s'] * 1e3:.4f} ms, device idle "
              f"share {1 - prof['busy_s'] / prof['wall_s']:.5f}; device ms "
              f"by name {({n: round(v / 1e3, 4) for n, v in top})}; kernels "
              f"recorded {sum(prof['count'].values())}")
    else:
        print("[moe] (d) device idle share not measured (the profiler "
              "recorded no device activity)")
    attn = split["strela_layer"] - split["strela_moe"]
    outside = split["all"] - split["strela_layer"]
    print(f"[moe] (d) kernel launches (host calls, a second profiled run "
          f"with a range around each layer and its MoE part) per step "
          f"{split['all'] / LM_PROFILED_STEPS:.1f}; per layer "
          f"{split['strela_layer'] / per_layer:.2f}: attention part "
          f"{attn / per_layer:.2f}, MoE part "
          f"{split['strela_moe'] / per_layer:.2f}; outside the layers "
          f"{outside / LM_PROFILED_STEPS:.1f} per step")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with torch.inference_mode():
                api.decode_step(params, state, cur, first)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)]
    print(f"[moe] (d) host syncs in one decode step under sync-debug "
          f"\"warn\": {len(syncs)} {syncs[:3]}")
    del res, api, params, state, logits, prof
    torch.cuda.empty_cache()

    # (e) the other two families at full width, cut to 2 layers (the
    # whole models need about 141 and 216 GB in bf16)
    vcfg = dataclasses.replace(get_arch(VLM_ARCH), n_layers=2)
    vapi = build_model(vcfg)
    vparams = vapi.init_params(torch.Generator(device).manual_seed(SEED))
    pgen = torch.Generator(device).manual_seed(SEED + 15)
    patches = (torch.randn(VLM_BATCH, vcfg.n_patches, vcfg.d_model,
                           generator=pgen, device=device) * 0.02)
    vtoks = torch.from_numpy(rng.integers(0, vcfg.vocab, (
        VLM_BATCH, VLM_TEXT)).astype(np.int32)).to(device)
    fa.launches = fa.plain_calls = 0
    vlogits, vstate = vapi.prefill(vparams, {
        "tokens": vtoks, "patches": patches.to(vcfg.torch_dtype)})
    torch.cuda.synchronize()
    v_launches, v_plain = fa.launches, fa.plain_calls
    total = vcfg.n_patches + VLM_TEXT
    check(v_launches == vcfg.n_layers and v_plain == 0,
          f"{VLM_ARCH} prefill: flash launches {v_launches} (want "
          f"{vcfg.n_layers}), plain calls {v_plain}")
    check(tuple(vlogits.shape) == (VLM_BATCH, vcfg.vocab_padded) and bool(
        torch.isfinite(vlogits.float()).all()) and vstate[0].shape[2] ==
          total, f"{VLM_ARCH} prefill: logits not finite or misshapen")
    print(f"[moe] (e) {VLM_ARCH} at full width cut to 2 layers (d_model "
          f"{vcfg.d_model}, {vcfg.n_heads} heads x {vcfg.hd}, d_ff "
          f"{vcfg.d_ff}): api.prefill of {vcfg.n_patches} seeded patches + "
          f"{VLM_TEXT} tokens at batch {VLM_BATCH}: flash launches "
          f"{v_launches} (sq = sk = {total}, d = {vcfg.hd}), plain calls "
          f"{v_plain}; logits finite, |max| "
          f"{float(vlogits.float().abs().max()):.4f}")
    del vparams, vstate, vlogits, patches
    torch.cuda.empty_cache()

    scfg = dataclasses.replace(get_arch(SCOUT_ARCH), n_layers=2)
    sapi = build_model(scfg)
    sparams = sapi.init_params(torch.Generator(device).manual_seed(SEED))
    state = T.init_caches(scfg, SCOUT_BATCH, SCOUT_STEPS, device=device)
    tok = torch.from_numpy(rng.integers(0, scfg.vocab, (
        SCOUT_BATCH, 1)).astype(np.int32)).to(device)
    fa.launches = fa.plain_calls = 0
    out = []
    with torch.inference_mode():
        for t in range(SCOUT_STEPS):
            slog, state = sapi.decode_step(sparams, state, tok, t)
            tok = torch.argmax(slog, -1)[:, None]
            out.append(tok[:, 0].cpu())
    s_launches, s_plain = fa.launches, fa.plain_calls
    stoks = torch.stack(out, 1)
    check(s_launches == scfg.n_layers * SCOUT_STEPS and s_plain == 0,
          f"{SCOUT_ARCH} decode: flash launches {s_launches} (want "
          f"{scfg.n_layers * SCOUT_STEPS}), plain calls {s_plain}")
    check(bool(torch.isfinite(slog[:, :scfg.vocab].float()).all()) and
          int(stoks.min()) >= 0 and int(stoks.max()) < scfg.vocab,
          f"{SCOUT_ARCH} decode: logits not finite or tokens out of the "
          f"vocab")
    print(f"[moe] (e) {SCOUT_ARCH} at full width cut to 2 layers (d_model "
          f"{scfg.d_model}, {scfg.n_heads} heads x {scfg.hd}, "
          f"{scfg.moe.n_experts} experts top-{scfg.moe.top_k} with a shared "
          f"expert of d_ff {scfg.d_ff}): {SCOUT_STEPS} decode steps at "
          f"batch {SCOUT_BATCH}: flash launches {s_launches}, plain calls "
          f"{s_plain}; logits finite; tokens {stoks.tolist()}")
    del sparams, state, slog
    torch.cuda.empty_cache()

    # the flash kernel at the two new shapes: against its plain version,
    # then timed
    frng = np.random.default_rng(SEED + 15)
    shapes = {"flash_attention lm moe decode": (
                  LM_BATCH * cfg.n_heads, 1, LM_PROMPT + LM_GEN, cfg.hd),
              "flash_attention vlm prefill d128": (
                  VLM_BATCH * vcfg.n_heads, total, total, vcfg.hd)}
    rows = {}
    for name, (h, sq, sk, d) in shapes.items():
        q = normal(frng, (h, sq, d), device)
        kk, vv = (normal(frng, (h, sk, d), device) for _ in range(2))
        e = close(fa.attention_kernel(q, kk, vv, True),
                  fa.attention_plain(q, kk, vv, True), 3e-5, 3e-5,
                  f"flash_attention h={h} sq={sq} sk={sk} d={d}")
        print(f"[moe] flash_kernel against its plain version at h={h}, "
              f"sq={sq}, sk={sk}, d={d}, causal: max abs err {e} (limit "
              f"3e-5)")
        rows[name] = dict(time_flash(q, kk, vv, "moe-times"), max_abs_err=e,
                          launches=launches if "moe" in name
                          else v_launches)
    print(f"[moe] card: {nvidia_smi()}")
    return rows


# ---------------------------------------------------------------------------
# phase 16: the Mamba-2 SSD layer and the Zamba-2 hybrid on the card
# ---------------------------------------------------------------------------

SSM_ARCH, HYBRID_ARCH = "mamba2-1.3b", "zamba2-2.7b"
SSD_SEQS = (256, 512)            # one and two chunks of the full 256
SSD_BATCH, SSD_DECODE = 2, 4     # (a): decode steps from the carried state
# (b), (e): depth cut to 2 SSD layers and to 6, which is one site of the
# shared block
SSM_CUTS = {SSM_ARCH: 2, HYBRID_ARCH: 6}
SSM_PROMPT, SSM_GEN = 8, 4       # (b): through serve_lm.generate
PREFILL_SEQ, PREFILL_BATCH = 256, 2     # (e): api.prefill, one chunk


def recording(api, out):
    """``api`` whose ``decode_step`` also appends each step's logits to
    ``out``."""
    def step(params, state, tokens, cache_len):
        logits, state = api.decode_step(params, state, tokens, cache_len)
        out.append(logits)
        return logits, state
    return dataclasses.replace(api, decode_step=step)


def ssd_layer_case(cfg, dtype, device):
    """One SSD layer at ``cfg``'s widths in ``dtype``: the chunked form at
    each of ``SSD_SEQS`` and ``SSD_DECODE`` decode steps from the carried
    state, on the card against the CPU from the same parameters and
    inputs; two card runs bit-identical; no host sync under sync-debug
    "error". Returns the max abs errors (chunked, decode)."""
    import torch
    from repro_torch.models import ssm as S
    cfg = dataclasses.replace(cfg, dtype=dtype)
    p = S.ssm_init(torch.Generator().manual_seed(SEED), cfg, cfg.torch_dtype)
    pc = {k: v.to(device) for k, v in p.items()}
    gen = torch.Generator().manual_seed(SEED + 16)
    n = max(SSD_SEQS)
    x = torch.randn(SSD_BATCH, n + SSD_DECODE, cfg.d_model, generator=gen)
    x = x.to(cfg.torch_dtype)
    xc = x.to(device)
    tag = f"{cfg.arch_id} SSD layer {dtype}"
    chunk_err = 0.0
    with torch.inference_mode():
        for seq in SSD_SEQS:
            want, wst = S.ssm_forward(p, cfg, x[:, :seq])
            got, gst = S.ssm_forward(pc, cfg, xc[:, :seq])
            again, rst = S.ssm_forward(pc, cfg, xc[:, :seq])
            check(torch.equal(got, again) and torch.equal(gst[1], rst[1]),
                  f"{tag} S={seq}: two card runs differ")
            chunk_err = max(chunk_err, close(
                got.cpu(), want, LM_TOL, LM_TOL, f"{tag} S={seq}: card != "
                f"CPU"), close(gst[1].cpu(), wst[1], LM_TOL, LM_TOL,
                               f"{tag} S={seq}: final state card != CPU"))
        wst = tuple(t.clone() for t in wst)
        gst = tuple(t.clone() for t in gst)
        rst = tuple(t.clone() for t in gst)
        dec_err = 0.0
        for t in range(n, n + SSD_DECODE):
            want, wst = S.ssm_forward(p, cfg, x[:, t:t + 1], wst)
            got, gst = S.ssm_forward(pc, cfg, xc[:, t:t + 1], gst)
            again, rst = S.ssm_forward(pc, cfg, xc[:, t:t + 1], rst)
            check(torch.equal(got, again) and torch.equal(gst[1], rst[1]),
                  f"{tag} decode step {t}: two card runs differ")
            dec_err = max(dec_err, close(got.cpu(), want, LM_TOL, LM_TOL,
                                         f"{tag} decode step {t}: card != "
                                         f"CPU"))
        close(gst[1].cpu(), wst[1], LM_TOL, LM_TOL,
              f"{tag}: decode state card != CPU")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            S.ssm_forward(pc, cfg, xc[:, :SSD_SEQS[0]])
            S.ssm_forward(pc, cfg, xc[:, n:n + 1], gst)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return chunk_err, dec_err


def cut_depth_case(arch, n_layers, device, rng):
    """(b) ``arch`` at full width cut to ``n_layers`` through
    ``serve_lm.generate`` and (e) its ``api.prefill``, card against CPU.
    bf16 rounding differs between the card's and the CPU's GEMMs and adds
    up over layers, so the float32 model (the bf16 weights upcast) is held
    to the LM tolerance, and each bf16 run to its distance from that
    float32 model on the CPU: the card's no more than twice the CPU's
    own."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model
    from repro_torch.models import hybrid as H
    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    sites = H.n_shared_sites(cfg) if cfg.family == "hybrid" else 0
    api, api32 = build_model(cfg), build_model(cfg32)
    bf = api.init_params(torch.Generator().manual_seed(SEED))
    f32 = copy.deepcopy(bf).float()
    f32.cfg = cfg32
    models = {("cpu", "bf16"): (api, bf),
              ("card", "bf16"): (api, copy.deepcopy(bf).to(device)),
              ("cpu", "f32"): (api32, f32),
              ("card", "f32"): (api32, copy.deepcopy(f32).to(device))}
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (
        LM_BATCH, SSM_PROMPT)).astype(np.int32))
    runs = {}
    for key, (a, params) in models.items():
        steps = []
        fa.launches = fa.plain_calls = 0
        with torch.inference_mode():
            res = serve_lm.generate(recording(a, steps), params,
                                    prompt.to(params.embed.device),
                                    SSM_GEN)
        runs[key] = (res["tokens"], [x.cpu().float() for x in steps],
                     (fa.launches, fa.plain_calls))
    want = sites * (SSM_PROMPT + SSM_GEN)
    for key in (("card", "bf16"), ("card", "f32")):
        check(runs[key][2] == (want, 0), f"{arch} {n_layers} layers "
              f"generate {key[1]}: flash launches, plain calls "
              f"{runs[key][2]} (want {want}, 0)")
    # float32: a row's generations part where the greedy choice flips,
    # so each row is compared up to that step, and a flip is accepted
    # only where the CPU's logits put the card's choice within twice
    # the tolerance of its own
    (ctok, csteps, _), (gtok, gsteps, _) = (runs["cpu", "f32"],
                                            runs["card", "f32"])
    errs, flips = [], []
    for b in range(LM_BATCH):
        diff = np.flatnonzero(ctok[b] != gtok[b])
        last = SSM_PROMPT + (diff[0] if diff.size else SSM_GEN)
        for t in range(last):
            errs.append(close(gsteps[t][b], csteps[t][b], LM_TOL, LM_TOL,
                              f"{arch} {n_layers} layers float32, row "
                              f"{b} step {t}: card != CPU"))
        if diff.size:
            lg = csteps[last - 1][b]
            top = float(lg[int(ctok[b, diff[0]])])
            margin = top - float(lg[int(gtok[b, diff[0]])])
            check(margin <= 2 * (LM_TOL + LM_TOL * abs(top)),
                  f"{arch} {n_layers} layers: row {b} flips at step "
                  f"{last - 1} where the CPU's margin is {margin}")
            flips.append((b, last - 1, margin))
    # bf16 over the prompt's steps, whose inputs every run shares (the
    # vocabulary's columns: the padded ones hold -1e30 in each dtype)
    def prompt_logits(key):
        return torch.stack(runs[key][1][:SSM_PROMPT])[..., :cfg.vocab]
    ref = prompt_logits(("cpu", "f32"))
    dist = {dev: float((prompt_logits((dev, "bf16")) - ref).abs().max())
            for dev in ("cpu", "card")}
    pair = float((prompt_logits(("card", "bf16"))
                  - prompt_logits(("cpu", "bf16"))).abs().max())
    check(dist["card"] <= 2 * dist["cpu"], f"{arch} {n_layers} layers "
          f"bf16: the card's logits are {dist['card']} from the float32 "
          f"model's, the CPU's {dist['cpu']}")
    print(f"[ssm] (b) {arch} at full width cut to {n_layers} layers "
          f"({sites} shared-block sites) through serve_lm.generate, "
          f"batch {LM_BATCH} x ({SSM_PROMPT} + {SSM_GEN}), the same "
          f"weights in float32 and bf16: float32 card against CPU max "
          f"abs err {max(errs)} over {len(errs)} row-steps (limit "
          f"{LM_TOL} + {LM_TOL} |logit|), greedy flips (row, step, CPU "
          f"margin) {flips}; bf16 over the {SSM_PROMPT} prompt steps: "
          f"max abs distance from the float32 CPU run, card {dist['card']}"
          f", CPU {dist['cpu']} (the card's held to twice the CPU's), "
          f"card against CPU {pair}; card flash launches {want} a run, "
          f"plain calls 0; card bf16 tokens "
          f"{runs['card', 'bf16'][0].tolist()}")

    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
        PREFILL_BATCH, PREFILL_SEQ)).astype(np.int32))
    outs = {}
    for key, (a, params) in models.items():
        fa.launches = fa.plain_calls = 0
        with torch.inference_mode():
            logits, _ = a.prefill(params, {
                "tokens": toks.to(params.embed.device)})
        outs[key] = logits.cpu().float()
        if key[0] == "card":
            check((fa.launches, fa.plain_calls) == (sites, 0),
                  f"{arch} {n_layers} layers prefill {key[1]}: flash "
                  f"launches, plain calls {fa.launches, fa.plain_calls} "
                  f"(want {sites}, 0)")
    err = close(outs["card", "f32"], outs["cpu", "f32"], LM_TOL, LM_TOL,
                f"{arch} {n_layers} layers float32 prefill: card != CPU")
    dist = {dev: float((outs[dev, "bf16"] - outs["cpu", "f32"]).abs()
                       .max()) for dev in ("cpu", "card")}
    check(dist["card"] <= 2 * dist["cpu"], f"{arch} {n_layers} layers "
          f"bf16 prefill: the card's logits are {dist['card']} from the "
          f"float32 model's, the CPU's {dist['cpu']}")
    print(f"[ssm] (e) {arch} cut to {n_layers} layers: api.prefill of "
          f"{PREFILL_SEQ} tokens at batch {PREFILL_BATCH} (the chunked "
          f"form, {PREFILL_SEQ // cfg.ssm.chunk} chunk(s) of "
          f"{cfg.ssm.chunk}): float32 card against CPU max abs err {err} "
          f"(limit {LM_TOL} + {LM_TOL} |logit|); bf16 max abs distance "
          f"from the float32 CPU run, card {dist['card']}, CPU "
          f"{dist['cpu']}, card against CPU "
          f"{float((outs['card', 'bf16'] - outs['cpu', 'bf16']).abs().max())}"
          f"; flash launches {sites} a card run (sq = sk = "
          f"{PREFILL_SEQ}), plain calls 0")



def phase_ssm(device):
    """(a) the SSD layer at mamba2-1.3b's and zamba2-2.7b's widths, card
    against CPU; (b) both models at full width cut to 2 and 6 layers
    through ``serve_lm.generate``, card against CPU, and (e) their
    ``api.prefill`` at S = 256; (c) the full models through
    ``serve_lm.main`` with the flash counts read around them; (d) 8
    profiled decode steps of each; (f) the flash kernel at zamba2's decode
    shape against its plain version, timed beside it, its bound and
    SDPA."""
    import warnings
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve_lm
    from repro_torch.models import hybrid as H
    from repro_torch.models import ssm as S
    print(f"[ssm] card: {nvidia_smi()}")
    rng = np.random.default_rng(SEED + 16)

    # (a) the SSD layer at both models' widths
    for arch in (SSM_ARCH, HYBRID_ARCH):
        cfg = get_arch(arch)
        dI, nh, convd, N = S.dims(cfg)
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            chunk_err, dec_err = ssd_layer_case(cfg, dtype, device)
            print(f"[ssm] (a) {arch} SSD layer (d_model {cfg.d_model}, "
                  f"d_inner {dI}, {nh} heads x {cfg.ssm.head_dim}, d_state "
                  f"{N}, chunk {cfg.ssm.chunk}), {dtype}, batch {SSD_BATCH}: "
                  f"chunked at S in {SSD_SEQS} and {SSD_DECODE} decode steps "
                  f"from the carried state, card against CPU: max abs err "
                  f"{chunk_err} (chunked, final state), {dec_err} (decode) "
                  f"(limit {LM_TOL} + {LM_TOL} |x|); two card runs "
                  f"bit-identical; no sync under sync-debug \"error\" "
                  f"({time.perf_counter() - t0:.1f} s with the CPU runs)")
        torch.cuda.empty_cache()

    # (b) and (e): full width cut in depth, card against CPU
    for arch, n_layers in SSM_CUTS.items():
        cut_depth_case(arch, n_layers, device, rng)
        torch.cuda.empty_cache()

    # (c) the full models through serve_lm.main, (d) their decode steps
    hybrid_launches = None
    for arch in (SSM_ARCH, HYBRID_ARCH):
        cfg = get_arch(arch)
        sites = H.n_shared_sites(cfg) if cfg.family == "hybrid" else 0
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.plain_calls = 0
        t0 = time.perf_counter()
        res = serve_lm.main(["--arch", arch, "--batch", str(LM_BATCH),
                             "--prompt-len", str(LM_PROMPT), "--gen",
                             str(LM_GEN), "--seed", str(SEED),
                             "--device", str(device)])
        wall = time.perf_counter() - t0
        launches, plain = fa.launches, fa.plain_calls
        tokens, logits = res["tokens"], res["logits"]
        want = sites * (LM_PROMPT + LM_GEN)
        check(tokens.shape == (LM_BATCH, LM_GEN) and tokens.min() >= 0
              and tokens.max() < cfg.vocab, f"serve_lm {arch} tokens out of "
              f"the vocab or misshapen: {tokens.shape}")
        check(logits.device.type == device.type and bool(torch.isfinite(
            logits[:, :cfg.vocab].float()).all()),
              f"serve_lm {arch}'s last logits are not finite on the card")
        check(launches == want and plain == 0,
              f"serve_lm {arch}: flash launches {launches} (want {sites} "
              f"sites x {LM_PROMPT + LM_GEN} steps = {want}), plain calls "
              f"{plain} (want 0)")
        if sites:
            hybrid_launches = launches
        n_params = sum(q.numel() for q in res["params"].parameters())
        dI, nh, convd, N = S.dims(cfg)
        print(f"[ssm] (c) serve_lm.main --arch {arch} ({cfg.n_layers} SSD "
              f"layers, d_model {cfg.d_model}, d_inner {dI}, {nh} heads x "
              f"{cfg.ssm.head_dim}, d_state {N}"
              + (f"; a shared block at {sites} sites, {cfg.n_heads} heads x "
                 f"{cfg.hd}, GELU d_ff {cfg.d_ff}" if sites else "")
              + f"; vocab {cfg.vocab} padded to {cfg.vocab_padded}; "
              f"{n_params} parameters in {cfg.dtype}), batch {LM_BATCH}, "
              f"prompt {LM_PROMPT}, gen {LM_GEN}, seed {SEED}: prefill "
              f"{res['prefill_s']:.4f} s "
              f"({res['prefill_s'] / LM_PROMPT * 1e3:.3f} ms/step), decode "
              f"{res['ms_per_token']:.4f} ms/token/batch; "
              f"call wall {wall:.3f} s with the weights' init; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; flash "
              f"launches {launches}, plain calls {plain}; row 0 "
              f"{tokens[0].tolist()}")

        # (d) decode steps after the served ones, profiled, then split by
        # layer part, then one under sync-debug "warn"
        api, params, state = res["api"], res["params"], res["state"]
        cur = torch.argmax(logits, -1)[:, None]
        first = LM_PROMPT + LM_GEN - LM_PROFILED_STEPS

        def steps():
            with torch.inference_mode():
                for i in range(LM_PROFILED_STEPS):
                    api.decode_step(params, state, cur, first + i)
        steps()
        prof = profile_run(steps)
        handles = mark_ranges(
            [(block, SSM_RANGES[0]) for block in params.layers]
            + ([(params.shared, SSM_RANGES[1])] if sites else []))
        try:
            split = launches_in(profile_run(steps)["events"], SSM_RANGES)
        finally:
            for h in handles:
                h.remove()
        if prof["by_name"]:
            top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:8]
            print(f"[ssm] (d) {arch}: {LM_PROFILED_STEPS} profiled decode "
                  f"steps: wall {prof['wall_s']:.4f} s "
                  f"({prof['wall_s'] / LM_PROFILED_STEPS * 1e3:.3f} ms/step), "
                  f"device busy {prof['busy_s'] * 1e3:.4f} ms, device idle "
                  f"share {1 - prof['busy_s'] / prof['wall_s']:.5f}; device "
                  f"ms by name {({n: round(v / 1e3, 4) for n, v in top})}; "
                  f"kernels recorded {sum(prof['count'].values())}; flash "
                  f"device ms per recorded launch (sk = 41..48) "
                  f"{ {n: v for n, v in per_launch(prof).items()
                      if 'flash' in n} }")
        else:
            print(f"[ssm] (d) {arch}: device idle share not measured (the "
                  f"profiler recorded no device activity)")
        ssd, shared = split[SSM_RANGES[0]], split[SSM_RANGES[1]]
        outside = split["all"] - ssd - shared
        print(f"[ssm] (d) {arch}: kernel launches (host calls, a second "
              f"profiled run with a range around each SSD layer and each "
              f"shared-block call) per step "
              f"{split['all'] / LM_PROFILED_STEPS:.1f}; per SSD layer "
              f"{ssd / (LM_PROFILED_STEPS * cfg.n_layers):.2f}; per "
              f"shared-block call "
              + (f"{shared / (LM_PROFILED_STEPS * sites):.2f}" if sites
                 else "none")
              + f"; outside them {outside / LM_PROFILED_STEPS:.1f} per step")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with torch.inference_mode():
                    api.decode_step(params, state, cur, first)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [str(w.message).splitlines()[0] for w in caught
                 if "synchroniz" in str(w.message)]
        check(not syncs, f"{arch}: a decode step synchronises with the "
              f"host: {syncs[:3]}")
        print(f"[ssm] (d) {arch}: host syncs in one decode step under "
              f"sync-debug \"warn\": {len(syncs)}")
        del res, api, params, state, logits, prof
        torch.cuda.empty_cache()

    # (f) the flash kernel at zamba2's decode shape
    cfg = get_arch(HYBRID_ARCH)
    h, sk, d = LM_BATCH * cfg.n_heads, LM_PROMPT + LM_GEN + 1, cfg.hd
    frng = np.random.default_rng(SEED + 16)
    q = normal(frng, (h, 1, d), device)
    kk, vv = (normal(frng, (h, sk, d), device) for _ in range(2))
    e = close(fa.attention_kernel(q, kk, vv, True),
              fa.attention_plain(q, kk, vv, True), 3e-5, 3e-5,
              f"flash_attention h={h} sq=1 sk={sk} d={d}")
    print(f"[ssm] (f) flash_kernel against its plain version at h={h}, "
          f"sq=1, sk={sk}, d={d}, causal: max abs err {e} (limit 3e-5)")
    row = dict(time_flash(q, kk, vv, "ssm-times"), max_abs_err=e,
               launches=hybrid_launches)
    print(f"[ssm] card: {nvidia_smi()}")
    return row


# ---------------------------------------------------------------------------
# phase 17: the Whisper encoder-decoder (repro_torch.models.encdec)
# ---------------------------------------------------------------------------

AUDIO_ARCH = "whisper-base"
AUDIO_PROMPT, AUDIO_STEPS = 8, 4     # (a): prefill and decode steps
# (b): (sq, sk, causal) of the flash kernel on whisper's path at batch 4:
# the encoder over its 1500 frames, a decode step's cross-attention and
# self-attention (1..49 cached keys), api.prefill's cross-attention
AUDIO_FLASH_SHAPES = ((1500, 1500, False), (1, 1500, False), (1, 49, True),
                      (LM_PROMPT, 1500, False))
AUDIO_TIMED = ((1500, 1500, False), (1, 1500, False))


def whisper_runs(api, params, frames, toks):
    """The encoder's output, the decoder's logits over ``toks``, the loss,
    ``api.prefill``'s logits over the first ``AUDIO_PROMPT`` tokens, and
    ``AUDIO_STEPS`` decode steps from the encoder's output and caches the
    prompt was decoded into (``prefill``'s caches are exactly S long)."""
    import torch
    from repro_torch.models import encdec as E
    cfg = api.cfg
    B = toks.shape[0]
    P = AUDIO_PROMPT
    with torch.inference_mode():
        enc = E.encode(params, cfg, frames)
        logits = E.decode(params, cfg, toks, enc)[0]
        loss = api.loss(params, {"tokens": toks[:, :P],
                                 "targets": toks[:, 1:P + 1],
                                 "frames": frames})[0]
        pre, _ = api.prefill(params, {"tokens": toks[:, :P],
                                      "frames": frames})
        caches = E.init_caches(cfg, B, P + AUDIO_STEPS, frames.device)
        E.decode(params, cfg, toks[:, :P], enc, caches, 0)
        steps = [api.decode_step(params, (enc, caches),
                                 toks[:, t:t + 1], t)[0]
                 for t in range(P, P + AUDIO_STEPS)]
    return [x.cpu().float() for x in [enc, logits[..., :cfg.vocab], loss,
                                      pre[..., :cfg.vocab]]
            + [x[..., :cfg.vocab] for x in steps]]


def phase_whisper(device):
    """(a) the reduced whisper on the card against the CPU from the same
    parameters: float32 within the LM tolerance, bf16 no farther from the
    float32 CPU run than twice the CPU's own bf16 run; (b) the flash
    kernel at whisper-base's attention shapes against its plain version;
    (c) the full model through ``serve_lm.main`` with the flash counts
    read around it; (d) 8 profiled decode steps and the recomputed cross
    k and v timed alone; (e) the kernel's time at the encoder's and the
    cross-attention decode shape beside its plain version, its bound and
    SDPA."""
    import copy
    import warnings
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model
    print(f"[audio] card: {nvidia_smi()}")
    rng = np.random.default_rng(SEED + 17)

    # (a) reduced, the same weights in bf16 and float32, card against CPU
    cfg = get_arch(AUDIO_ARCH).reduced()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    api, api32 = build_model(cfg), build_model(cfg32)
    bf = api.init_params(torch.Generator().manual_seed(SEED))
    f32 = copy.deepcopy(bf).float()
    f32.cfg = cfg32
    frames = torch.from_numpy(rng.standard_normal(
        (LM_BATCH, cfg.encdec.enc_len, cfg.d_model)).astype(np.float32)
        * 0.02)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
        LM_BATCH, AUDIO_PROMPT + AUDIO_STEPS)).astype(np.int32))
    runs = {}
    for key, (a, params) in {("cpu", "bf16"): (api, bf),
                             ("card", "bf16"): (api, copy.deepcopy(bf)
                                                .to(device)),
                             ("cpu", "f32"): (api32, f32),
                             ("card", "f32"): (api32, copy.deepcopy(f32)
                                               .to(device))}.items():
        dev = params.embed.device
        fa.launches = fa.plain_calls = 0
        runs[key] = whisper_runs(a, params, frames.to(dev, params.embed.dtype),
                                 toks.to(dev))
        if key[0] == "card":
            check(fa.launches > 0 and fa.plain_calls == 0,
                  f"reduced {AUDIO_ARCH} {key[1]} on the card: flash "
                  f"launches {fa.launches}, plain calls {fa.plain_calls}")
    names = (["encode", "decode", "loss", "prefill"]
             + [f"step {t}" for t in range(AUDIO_STEPS)])
    errs = [close(g, c, LM_TOL, LM_TOL, f"reduced {AUDIO_ARCH} float32 "
                  f"{n}: card != CPU")
            for n, g, c in zip(names, runs["card", "f32"],
                               runs["cpu", "f32"])]
    dist = {dev: max(float((x - r).abs().max()) for x, r in zip(
        runs[dev, "bf16"], runs["cpu", "f32"])) for dev in ("cpu", "card")}
    check(dist["card"] <= 2 * dist["cpu"], f"reduced {AUDIO_ARCH} bf16: "
          f"the card's outputs are {dist['card']} from the float32 "
          f"model's, the CPU's {dist['cpu']}")
    print(f"[audio] (a) {AUDIO_ARCH} reduced (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} kv, "
          f"{cfg.encdec.n_enc_layers} + {cfg.n_layers} layers, "
          f"{cfg.encdec.enc_len} frames), batch {LM_BATCH}: encode, "
          f"decode, loss, api.prefill of {AUDIO_PROMPT} tokens and "
          f"{AUDIO_STEPS} decode steps, the same weights in float32 and "
          f"bf16: float32 card against CPU max abs err "
          f"{dict(zip(names, errs))} (limit {LM_TOL} + {LM_TOL} |x|); "
          f"bf16 max abs distance from the float32 CPU run, card "
          f"{dist['card']}, CPU {dist['cpu']} (the card's held to twice "
          f"the CPU's)")
    del runs, bf, f32

    # (b) the kernel at whisper-base's shapes, batch 4
    full = get_arch(AUDIO_ARCH)
    h, d = LM_BATCH * full.n_heads, full.hd
    cases, err = {}, 0.0
    for sq, sk, causal in AUDIO_FLASH_SHAPES:
        q = normal(rng, (h, sq, d), device)
        k, v = (normal(rng, (h, sk, d), device) for _ in range(2))
        e = close(fa.attention_kernel(q, k, v, causal),
                  fa.attention_plain(q, k, v, causal), 3e-5, 3e-5,
                  f"flash_attention h={h} sq={sq} sk={sk} d={d} "
                  f"causal={causal}")
        cases[sq, sk, causal], err = (q, k, v), max(err, e)
    print(f"[audio] (b) flash_kernel against its plain version on the card "
          f"at h={h}, d={d}, (sq, sk, causal) in {AUDIO_FLASH_SHAPES}: max "
          f"abs err {err} (limit 3e-5)")
    torch.cuda.empty_cache()

    # (c) the full model through serve_lm.main: every count at 0 just
    # before, read just after
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.plain_calls = 0
    t0 = time.perf_counter()
    res = serve_lm.main(["--arch", AUDIO_ARCH, "--batch", str(LM_BATCH),
                         "--prompt-len", str(LM_PROMPT), "--gen",
                         str(LM_GEN), "--seed", str(SEED),
                         "--device", str(device)])
    wall = time.perf_counter() - t0
    launches, plain = fa.launches, fa.plain_calls
    tokens, logits = res["tokens"], res["logits"]
    n_enc = full.encdec.n_enc_layers
    want = n_enc + 2 * full.n_layers * (LM_PROMPT + LM_GEN)
    check(tokens.shape == (LM_BATCH, LM_GEN) and tokens.min() >= 0
          and tokens.max() < full.vocab, f"serve_lm {AUDIO_ARCH} tokens out "
          f"of the vocab or misshapen: {tokens.shape}")
    check(logits.device.type == device.type and bool(torch.isfinite(
        logits[:, :full.vocab].float()).all()),
          f"serve_lm {AUDIO_ARCH}'s last logits are not finite on the card")
    check(launches == want and plain == 0,
          f"serve_lm {AUDIO_ARCH}: flash launches {launches} (want {n_enc} "
          f"+ 2 x {full.n_layers} x {LM_PROMPT + LM_GEN} = {want}), plain "
          f"calls {plain} (want 0)")
    n_params = sum(q.numel() for q in res["params"].parameters())
    print(f"[audio] (c) serve_lm.main --arch {AUDIO_ARCH} ({n_enc} encoder "
          f"+ {full.n_layers} decoder layers, d_model {full.d_model}, "
          f"{full.n_heads} heads x {d}, GELU d_ff {full.d_ff}, "
          f"{full.encdec.enc_len} stub frames, vocab {full.vocab} padded to "
          f"{full.vocab_padded}; {n_params} parameters in {full.dtype}), "
          f"batch {LM_BATCH}, prompt {LM_PROMPT}, gen {LM_GEN}, seed {SEED}:"
          f" prefill {res['prefill_s']:.4f} s (the encoder included), "
          f"decode {res['ms_per_token']:.4f} ms/token/batch; call wall "
          f"{wall:.3f} s with the weights' init; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; flash "
          f"launches {launches}, plain calls {plain}; row 0 "
          f"{tokens[0].tolist()}")

    # (d) decode steps after the served ones, profiled, then split by
    # decoder layer, then one under sync-debug "warn"
    api, params, state = res["api"], res["params"], res["state"]
    cur = torch.argmax(logits, -1)[:, None]
    first = LM_PROMPT + LM_GEN - LM_PROFILED_STEPS

    def steps():
        with torch.inference_mode():
            for i in range(LM_PROFILED_STEPS):
                api.decode_step(params, state, cur, first + i)
    steps()
    prof = profile_run(steps)
    handles = mark_ranges([(layer, RANGES[0]) for layer in params.dec_layers])
    try:
        split = launches_in(profile_run(steps)["events"], RANGES[:1])
    finally:
        for hd in handles:
            hd.remove()
    if prof["by_name"]:
        top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:8]
        print(f"[audio] (d) {LM_PROFILED_STEPS} profiled decode steps: wall "
              f"{prof['wall_s']:.4f} s "
              f"({prof['wall_s'] / LM_PROFILED_STEPS * 1e3:.3f} ms/step), "
              f"device busy {prof['busy_s'] * 1e3:.4f} ms "
              f"({prof['busy_s'] / LM_PROFILED_STEPS * 1e3:.4f} ms/step), "
              f"device idle share {1 - prof['busy_s'] / prof['wall_s']:.5f}"
              f"; device ms by name "
              f"{({n: round(v / 1e3, 4) for n, v in top})}; kernels "
              f"recorded {sum(prof['count'].values())}; flash device ms "
              f"per recorded launch "
              f"{ {n: v for n, v in per_launch(prof).items()
                  if 'flash' in n} }")
    else:
        print("[audio] (d) device idle share not measured (the profiler "
              "recorded no device activity)")
    layer_launches = split[RANGES[0]]
    print(f"[audio] (d) kernel launches (host calls) per step "
          f"{split['all'] / LM_PROFILED_STEPS:.1f}; per decoder layer "
          f"{layer_launches / (LM_PROFILED_STEPS * full.n_layers):.2f}; "
          f"outside them "
          f"{(split['all'] - layer_launches) / LM_PROFILED_STEPS:.1f} per "
          f"step")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with torch.inference_mode():
                api.decode_step(params, state, cur, first)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the first use of the mode also warns that it is a prototype
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)
             and "prototype" not in str(w.message)]
    check(not syncs, f"{AUDIO_ARCH}: a decode step synchronises with the "
          f"host: {syncs[:3]}")
    print(f"[audio] (d) host syncs in one decode step under sync-debug "
          f"\"warn\": {len(syncs)}")
    # the cross-attention's k and v, recomputed from the encoder's output
    # in every layer and step (the reference keeps no cache of them)
    enc_out = state[0]
    kv = [(layer.cross_attn["wk"], layer.cross_attn["wv"])
          for layer in params.dec_layers]
    with torch.inference_mode():
        kv_ms = time_ms(lambda: [(enc_out @ wk, enc_out @ wv)
                                 for wk, wv in kv])
    T_enc, D = enc_out.shape[1], full.d_model
    kv_flop = 2 * 2 * LM_BATCH * T_enc * D * D * full.n_layers
    print(f"[audio] (d) the cross-attention's k and v recomputed per decode "
          f"step ({full.n_layers} layers x 2 GEMMs of ({LM_BATCH}x{T_enc}x"
          f"{D}) @ ({D}x{D}), {kv_flop / 1e9:.2f} GFLOP in {full.dtype}): "
          f"{kv_ms:.4f} ms a step by events, "
          f"{kv_flop / (kv_ms * 1e-3) / 1e12:.1f} TFLOP/s")
    del res, api, params, state, logits, prof, enc_out, kv
    torch.cuda.empty_cache()

    # (e) the kernel's times at the encoder's shape and the cross-attention
    # decode shape
    rows = {c: time_flash(*cases[c], "audio-times", causal=c[2])
            for c in AUDIO_TIMED}
    print(f"[audio] card: {nvidia_smi()}")
    return {name: dict(rows[c], max_abs_err=err, launches=launches)
            for name, c in (("flash_attention whisper encoder",
                             AUDIO_TIMED[0]),
                            ("flash_attention whisper cross decode",
                             AUDIO_TIMED[1]))}

# ---------------------------------------------------------------------------
# phase 18: training on the card — the flash backward, the trainer
# ---------------------------------------------------------------------------

TRAIN_ARCH = "minicpm-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 6
TRAIN_PROFILED = (4, 5)          # the steps profiled in (c)
# The backward's shapes are repro_torch.bench_flash.BWD_SHAPES: every shape
# training reaches, batch 4. max |kernel - autograd of the plain version| /
# max |plain|: float32-grade products (three TF32 passes on the tensor
# cores, about 2^-21 relative a product; ex2.approx, other sums' order);
# bfloat16 outputs round to 8 bits and the Function's D uses the rounded o
BWD_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_TOL = 1e-5                   # natural-log units, against logsumexp
TRAIN_CPU_STEPS = 2
TRAIN_REDUCED_BATCH, TRAIN_REDUCED_SEQ = 2, 32
# card against CPU after TRAIN_CPU_STEPS AdamW steps (wsd, lr 6e-5 then
# 1.2e-4): an entry whose gradient is near zero may take Adam's
# sign-like step the other way, at most 2 x (6e-5 + 1.2e-4); such entries
# must stay a rare few (TRAIN_PARAM_FRAC of all beyond 1e-6)
TRAIN_PARAM_TOL = 3.6e-4
TRAIN_PARAM_FRAC = 1e-3


def phase_train_bwd(device):
    """(a) the three backward kernels against autograd of the plain version
    at every shape training reaches, float32 and bf16, twice (bit-equal),
    the forward's lse against logsumexp; times in float32 (the path's
    dtype: the LM hands attention float32 q, k, v), each beside two
    bounds (the products on the FP32 units and on the TF32 tensor cores
    in three passes), SDPA's backward alone and its forward + backward."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.bench_flash import BWD_SHAPES, bwd_work
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    rng = np.random.default_rng(SEED + 18)
    rows, kernel_rows = [], {}
    for label, h, sq, sk, d, causal in BWD_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).removeprefix("torch.")
            q = normal(rng, (h, sq, d), device, dt)
            k, v = (normal(rng, (h, sk, d), device, dt) for _ in range(2))
            do = normal(rng, (h, sq, d), device, dt)
            o, lse = fa.attention_lse_kernel(q, k, v, causal)
            got = fa.attention_backward_kernel(q, k, v, o, lse, do, causal)
            again = fa.attention_backward_kernel(q, k, v, o, lse, do, causal)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"flash backward {label} {name}: two runs differ")
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            want = torch.autograd.grad(
                ref.flash_attention(*leaves, causal=causal), leaves, do)
            errs = [float((a.float() - b.float()).abs().max()
                          / b.float().abs().max())
                    for a, b in zip(got, want)]
            check(all(e <= BWD_REL_TOL[name] for e in errs)
                  and all(bool(torch.isfinite(a).all()) for a in got),
                  f"flash backward {label} {name}: max |d| / max |ref| of "
                  f"dq, dk, dv {errs} (limit {BWD_REL_TOL[name]})")
            _, lse_ref = ref.flash_attention_lse(q, k, v, causal)
            e_lse = float((lse - lse_ref).abs().max())
            check(e_lse <= LSE_TOL, f"flash lse {label} {name}: max abs err "
                  f"{e_lse} against logsumexp (limit {LSE_TOL})")
            print(f"[train] (a) {label}, h={h} sq={sq} sk={sk} d={d} "
                  f"{'causal' if causal else 'non-causal'} {name}: "
                  f"max |d| / max |ref| dq {errs[0]:.3e}, dk {errs[1]:.3e}, "
                  f"dv {errs[2]:.3e} (limit {BWD_REL_TOL[name]}); lse max "
                  f"abs err {e_lse:.3e}; two runs bit-identical")
            if dt != torch.float32:
                continue
            pairs = allowed_pairs(h, sq, sk, causal)
            # q, o, dO, k, v and lse read once; dq, dk, dv written once
            work = bwd_work(h, sq, sk, d, causal)["backward"]
            b32, by32 = dense_bound(*work, FP32_FLOP_PER_S)
            b_ms, b_by = dense_bound(*work, TF32X3_FLOP_PER_S)
            ms = time_ms(lambda: fa.attention_backward_kernel(
                q, k, v, o, lse, do, causal))
            fwd_ms = time_ms(lambda: fa.attention_lse_kernel(q, k, v, causal))
            plain_ms = time_ms(lambda: fa.attention_backward_plain(
                q, k, v, o, lse, do, causal), reps=5, warm=1)
            sq_ = [t.clone().requires_grad_() for t in (q, k, v)]
            c = causal and sq == sk

            def sdpa():
                out = F.scaled_dot_product_attention(
                    sq_[0][None], sq_[1][None], sq_[2][None], is_causal=c)
                torch.autograd.grad(out, sq_, do[None])
            lib_ms = time_ms(sdpa, reps=10)
            # SDPA's backward alone: its forward once, then the gradient
            out = F.scaled_dot_product_attention(
                sq_[0][None], sq_[1][None], sq_[2][None], is_causal=c)
            lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
                out, sq_, do[None], retain_graph=True), reps=10)
            del out
            row = dict(label=label, ms=ms, fwd_ms=fwd_ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32,
                       library_ms=lib_ms, library_bwd_ms=lib_bwd_ms)
            rows.append(row)
            print(f"[train] (a) times f32 {label}: backward (3 kernels) "
                  f"{ms:.4f} ms, forward with lse {fwd_ms:.4f} ms, "
                  f"forward + backward {fwd_ms + ms:.4f} ms; plain backward "
                  f"{plain_ms:.4f} ms; SDPA backward alone {lib_bwd_ms:.4f} "
                  f"ms, forward + backward {lib_ms:.4f} ms (is_causal={c}); "
                  f"backward bound (5 products of 2 sq sk d over {pairs} "
                  f"pairs) {b32:.5f} ms ({by32}) at 67 TFLOP/s, share "
                  f"{b32 / ms:.3f}; {b_ms:.5f} ms ({b_by}) at 3xTF32 165 "
                  f"TFLOP/s, share {b_ms / ms:.3f}; backward / SDPA's "
                  f"{ms / lib_bwd_ms:.3f}; kernels' forward + backward / "
                  f"SDPA {(fwd_ms + ms) / lib_ms:.3f}")
            if label == BWD_SHAPES[0][0]:
                kernel_rows = bwd_kernel_rows(q, k, v, o, lse, do, causal)
            del q, k, v, do, o, lse, got, again, want, leaves, sq_
            torch.cuda.empty_cache()
    return rows, kernel_rows


def bwd_kernel_rows(q, k, v, o, lse, do, causal):
    """Each backward kernel alone at minicpm-2b's shape: events time
    against its plain counterpart, its bounds (FP32 units and 3xTF32; the
    row's ``bound_ms`` is the 3xTF32 one, the least time) and, for the
    preprocess, the one PyTorch call computing the same function
    (``linalg.vecdot``)."""
    import torch
    from repro_torch.bench_flash import bwd_work
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    h, sq, d = q.shape
    sk = k.shape[1]
    dq_p, dk_p, dv_p = ref.flash_attention_backward(q, k, v, o, lse, do,
                                                    causal)
    delta = fa.bwd_preprocess_kernel(o, do)
    delta_p = (do.float() * o.float()).sum(-1)
    dk, dv = fa.bwd_dkdv_kernel(q, k, v, do, lse, delta, causal)
    dq = fa.bwd_dq_kernel(q, k, v, do, lse, delta, causal)
    err = lambda a, b: float((a.float() - b.float()).abs().max())  # noqa
    plain_ms = time_ms(lambda: ref.flash_attention_backward(
        q, k, v, o, lse, do, causal), reps=5, warm=1)
    work = bwd_work(h, sq, sk, d, causal)
    cases = {
        "flash_bwd_preprocess": (
            lambda: fa.bwd_preprocess_kernel(o, do),
            time_ms(lambda: (do.float() * o.float()).sum(-1)),
            time_ms(lambda: torch.linalg.vecdot(do, o)),
            err(delta, delta_p)),
        "flash_bwd_dkdv": (
            lambda: fa.bwd_dkdv_kernel(q, k, v, do, lse, delta, causal),
            plain_ms, None, max(err(dk, dk_p), err(dv, dv_p))),
        "flash_bwd_dq": (
            lambda: fa.bwd_dq_kernel(q, k, v, do, lse, delta, causal),
            plain_ms, None, err(dq, dq_p))}
    out = {}
    for name, (fn, p_ms, lib_ms, e) in cases.items():
        ms = time_ms(fn)
        b32, by32 = dense_bound(*work[name], FP32_FLOP_PER_S)
        b_ms, b_by = dense_bound(*work[name], TF32X3_FLOP_PER_S)
        out[name] = dict(ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, max_abs_err=e)
        print(f"[train] (a) {name} alone, h={h} sq={sq} sk={sk} d={d} f32: "
              f"{ms:.4f} ms, plain {p_ms:.4f} ms, bound {b32:.5f} ms "
              f"({by32}) at 67 TFLOP/s, share {b32 / ms:.3f}; {b_ms:.5f} ms "
              f"({b_by}) at 3xTF32, share {b_ms / ms:.3f}; library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, max abs "
              f"err against plain {e:.3e}")
    return out


def train_run(cfg, tree, device, compress):
    """TRAIN_CPU_STEPS of ``make_step`` from the reference-layout ``tree``
    on ``device``: losses, gnorms and the parameters after."""
    import numpy as np
    import torch
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models.api import build_model
    from repro_torch.optim import grad_compress
    from repro_torch.optim.adamw import AdamW
    api = build_model(cfg)
    params = lm_params_from_reference(tree, cfg, device)
    leaves = list(params.parameters())
    opt = AdamW(lr=train.schedule("wsd", 3e-4, TRAIN_CPU_STEPS))
    state = opt.init(leaves)
    err = grad_compress.init_error(leaves) if compress else None
    step = train.make_step(api, opt, compress)
    pipe = TokenPipeline(DataCfg(cfg.vocab, TRAIN_REDUCED_SEQ,
                                 TRAIN_REDUCED_BATCH, seed=SEED))
    losses, gnorms = [], []
    for i in range(TRAIN_CPU_STEPS):
        batch = train.make_batch(cfg, pipe, i, TRAIN_REDUCED_BATCH, device)
        params, state, err, m = step(params, state, err, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    return (np.array(losses), np.array(gnorms),
            [p.detach().cpu() for p in params.parameters()])


def phase_train(device):
    """Phase 18: (a) the flash backward kernels; (b) reduced train steps on
    the card against the CPU; (c) minicpm-2b at full width through
    ``launch.train.main``; (d) a resume at reduced size on the card."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.models.api import build_model

    rows, kernel_rows = phase_train_bwd(device)

    # (b) 2 steps on the card against the CPU, float32, one set of params
    for arch in (TRAIN_ARCH, AUDIO_ARCH):
        cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
        tree = lm_params_to_reference(build_model(cfg).init_params(
            torch.Generator("cpu").manual_seed(SEED)), cfg)
        for compress in (False, True):
            lc, gc, pc = train_run(cfg, tree, torch.device("cpu"), compress)
            lg, gg, pg = train_run(cfg, tree, device, compress)
            dp = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
            n_off = sum(int(((a - b).abs() > 1e-6).sum())
                        for a, b in zip(pc, pg))
            n_all = sum(a.numel() for a in pc)
            e_loss = float(np.abs(lg / lc - 1).max())
            e_gn = float(np.abs(gg / gc - 1).max())
            check(np.isfinite(lg).all() and e_loss <= 1e-5 and e_gn <= 1e-4
                  and dp <= TRAIN_PARAM_TOL
                  and n_off <= TRAIN_PARAM_FRAC * n_all,
                  f"train step {arch} compress={compress}: card vs CPU "
                  f"loss rel {e_loss}, gnorm rel {e_gn}, params max abs "
                  f"{dp}, {n_off} of {n_all} entries beyond 1e-6 (limits "
                  f"1e-5, 1e-4, {TRAIN_PARAM_TOL}, {TRAIN_PARAM_FRAC})")
            print(f"[train] (b) {arch} reduced float32, {TRAIN_CPU_STEPS} "
                  f"make_step steps, batch {TRAIN_REDUCED_BATCH} x "
                  f"{TRAIN_REDUCED_SEQ}, grad compression {compress}: "
                  f"losses card {lg.tolist()} CPU {lc.tolist()} (rel "
                  f"{e_loss:.3e}), gnorm rel {e_gn:.3e}, parameters max abs "
                  f"diff {dp:.3e} ({n_off} of {n_all} entries beyond 1e-6)")

    # (c) minicpm-2b at full width through the trainer's entry point
    full = get_arch(TRAIN_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    marks, prof = {}, {}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        marks[step] = time.perf_counter()
        # the profiler starts a step early, so that its start-up lands
        # in a step outside the window read below
        if step == TRAIN_PROFILED[0] - 2:
            from torch.profiler import ProfilerActivity, profile
            prof["p"] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            prof["p"].start()
        elif step == TRAIN_PROFILED[-1]:
            prof["p"].stop()
    fa.launches = fa.plain_calls = fa.backward_plain_calls = 0
    fa.bwd_preprocess_launches = fa.bwd_dkdv_launches = \
        fa.bwd_dq_launches = 0
    t0 = time.perf_counter()
    losses = train.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                         "--batch", str(TRAIN_BATCH), "--seq",
                         str(TRAIN_SEQ), "--log-every", "1", "--seed",
                         str(SEED), "--device", str(device)],
                        on_step=on_step)
    wall = time.perf_counter() - t0
    counts = {"flash_kernel": fa.launches,
              "flash_bwd_preprocess": fa.bwd_preprocess_launches,
              "flash_bwd_dkdv": fa.bwd_dkdv_launches,
              "flash_bwd_dq": fa.bwd_dq_launches}
    plain = (fa.plain_calls, fa.backward_plain_calls)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = full.n_layers * TRAIN_STEPS
    check(len(losses) == TRAIN_STEPS and np.isfinite(losses).all(),
          f"train {TRAIN_ARCH}: losses {losses}")
    check(all(n == want for n in counts.values()) and plain == (0, 0),
          f"train {TRAIN_ARCH}: launches {counts} (want {want} each: "
          f"{full.n_layers} layers x {TRAIN_STEPS} steps), plain calls "
          f"{plain} (want 0)")
    dts = [marks[i] - marks[i - 1] for i in range(1, TRAIN_STEPS)]
    # steps 1 .. before the profiler's start (step 0 warms up)
    steady = float(np.median(dts[:TRAIN_PROFILED[0] - 2]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[train] (c) launch.train.main --arch {TRAIN_ARCH} (full width: "
          f"{full.n_layers} layers, d_model {full.d_model}, {full.n_heads} "
          f"heads x {full.hd}, d_ff {full.d_ff}, vocab {full.vocab}, "
          f"{full.dtype}), batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
          f"{TRAIN_STEPS} steps, wsd: losses {losses}; step s "
          f"{[round(x, 4) for x in dts]} (steps 1..{TRAIN_STEPS - 1}; "
          f"steps {TRAIN_PROFILED[0] - 1}.. under the profiler); "
          f"median of steps 1..{TRAIN_PROFILED[0] - 2} "
          f"{steady:.4f} s/step, {tokens / steady:.1f} tokens/s; call wall "
          f"{wall:.2f} s with the init; peak memory {peak:.2f} GiB; "
          f"launches {counts} ({want // TRAIN_STEPS} a step each), plain "
          f"calls {plain}")
    # the window: from the first profiled step's forward range on (each
    # step ends in the hook's synchronise, so the steps before it have
    # finished on the device), against the host clock between the hooks
    from torch.autograd import DeviceType
    events = prof["p"].events()
    n_prof = len(TRAIN_PROFILED)
    since = sorted(e.time_range.start for e in events
                   if e.name == train.RANGES[0]
                   and e.device_type == DeviceType.CPU)[-n_prof]
    window = [e for e in events if e.time_range.start >= since]
    summary = profile_summary(window, marks[TRAIN_PROFILED[-1]]
                              - marks[TRAIN_PROFILED[0] - 1])
    split = launches_in(window, train.RANGES)
    if summary["by_name"]:
        top = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:10]
        print(f"[train] (c) steps {TRAIN_PROFILED} profiled: wall "
              f"{summary['wall_s']:.4f} s, device busy "
              f"{summary['busy_s']:.4f} s, device idle share "
              f"{1 - summary['busy_s'] / summary['wall_s']:.5f} (the "
              f"profiler's host work inflates the wall; against the "
              f"unprofiled {steady:.4f} s/step: "
              f"{1 - summary['busy_s'] / n_prof / steady:.5f}); device ms "
              f"by name {({n: round(v / 1e3, 3) for n, v in top})}; "
              f"kernels recorded {sum(summary['count'].values())}")
        flash = {n: round(v / 1e3, 3)
                 for n, v in summary["by_name"].items() if "flash" in n}
        print(f"[train] (c) flash kernels' device ms over steps "
              f"{TRAIN_PROFILED}: {flash}")
    else:
        print("[train] (c) device idle share not measured (the profiler "
              "recorded no device activity)")
    print(f"[train] (c) kernel launches (host calls) a step "
          f"{split['all'] / n_prof:.1f}: forward "
          f"{split[train.RANGES[0]] / n_prof:.1f}, backward "
          f"{split[train.RANGES[1]] / n_prof:.1f}, optimizer "
          f"{split[train.RANGES[2]] / n_prof:.1f}, outside them "
          f"{(split['all'] - sum(map(split.get, train.RANGES))) / n_prof:.1f}")
    del summary, prof, events, window
    torch.cuda.empty_cache()

    train_resume(device)
    print(f"[train] card: {nvidia_smi()}")
    return rows, kernel_rows, counts


def train_resume(device):
    """Phase 18 (d): a resume at reduced size, 6 steps uninterrupted
    against 4 steps (a checkpoint at step 2) and a restart to 6."""
    import json
    import tempfile
    import numpy as np
    from repro_torch.checkpoint import ckpt as C
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory() as tmp:
        args = ["--arch", TRAIN_ARCH, "--reduced", "--batch", "4", "--seq",
                "64", "--save-every", "2", "--log-every", "1", "--seed",
                str(SEED), "--device", str(device)]
        a_dir, b_dir = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        whole = train.main(args + ["--steps", "6", "--ckpt-dir", a_dir])
        train.main(args + ["--steps", "4", "--ckpt-dir", b_dir])
        check(C.Checkpointer(b_dir).latest_step() == 2,
              "train resume: the 4-step run left no checkpoint at step 2")
        resumed = train.main(args + ["--steps", "6", "--ckpt-dir", b_dir])
        check(len(resumed) == 3, f"train resume: {len(resumed)} steps "
              f"after the restart (want steps 3-5)")
        blobs = [open(os.path.join(d, "step_00000004", "data.msgpack.zst"),
                      "rb").read() for d in (a_dir, b_dir)]
        same_ckpt = blobs[0] == blobs[1]
        same_loss = resumed == whole[3:]
        dmax = 0.0
        if not same_ckpt:
            flat = [C.unpackb(C._ZD.decompress(b) if b[:4] == C.ZSTD_MAGIC
                              else b) for b in blobs]
            man = json.load(open(os.path.join(a_dir, "step_00000004",
                                              "manifest.json")))["tensors"]
            for key, meta in man.items():
                a, b = (C._decode_array(f[key], meta["dtype"], meta["shape"])
                        for f in flat)
                dmax = max(dmax, float((a.double() - b.double()).abs().max()))
        check(same_loss or np.allclose(resumed, whole[3:], rtol=1e-5),
              f"train resume: steps 3-5 {resumed} against the uninterrupted "
              f"{whole[3:]}")
        print(f"[train] (d) {TRAIN_ARCH} reduced, batch 4 x 64, bf16: "
              f"uninterrupted losses {whole}; restarted at step 3 from the "
              f"step-2 checkpoint: {resumed}; losses bit-equal {same_loss}; "
              f"step-4 checkpoints byte-equal {same_ckpt}"
              + ("" if same_ckpt else f" (max abs diff {dmax:.3e})"))


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
    del ins
    lm_row = phase_lm(device)
    moe_rows = phase_moe(device)
    ssm_row = phase_ssm(device)
    audio_rows = phase_whisper(device)
    train_rows, bwd_rows, train_launches = phase_train(device)

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
    kernels.append({
        "name": "flash_attention lm decode", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:68",
        "launches": lm_row["launches"],
        "max_abs_err": lm_row["max_abs_err"], "ms": lm_row["ms"],
        "plain_ms": lm_row["plain_ms"], "bound_ms": lm_row["bound_ms"],
        "bound_by": lm_row["bound_by"], "library_ms": lm_row["library_ms"]})
    moe_rows["flash_attention hybrid decode d80"] = ssm_row
    moe_rows.update(audio_rows)
    for kname, r in moe_rows.items():
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:68",
            "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    for kname, r in bwd_rows.items():
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:68",
            "launches": train_launches[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print("[train] flash backward f32 by shape (ms): " + "; ".join(
        f"{r['label']}: {r['ms']:.4f} (bound {r['bound_fp32_ms']:.4f} FP32 "
        f"units, {r['bound_ms']:.4f} 3xTF32; plain {r['plain_ms']:.4f}; SDPA "
        f"bwd {r['library_bwd_ms']:.4f}, fwd+bwd {r['library_ms']:.4f}; ours "
        f"fwd+bwd {r['fwd_ms'] + r['ms']:.4f})" for r in train_rows))
    print(nvidia_smi())                  # name, power limit: a line alone
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
