"""Times the port's CUDA kernels on the card, one JSON row per kernel and
shape.

Run on a machine with one NVIDIA card, from the repository root:

    python3 src/repro_torch/bench_kernels.py [--src DIR] [--only CASES]

It builds the kernels of ``DIR/repro_torch`` (the ``src`` directory beside
this file unless ``--src`` names another, so that one run can time two
versions of the kernels on one card, in turns), runs the cases ``--only``
names (all by default) and prints one JSON line a row, then the card's name
and power limit. Inputs are made from a seed. The card's peaks are this
file's own tree's (``roofline.analysis``), whichever tree ``--src`` names,
so that a bound depends on the shape alone. Each row first holds the
kernel's result against its plain PyTorch version on the same inputs
(``max_abs_err``, within the limit the case names, or the run fails), then
gives:

- ``ms``: CUDA events over ``REPS`` warm calls, wrapper included, a call;
- ``plain_ms``: the plain version's time; ``library_ms``: one PyTorch call
  that computes the same function (a yardstick only; null where none does);
- ``bound_ms``, ``bound_by``: the least time the card could take, the
  larger of the bytes (each input read once, each output written once) over
  ``roofline.analysis.HBM_BW`` and the operations over the family's rate,
  also from ``roofline.analysis`` (:func:`bound`);
- ``launches``: the kernel's launches on the port's own paths, from the
  ``path`` run (null where it did not run);
- where a kernel is short enough that its events time holds the wrapper's
  host work, ``device_ms``: the profiler's device time a call.

``--only`` names the cases and ``path``:

- ``path``: counts each kernel's launches (``COUNTERS``) over one run of
  each of the port's own paths, first: ``launch.train.main`` for minicpm-2b
  at full width (``PATH_TRAIN``: 40 layers x 6 steps on the bf16 flash
  route, the optimizer's kernels over its 362 leaves), PolyBench gemm
  MEDIUM and a flush of ``PATH_FFT`` fft requests through
  ``Engine(backend="cuda")``, and one call of each ``kernels.ops`` function
  at the cases' shapes. It times and checks nothing; the ``gpu`` tests hold
  what each path computes and which kernels it takes.
- ``lanes``: ``fabric_reduce_lanes`` on PolyBench gemm MEDIUM's lane grid
  (``mac3``, 14,800 lanes of 240) and the one-shot mix's ``fft`` grid (256
  lanes of 4096); bit-exact.
- ``stream``: ``fabric_stream`` relu at n = 2^24 beside ``torch.relu``,
  over a rotation of ``ROTATE`` input and output sets (512 MB) that the
  card's 50 MB L2 cannot hold; bit-exact.
- ``f32``: ``stream_matmul`` in float32 at ``MM`` (minicpm-2b's gate/up
  projection over 4,096 tokens) beside ``torch.matmul``, TF32 off; within
  1e-5 of max|C|.
- ``bf16``: the bfloat16 product at ``MM`` (the ``wgmma`` route), with A
  one element past 16-byte alignment (S1) and at ``MM_HEAD`` (S2,
  granite-moe-3b-a800m's LM head at its unpadded vocabulary), both on the
  ``wgmma_realign`` route; a float32 result within 1e-4 of max|C| and a
  bfloat16 one (``bf16_out_ms``) one rounding more; ``torch.matmul`` on the
  same tensors (bfloat16 out).
- ``conv``: ``stream_conv2d`` on a 4096 x 4096 frame beside ``F.conv2d``;
  within 1e-4 + 1e-3 |x|.
- ``flash``: the forward kernel in float32 at ``FLASH_SHAPES`` beside SDPA
  (checked to compute the same function); within 3e-5.
- ``flash_bwd``: the three backward kernels in float32 at ``BWD_SHAPES``
  and, at the first, each alone, beside SDPA's backward; dq, dk, dv within
  1e-4 of max |plain|, D within 1e-5 of max |D|.
- ``flash_bf16``: bfloat16 attention at ``BF16_SHAPES`` (the benchmark
  cells' and decode, on the route ``flash_attention.tc_route`` picks): the
  forward with lse, the backward and each backward kernel; the output within
  2^-7 and the gradients within 2e-2 of max |plain|, and under
  ``agreement`` :func:`route_agreement`'s shares.
- ``adamw``: the optimizer's kernels over minicpm-2b's 362 bf16 leaves with
  float32 moments: the update with a clipping scale beside the eager clip
  and update and ``torch.optim.AdamW(fused=True)`` (bf16 moments, its own
  arithmetic), bit-equal to the plain loop over the first
  ``ADAMW_CHECKED`` leaves; the norm beside the plain sum and
  ``torch._foreach_norm``, within 1e-5 of it.
"""
from __future__ import annotations

import argparse
import importlib
import itertools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":      # a script: this tree's package, for RA alone
    sys.path.insert(0, HERE)
from repro_torch.roofline import analysis as RA  # noqa: E402  the peaks

SEED = 0
REPS = 20
ROTATE = 4                     # input and output sets of a rotated loop
MM = (4096, 2304, 5760)
MM_HEAD = (4096, 1536, 49155)  # granite-moe-3b-a800m's unpadded LM head
CONV = (4096, 4096)
# (label, heads, sq, sk, d, causal): minicpm-2b at 4k context and the
# other head widths, then the serving paths' shapes at batch 4 (2 for
# internvl2): decode of one query, internvl2's 256 patches + 32 tokens,
# whisper-base's encoder and its cross-attention
FLASH_SHAPES = (("minicpm-2b 4k", 36, 4096, 4096, 64, True),
                ("d80 4k", 32, 4096, 4096, 80, True),
                ("d128 4k", 32, 4096, 4096, 128, True),
                ("minicpm-2b decode", 144, 1, 49, 64, True),
                ("granite-moe decode", 96, 1, 48, 64, True),
                ("internvl2-76b prefill", 128, 288, 288, 128, True),
                ("zamba2-2.7b decode", 128, 1, 49, 80, True),
                ("whisper-base encoder", 32, 1500, 1500, 64, False),
                ("whisper-base cross decode", 32, 1, 1500, 64, False))
# every shape float32 training reaches, batch 4
BWD_SHAPES = (("minicpm-2b", 4 * 36, 512, 512, 64, True),
              ("zamba2-2.7b shared block", 4 * 32, 512, 512, 80, True),
              ("internvl2-76b heads (d 128, batch 1)", 64, 512, 512, 128,
               True),
              ("whisper-base encoder", 4 * 8, 1500, 1500, 64, False),
              ("whisper-base cross-attention", 4 * 8, 512, 1500, 64, False))
# the benchmark cells' attention (each layer's heads times the batch), and
# decode
BF16_SHAPES = (("minicpm-2b.train-4k", 36, 4096, 4096, 64, True),
               ("granite-3.0-3b-a800m.train-2x2048", 2 * 24, 2048, 2048, 64,
                True),
               ("minicpm-2b.train-512", 4 * 36, 512, 512, 64, True),
               ("minicpm-2b decode", 4 * 36, 1, 49, 64, True))
# bf16 passes of 2 d flop a pair on the route: the forward S and O = PV
# (three pieces of P); dkdv S^T, dP^T, dV and dK; dq S, dP and dQ; the
# backward's least work S, dP, dV, dQ, dK
TC_PASSES = {"forward": 4, "flash_bwd_dkdv": 8, "flash_bwd_dq": 5,
             "backward": 11}
# the path run: arch, batch, seq, steps of the trainer; PolyBench gemm
# MEDIUM (NI, NJ, NK); fft requests and their length in one flush
PATH_TRAIN = ("minicpm-2b", 4, 512, 6)
PATH_GEMM = (200, 220, 240)
PATH_FFT = (256, 4096)
# each kernel's launch counter: a module of repro_torch.kernels and its
# attribute; the float32 flash kernels' counters count both routes, and
# :func:`counts` takes the bf16 route's (``*_tc``) out of them
COUNTERS = {
    "fabric_reduce_lanes": ("fabric_reduce", "launches"),
    "fabric_stream": ("fabric_stream", "launches"),
    "stream_matmul sgemm": ("stream_matmul", "sgemm_launches"),
    "stream_matmul wgmma": ("stream_matmul", "wgmma_launches"),
    "stream_matmul wgmma_realign": ("stream_matmul",
                                    "wgmma_realign_launches"),
    "stream_conv2d": ("stream_conv2d", "launches"),
    "flash_kernel": ("flash_attention", "launches"),
    "flash_kernel_tc": ("flash_attention", "tc_launches"),
    "flash_bwd_preprocess": ("flash_attention", "bwd_preprocess_launches"),
    "flash_bwd_dkdv": ("flash_attention", "bwd_dkdv_launches"),
    "flash_bwd_dkdv_kernel_tc": ("flash_attention", "bwd_dkdv_tc_launches"),
    "flash_bwd_dq": ("flash_attention", "bwd_dq_launches"),
    "flash_bwd_dq_kernel_tc": ("flash_attention", "bwd_dq_tc_launches"),
    "flash backward bf16": ("flash_attention", "bwd_tc_launches"),
    "adamw": ("adamw", "adamw_launches"),
    "global_sq_norm": ("adamw", "sq_norm_launches")}
ON_TC = {"flash_kernel": "flash_kernel_tc",
         "flash_bwd_dkdv": "flash_bwd_dkdv_kernel_tc",
         "flash_bwd_dq": "flash_bwd_dq_kernel_tc"}
ADAMW_CHECKED = 38             # bit-checked leaves: embed, norm, 4 layers
ADAMW_HYPER = (0.9, 0.95, 1e-8, 0.1)     # b1, b2, eps, weight decay
FIELDS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
          "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
FABRIC_CU = "src/repro_torch/csrc/fabric.cu"
FLASH_CU = "src/repro_torch/csrc/flash_attention.cu"
FLASH_PALLAS = "src/repro/kernels/flash_attention.py:68"


class Disagrees(AssertionError):
    """A kernel's result is past its limit against the plain version."""


def held(err: float, limit: float, what: str) -> float:
    if not err <= limit:
        raise Disagrees(f"{what}: max abs err {err} against the plain "
                        f"version, limit {limit}")
    return err


def max_err(got, want) -> float:
    if not got.numel():
        return 0.0
    return float((got.detach().double() - want.detach().double()).abs().max())


def row(name, kernel, source, replaces, ms, plain_ms, bnd,
        library_ms=None, max_abs_err=None, **extra) -> dict:
    """One timing row: ``FIELDS`` (``bnd`` is :func:`bound`'s pair;
    ``launches`` filled by :func:`run` from the path run's count of
    ``kernel``, a name of ``COUNTERS``), then ``extra``."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": library_ms, "kernel": kernel, **extra}


def counts() -> dict:
    """Every kernel's launches so far, by the names of ``COUNTERS``; the
    float32 flash kernels' without the bf16 route's, and ``flash
    backward``, the float32 route's backward calls (one dq launch each)."""
    got = {k: getattr(importlib.import_module(f"repro_torch.kernels.{m}"), a)
           for k, (m, a) in COUNTERS.items()}
    for k, tc in ON_TC.items():
        got[k] -= got[tc]
    got["flash backward"] = got["flash_bwd_dq"]
    return got


# ---------------------------------------------------------------------------
# timers
# ---------------------------------------------------------------------------

def time_ms(fn, reps=REPS, warm=3) -> float:
    """CUDA events over ``reps`` calls of ``fn`` after ``warm``, ms a
    call."""
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


def device_ms(fn, reps=5, per_call=False):
    """Device ms a call from ``torch.profiler`` (kernels and copies,
    ``record_function`` ranges aside), and its split by name: each name's
    time over the launches of it that the profiler recorded (late in a
    long process it may record fewer than were made), so a call that
    launches each kernel once takes their sum. With ``per_call``, each
    name's time over the calls instead, for a call that launches a kernel
    several times. None where the profiler recorded no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].strip()
            total[name] = total.get(name, 0.0) + e.time_range.elapsed_us()
            count[name] = count.get(name, 0) + 1
    by_name = {n: us / (reps if per_call else count[n]) / 1e3
               for n, us in total.items()}
    return sum(by_name.values()) if by_name else None, by_name


def rotation(fn, sets):
    """A callable running ``fn`` on the next of ``sets`` in turn. Each
    output stays alive until its set comes round again, so the outputs
    rotate through len(sets) + 1 buffers as the inputs through len(sets)."""
    keep = [None] * len(sets)
    turn = itertools.count()

    def call():
        k = next(turn) % len(sets)
        keep[k] = fn(sets[k])
    return call


# ---------------------------------------------------------------------------
# bounds: one function a kernel family, the card's peaks from
# roofline.analysis
# ---------------------------------------------------------------------------

def bound(n_bytes, n_ops, ops_per_s):
    """(ms, "bytes" or "operations"): the larger of ``n_bytes`` over the
    card's HBM bandwidth and ``n_ops`` over ``ops_per_s``."""
    t_bytes = n_bytes / RA.HBM_BW * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fabric_bound(g, n_lanes, length, n_full, n_red):
    """A fabric kernel over ``n_lanes`` lanes of ``length`` int32 elements,
    ``n_full`` full-rate outputs and ``n_red`` reductions a lane; every
    ALU, CMP, MUX, Branch and Merge one int32 operation an element, on the
    int32 units (64 an SM beside 128 FP32 ones: half the FP32 rate)."""
    from repro_torch.core import dfg as D
    n_el = n_lanes * length
    ops = sum(n.kind in (D.ALU, D.CMP, D.MUX, D.BRANCH, D.MERGE)
              for n in g.nodes.values())
    return bound(4 * (n_el * (len(g.inputs) + n_full) + n_lanes * n_red),
                 n_el * ops, RA.FP32_FLOPS / 2)


def matmul_bound(m, k, n, in_bytes, out_bytes):
    """``stream_matmul``: 2 m n k flop on the FP32 units (float32 inputs)
    or the bf16 tensor cores (2-byte inputs)."""
    rate = RA.FP32_FLOPS if in_bytes == 4 else RA.PEAK_FLOPS
    return bound(in_bytes * (m * k + k * n) + out_bytes * m * n,
                 2 * m * n * k, rate)


def conv_bound(h, w):
    """``stream_conv2d``: 9 multiply-adds an output on the FP32 units."""
    out = (h - 2) * (w - 2)
    return bound(4 * (h * w + out + 9), 18 * out, RA.FP32_FLOPS)


def allowed_pairs(h, sq, sk, causal):
    """(query, key) pairs the end-aligned mask allows, over h heads."""
    if not causal:
        return h * sq * sk
    return h * sum(min(sk, sk - sq + i + 1) for i in range(sq))


def flash_bound(h, sq, sk, d, causal):
    """The float32 forward: S and O = PV, 2 d flop a pair each, on the
    FP32 units; q, k, v read, o written."""
    return bound(4 * h * d * (2 * sq + 2 * sk),
                 4 * d * allowed_pairs(h, sq, sk, causal), RA.FP32_FLOPS)


def bwd_work(h, sq, sk, d, causal):
    """Float32 bytes (each input read once, each output written once) and
    flop of the backward and of each of its kernels: {name: (bytes,
    flop)}. The products are 2 d flop a pair each: 5 for the backward (S
    once, dP, dV, dK, dQ), 4 for dkdv, 3 for dq."""
    pairs = allowed_pairs(h, sq, sk, causal)
    tile = 4 * h * d
    return {
        # q, o, dO, k, v and lse read; dq, dk, dv written
        "backward": (tile * (3 * sq + 2 * sk) + 4 * h * sq
                     + tile * (sq + 2 * sk), 5 * 2 * d * pairs),
        "flash_bwd_preprocess": (tile * 2 * sq + 4 * h * sq, 2 * d * h * sq),
        "flash_bwd_dkdv": (tile * (2 * sq + 4 * sk) + 8 * h * sq,
                           4 * 2 * d * pairs),
        "flash_bwd_dq": (tile * (3 * sq + 2 * sk) + 8 * h * sq,
                         3 * 2 * d * pairs)}


def flash_bwd_bound(kernel, h, sq, sk, d, causal, fp32_units=False):
    """The float32 backward or one of its kernels (:func:`bwd_work`): its
    products on the TF32 tensor cores in three passes (hi hi + hi lo + lo
    hi), as the kernels run them, or with ``fp32_units`` on the FP32
    units."""
    rate = RA.FP32_FLOPS if fp32_units else RA.TF32_FLOPS / 3
    return bound(*bwd_work(h, sq, sk, d, causal)[kernel], rate)


def flash_tc_bound(kernel, h, sq, sk, d, causal):
    """The bf16 route's ``forward``, ``backward`` or backward kernel:
    ``TC_PASSES`` bf16 passes of 2 d flop a pair on the bf16 tensor cores;
    bf16 tensors and float32 lse and D, each read once and written once."""
    tile = 2 * h * d
    n_bytes = {"forward": tile * (2 * sq + 2 * sk) + 4 * h * sq,
               "backward": tile * (4 * sq + 4 * sk) + 4 * h * sq,
               "flash_bwd_dkdv": tile * (2 * sq + 4 * sk) + 8 * h * sq,
               "flash_bwd_dq": tile * (3 * sq + 2 * sk) + 8 * h * sq}[kernel]
    return bound(n_bytes, TC_PASSES[kernel] * 2 * d
                 * allowed_pairs(h, sq, sk, causal), RA.PEAK_FLOPS)


def adamw_bound(n_params, bytes_a_param):
    """The optimizer's kernels move bytes only: 22 a bf16 parameter for
    the update (p, g, m, v read, p, m, v written), 2 for the norm."""
    return bound(bytes_a_param * n_params, 0, 1.0)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def _int32(rng, shape):
    import numpy as np
    import torch
    return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape,
                                         dtype=np.int64).astype(np.int32))


def bench_lanes():
    import numpy as np
    from repro_torch.core import kernels_lib as K
    from repro_torch.kernels import fabric_reduce as fr
    rng = np.random.default_rng(SEED + 1)
    rows = []
    for label, g, n_lanes, length in (
            ("gemm mac3", K.mac3(240), 200 * -(-220 // 3), 240),
            ("fft", K.fft_butterfly(), 256, 4096)):
        ins = {k: _int32(rng, (n_lanes, length)).cuda() for k in g.inputs}
        kf, kr = fr.reduce_lanes(g, ins)
        pf, pr = fr.reduce_lanes_plain(g, ins)
        err = held(max([max_err(kf[o], pf[o]) for o in pf]
                       + [max_err(kr[r], pr[r]) for r in pr]), 0,
                   f"fabric_reduce_lanes {label}")
        rows.append(row(
            f"fabric_reduce_lanes {label} {n_lanes}x{length}",
            "fabric_reduce_lanes", FABRIC_CU,
            "src/repro/kernels/fabric_reduce.py:183",
            time_ms(lambda: fr.reduce_lanes(g, ins)),
            time_ms(lambda: fr.reduce_lanes_plain(g, ins), reps=5),
            fabric_bound(g, n_lanes, length, len(pf), len(pr)),
            max_abs_err=err,
            device_ms=device_ms(lambda: fr.reduce_lanes(g, ins))[0]))
    return rows


def bench_stream():
    import numpy as np
    import torch
    from repro_torch.core import kernels_lib as K
    from repro_torch.kernels import fabric_stream as fs
    rng = np.random.default_rng(SEED + 2)
    g, n = K.relu(), 1 << 24
    sets = [{"x": _int32(rng, n).cuda()} for _ in range(ROTATE)]
    got = fs.stream_kernel(g, sets[0])["out"]
    err = held(max(max_err(got, fs.stream_plain(g, sets[0])["out"]),
                   max_err(got, torch.relu(sets[0]["x"]))), 0,
               "fabric_stream relu")
    kernel = rotation(lambda x: fs.stream_kernel(g, x), sets)
    library = rotation(lambda x: torch.relu(x["x"]), sets)
    warm = 2 * ROTATE              # every output buffer made before timing
    return [row(f"fabric_stream relu n={n}, {ROTATE} sets rotated",
                "fabric_stream", FABRIC_CU,
                "src/repro/kernels/fabric_stream.py:86",
                time_ms(kernel, warm=warm),
                time_ms(lambda: fs.stream_plain(g, sets[0]), reps=5),
                fabric_bound(g, 1, n, 1, 0),
                library_ms=time_ms(library, warm=warm), max_abs_err=err,
                device_ms=device_ms(kernel)[0])]


def _matmul_row(name, a, b, tol, kernel):
    """``stream_matmul`` on (a, b): a float32 result within ``tol`` max|C|
    of the plain version, a bfloat16 one for a bfloat16 ``a`` one rounding
    more; ``kernel`` names the route (``COUNTERS``)."""
    import torch
    from repro_torch.kernels import stream_matmul as sm
    (m, k), n = a.shape, b.shape[1]
    want = sm.matmul_plain(a, b)
    limit = tol * float(want.abs().max())
    err = held(max_err(sm.matmul_kernel(a, b), want), limit, name)
    extra = {}
    if a.dtype == torch.bfloat16:
        w16 = want.to(torch.bfloat16).float()
        got = sm.matmul_kernel(a, b, torch.bfloat16).float()
        if not bool(((got - w16).abs() <= limit + 2 ** -7 * w16.abs())
                    .all()):
            raise Disagrees(f"{name}, bf16 out: past {limit} + 2^-7 |C|")
        del got, w16
        extra["bf16_out_ms"] = time_ms(
            lambda: sm.matmul_kernel(a, b, torch.bfloat16))
    del want
    torch.cuda.empty_cache()
    return row(name, kernel, "src/repro_torch/csrc/stream_matmul.cu",
               "src/repro/kernels/stream_matmul.py:68",
               time_ms(lambda: sm.matmul_kernel(a, b)),
               time_ms(lambda: sm.matmul_plain(a, b), reps=3, warm=1),
               matmul_bound(m, k, n, a.element_size(), 4),
               library_ms=time_ms(lambda: torch.matmul(a, b)),
               max_abs_err=err, limit=limit, **extra)


def bench_f32():
    import numpy as np
    import torch
    M, K, N = MM
    rng = np.random.default_rng(SEED)
    a, b = (torch.from_numpy(rng.standard_normal(s, dtype="float32")).cuda()
            for s in ((M, K), (K, N)))
    return [_matmul_row(f"stream_matmul f32 {M}x{K}x{N}", a, b, 1e-5,
                        "stream_matmul sgemm")]


def bench_bf16():
    import torch
    from repro_torch.kernels import stream_matmul as sm
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for label, (M, K, N), off in (("wgmma", MM, 0),
                                  ("wgmma_realign S1 A off alignment", MM,
                                   1),
                                  ("wgmma_realign S2 lm head", MM_HEAD, 0)):
        a = torch.randn(M * K + off, device="cuda", generator=g).to(
            torch.bfloat16)[off:].view(M, K)
        b = torch.randn((K, N), device="cuda", generator=g).to(
            torch.bfloat16)
        route = label.split()[0]
        if sm.route(a, b) != route:
            raise Disagrees(f"{label}: takes {sm.route(a, b)}")
        rows.append(_matmul_row(
            f"stream_matmul bf16 {label} {M}x{K}x{N}", a, b, 1e-4,
            f"stream_matmul {route}"))
        del a, b
        torch.cuda.empty_cache()
    return rows


def bench_conv():
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import stream_conv2d as sc
    H, W = CONV
    rng = np.random.default_rng(SEED + 6)
    img, kern = (torch.from_numpy(rng.standard_normal(s, dtype="float32"))
                 .cuda() for s in (CONV, (3, 3)))
    got = sc.conv_kernel(img, kern)
    want = sc.conv_plain(img, kern)
    if not bool(((got - want).abs() <= 1e-4 + 1e-3 * want.abs()).all()):
        raise Disagrees("stream_conv2d: past 1e-4 + 1e-3 |x|")
    return [row(f"stream_conv2d {H}x{W}", "stream_conv2d",
                "src/repro_torch/csrc/stream_conv2d.cu",
                "src/repro/kernels/stream_conv2d.py:51",
                time_ms(lambda: sc.conv_kernel(img, kern)),
                time_ms(lambda: sc.conv_plain(img, kern), reps=5, warm=1),
                conv_bound(H, W),
                library_ms=time_ms(lambda: F.conv2d(img[None, None],
                                                    kern[None, None])),
                max_abs_err=max_err(got, want))]


def _qkv(rng, h, sq, sk, d, dtype, grad=False):
    """q, k, v (and dO with ``grad``) on the card, from the seed."""
    import torch
    return tuple(torch.from_numpy(rng.standard_normal(
        (h, n, d), dtype="float32")).cuda().to(dtype)
        for n in (sq, sk, sk) + ((sq,) if grad else ()))


def _sdpa(q, k, v, causal):
    """SDPA on (h, s, d) tensors under the end-aligned mask: its
    ``is_causal`` aligns the mask to the first key, so the mask is passed
    only where the two agree (sq = sk) and dropped for one query, which
    the end-aligned mask leaves unmasked."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q[None], k[None], v[None], is_causal=causal and
        q.shape[1] == k.shape[1])[0]


def bench_flash():
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    rows = []
    for label, h, sq, sk, d, causal in FLASH_SHAPES:
        rng = np.random.default_rng(SEED + h + sq + sk + d)
        q, k, v = _qkv(rng, h, sq, sk, d, torch.float32)
        got = fa.attention_kernel(q, k, v, causal)
        want = fa.attention_plain(q, k, v, causal)
        err = held(max_err(got, want), 3e-5, f"flash_attention {label}")
        # 1e-4: SDPA sums in another order
        held(max_err(_sdpa(q, k, v, causal), want), 1e-4,
             f"SDPA at {label} is another function")
        del got, want
        fn = lambda: fa.attention_kernel(q, k, v, causal)  # noqa: E731
        rows.append(row(
            f"flash_attention {label} h={h} sq={sq} sk={sk} d={d} "
            f"{'causal' if causal else 'non-causal'}", "flash_kernel",
            FLASH_CU, FLASH_PALLAS, time_ms(fn),
            time_ms(lambda: fa.attention_plain(q, k, v, causal), reps=5,
                    warm=1),
            flash_bound(h, sq, sk, d, causal),
            library_ms=time_ms(lambda: _sdpa(q, k, v, causal)),
            max_abs_err=err, device_ms=device_ms(fn)[0]))
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def _sdpa_backward_ms(q, k, v, do, causal):
    """SDPA's backward alone (its forward run once with a gradient) and
    its forward + backward, on the same inputs."""
    import torch
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = _sdpa(*leaves, causal)
    bwd = time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                              retain_graph=True), reps=10)
    both = time_ms(lambda: torch.autograd.grad(_sdpa(*leaves, causal),
                                               leaves, do), reps=10)
    return bwd, both


def bench_flash_bwd():
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    rows = []
    for i, (label, h, sq, sk, d, causal) in enumerate(BWD_SHAPES):
        rng = np.random.default_rng(SEED + h + sq + sk + d)
        q, k, v, do = _qkv(rng, h, sq, sk, d, torch.float32, grad=True)
        o, lse = fa.attention_lse_kernel(q, k, v, causal)
        got = fa.attention_backward_kernel(q, k, v, o, lse, do, causal)
        want = ref.flash_attention_backward(q, k, v, o, lse, do, causal)
        errs = [held(max_err(a, b), 1e-4 * float(b.abs().max()),
                     f"flash backward {label} d{n}")
                for a, b, n in zip(got, want, "qkv")]
        del got
        torch.cuda.empty_cache()
        sdpa_bwd_ms, sdpa_ms = _sdpa_backward_ms(q, k, v, do, causal)
        shape = (h, sq, sk, d, causal)
        tag = (f"{label} h={h} sq={sq} sk={sk} d={d} "
               f"{'causal' if causal else 'non-causal'}")
        plain_ms = time_ms(lambda: ref.flash_attention_backward(
            q, k, v, o, lse, do, causal), reps=5, warm=1)
        rows.append(row(
            f"flash_attention backward {tag}", "flash backward", FLASH_CU,
            FLASH_PALLAS,
            time_ms(lambda: fa.attention_backward_kernel(
                q, k, v, o, lse, do, causal)),
            plain_ms, flash_bwd_bound("backward", *shape),
            library_ms=sdpa_ms, max_abs_err=max(errs),
            bound_fp32_ms=flash_bwd_bound("backward", *shape, True)[0],
            sdpa_backward_ms=sdpa_bwd_ms,
            forward_lse_ms=time_ms(lambda: fa.attention_lse_kernel(
                q, k, v, causal))))
        if i == 0:
            rows += _bwd_kernel_rows(tag, q, k, v, o, lse, do, causal,
                                     want, plain_ms, sdpa_bwd_ms)
        del q, k, v, do, o, lse, want
        torch.cuda.empty_cache()
    return rows


def _bwd_kernel_rows(tag, q, k, v, o, lse, do, causal, want, plain_ms,
                     sdpa_bwd_ms):
    """Each float32 backward kernel alone; the preprocess also by its
    device time, on the same inputs and over ``ROTATE`` sets the L2 cannot
    hold, D the same bits from bases one element off alignment."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    h, sq, d = q.shape
    shape = (h, sq, k.shape[1], d, causal)
    delta = fa.bwd_preprocess_kernel(o, do)
    delta_p = (do.float() * o.float()).sum(-1)
    e_d = held(max_err(delta, delta_p), 1e-5 * float(delta_p.abs().max()),
               "flash_bwd_preprocess")
    shifted = []
    for t in (o, do):
        shifted.append(torch.empty(t.numel() + 1, dtype=t.dtype,
                                   device=t.device)[1:].view(t.shape))
        shifted[-1].copy_(t)
    if not torch.equal(delta, fa.bwd_preprocess_kernel(*shifted)):
        raise Disagrees("flash_bwd_preprocess: D from a misaligned base")
    del shifted
    dk, dv = fa.bwd_dkdv_kernel(q, k, v, do, lse, delta, causal)
    cases = {
        "flash_bwd_preprocess": (
            lambda: fa.bwd_preprocess_kernel(o, do),
            time_ms(lambda: (do.float() * o.float()).sum(-1)),
            time_ms(lambda: torch.linalg.vecdot(do, o)), e_d),
        "flash_bwd_dkdv": (
            lambda: fa.bwd_dkdv_kernel(q, k, v, do, lse, delta, causal),
            plain_ms, sdpa_bwd_ms,
            max(max_err(dk, want[1]), max_err(dv, want[2]))),
        "flash_bwd_dq": (
            lambda: fa.bwd_dq_kernel(q, k, v, do, lse, delta, causal),
            plain_ms, sdpa_bwd_ms,
            max_err(fa.bwd_dq_kernel(q, k, v, do, lse, delta, causal),
                    want[0]))}
    rows = []
    for name, (fn, p_ms, lib_ms, err) in cases.items():
        extra = {"bound_fp32_ms": flash_bwd_bound(name, *shape, True)[0]}
        if name == "flash_bwd_preprocess":
            sets = [(o, do)] + [(torch.randn_like(o), torch.randn_like(do))
                                for _ in range(ROTATE - 1)]
            rot = rotation(lambda s: fa.bwd_preprocess_kernel(*s), sets)
            extra.update(device_ms=device_ms(fn, reps=20)[0],
                         rot_device_ms=device_ms(rot, reps=20)[0])
            del sets
        rows.append(row(f"{name} {tag}", name, FLASH_CU, FLASH_PALLAS,
                        time_ms(fn), p_ms, flash_bwd_bound(name, *shape),
                        library_ms=lib_ms, max_abs_err=err,
                        **extra))
    return rows


def pieces_of(x, n: int):
    """float32 x cut to its first n bfloat16 pieces (hi = bf16_rn(x), mid
    = bf16_rn(x - hi)), summed in float32; 3 pieces give back x."""
    if n >= 3:
        return x
    hi = x.bfloat16().float()
    return hi if n == 1 else hi + (x - hi).bfloat16().float()


def plain_pieces(q, k, v, do, lse, delta, causal: bool, pieces: int):
    """O, dQ, dK, dV in bfloat16 by plain PyTorch from bfloat16 q, k, v,
    dO and the saved float32 lse and D: S and dP in float32 (a product of
    two bfloat16 is exact there), P and dS in float32 under the
    end-aligned mask, each cut to ``pieces`` bfloat16 pieces
    (:func:`pieces_of`) before its products. One piece is plain bf16
    flash; three are the route's contract."""
    import torch
    h, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / d ** 0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = qf @ kf.mT * scale
    ok = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        ok = torch.arange(sk, device=q.device)[None] <= (
            sk - sq + torch.arange(sq, device=q.device)[:, None])
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    del s
    ds = p * (dof @ vf.mT - delta[..., None])
    p, ds = pieces_of(p, pieces), pieces_of(ds, pieces)
    out = (p @ vf, ds @ kf * scale, ds.mT @ qf * scale, p.mT @ dof)
    return tuple(t.bfloat16() for t in out)


AGREE_NAMES = ("o", "dq", "dk", "dv")


def route_agreement(fa, q, k, v, do, causal: bool, pieces=(1, 2, 3)):
    """Shares of O, dQ, dK, dV elements on which bfloat16 results equal
    the float32 route's rounded to bfloat16: the FP32-unit forward and
    3xTF32 backward kernels on float32 copies of the same bfloat16 q, k,
    v, dO. ``kernels``: the kernels on the bfloat16 inputs themselves
    (the route ``fa.tc_route`` picks); ``plain_<n>``: :func:`plain_pieces`
    with n pieces. Both routes' backward kernels read the same lse and D,
    the bfloat16 forward's, so only the products differ. A float32-grade
    result misses only where the two fall on either side of a bfloat16
    rounding boundary; one piece misses far more often."""
    o, lse = fa.attention_lse_kernel(q, k, v, causal)
    delta = fa.bwd_preprocess_kernel(o, do)
    f32 = [t.float() for t in (q, k, v, do)]
    dk32, dv32 = fa.bwd_dkdv_kernel(*f32, lse, delta, causal)
    want = (fa.attention_lse_kernel(*f32[:3], causal)[0].bfloat16(),
            fa.bwd_dq_kernel(*f32, lse, delta, causal).bfloat16(),
            dk32.bfloat16(), dv32.bfloat16())
    del f32, dk32, dv32

    def share(got):
        return {n: float((a == b).float().mean())
                for n, a, b in zip(AGREE_NAMES, got, want)}
    dk, dv = fa.bwd_dkdv_kernel(q, k, v, do, lse, delta, causal)
    out = {"kernels": share((o, fa.bwd_dq_kernel(q, k, v, do, lse, delta,
                                                  causal), dk, dv))}
    for n in pieces:
        out[f"plain_{n}"] = share(plain_pieces(q, k, v, do, lse, delta,
                                               causal, n))
    return out


def bench_flash_bf16():
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    rows = []
    for label, h, sq, sk, d, causal in BF16_SHAPES:
        rng = np.random.default_rng(SEED + h + sq + sk + d)
        q, k, v, do = _qkv(rng, h, sq, sk, d, torch.bfloat16, grad=True)
        shape = (h, sq, sk, d, causal)
        tc = fa.tc_route(q, sk)
        o, lse = fa.attention_lse_kernel(q, k, v, causal)
        got = fa.attention_backward_kernel(q, k, v, o, lse, do, causal)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        want_o = ref.flash_attention(*leaves, causal=causal)
        want = torch.autograd.grad(want_o, leaves, do)
        e_o = held(max_err(o, want_o), 2 ** -7, f"bf16 forward {label}")
        errs = [held(max_err(a, b), 2e-2 * float(b.float().abs().max()),
                     f"bf16 backward {label} d{n}")
                for a, b, n in zip(got, want, "qkv")]
        del got, want, want_o, leaves
        torch.cuda.empty_cache()
        delta = fa.bwd_preprocess_kernel(o, do)
        with torch.no_grad():
            sdpa_fwd_ms = time_ms(lambda: _sdpa(q, k, v, causal))
        sdpa_bwd_ms, _ = _sdpa_backward_ms(q, k, v, do, causal)
        plain_fwd_ms = time_ms(lambda: ref.flash_attention_lse(
            q, k, v, causal), reps=5, warm=1)
        plain_bwd_ms = time_ms(lambda: ref.flash_attention_backward(
            q, k, v, o, lse, do, causal), reps=5, warm=1)
        agreement = route_agreement(fa, q, k, v, do, causal)
        torch.cuda.empty_cache()
        # each row's name and kernel (``COUNTERS``): the route's kernels
        # where tc_route takes it, else the float32 route's on bf16 inputs
        on = "_tc" if tc else ""
        names = {"forward": ("flash_kernel" + on, ON_TC["flash_kernel"]
                             if tc else "flash_kernel"),
                 "backward": ("flash_attention backward bf16",
                              "flash backward bf16" if tc
                              else "flash backward"),
                 "flash_bwd_dkdv": ("flash_bwd_dkdv_kernel" + on,
                                    ON_TC["flash_bwd_dkdv"] if tc
                                    else "flash_bwd_dkdv"),
                 "flash_bwd_dq": ("flash_bwd_dq_kernel" + on,
                                  ON_TC["flash_bwd_dq"] if tc
                                  else "flash_bwd_dq")}
        cases = {
            "forward": (lambda: fa.attention_lse_kernel(q, k, v, causal),
                        plain_fwd_ms, sdpa_fwd_ms, e_o),
            "backward": (lambda: fa.attention_backward_kernel(
                q, k, v, o, lse, do, causal), plain_bwd_ms, sdpa_bwd_ms,
                max(errs)),
            "flash_bwd_dkdv": (lambda: fa.bwd_dkdv_kernel(
                q, k, v, do, lse, delta, causal), plain_bwd_ms,
                sdpa_bwd_ms, max(errs[1:])),
            "flash_bwd_dq": (lambda: fa.bwd_dq_kernel(
                q, k, v, do, lse, delta, causal), plain_bwd_ms,
                sdpa_bwd_ms, errs[0])}
        for kernel, (fn, p_ms, lib_ms, err) in cases.items():
            name, counter = names[kernel]
            rows.append(row(
                f"{name} {label} h={h} sq={sq} sk={sk} d={d}", counter,
                FLASH_CU, FLASH_PALLAS, time_ms(fn), p_ms,
                flash_tc_bound(kernel, *shape), library_ms=lib_ms,
                max_abs_err=err,
                device_ms=device_ms(fn)[0], dtype="bf16", tc_route=tc,
                **({"agreement": agreement} if kernel == "forward"
                   else {})))
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    return rows


def bench_adamw():
    """The update and the norm over minicpm-2b's leaves, beside the plain
    loop and the library."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import adamw as K
    from repro_torch.models.api import build_model
    with FakeTensorMode():
        shapes = [p.shape for p in build_model(get_arch(
            "minicpm-2b")).init_params(torch.Generator()).parameters()]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    draw = lambda s, x: (torch.randn(                    # noqa: E731
        s, generator=gen, device="cuda") * x).to(torch.bfloat16)
    params = [draw(s, 0.02) for s in shapes]
    grads = [draw(s, 1e-3) for s in shapes]
    mu = [torch.randn(s, generator=gen, device="cuda") * 1e-4
          for s in shapes]
    nu = [torch.rand(s, generator=gen, device="cuda") * 1e-8
          for s in shapes]
    n = sum(p.numel() for p in params)
    one = lambda v: torch.tensor(v, device="cuda")       # noqa: E731
    lr, b1c, b2c, scale = one(1e-3), one(0.3439), one(0.185494), one(0.75)

    # the update: bit-equal to the plain loop on copies of the first leaves
    c = ADAMW_CHECKED
    kern = [[t.clone() for t in ts[:c]] for ts in (params, mu, nu)]
    plain = [[t.clone() for t in ts[:c]] for ts in (params, mu, nu)]
    K.update(*kern, grads[:c], lr, b1c, b2c, scale, *ADAMW_HYPER)
    K.update_plain(*plain, grads[:c], lr, b1c, b2c, scale, *ADAMW_HYPER)
    err = max(max_err(a, b) for a, b in zip(sum(kern, []), sum(plain, [])))
    held(err, 0, "adamw update")
    del kern, plain
    # the norm: within 1e-5 of the plain sum
    total, plain_total = (float(f(grads)) for f in (K.global_sq_norm,
                                                   K.sq_norm_plain))
    e_norm = held(abs(total - plain_total), 1e-5 * plain_total,
                  "global_sq_norm")
    torch.cuda.empty_cache()

    def update():
        K.update(params, mu, nu, grads, lr, b1c, b2c, scale, *ADAMW_HYPER)

    def update_plain():
        # the eager clip and update, as the trainer ran before the kernels
        s = torch.clamp(1.0 / (torch.sqrt(K.sq_norm_plain(grads)) + 1e-9),
                        max=1.0)
        K.update_plain(params, mu, nu,
                       [(g.float() * s).to(g.dtype) for g in grads], lr,
                       b1c, b2c, None, *ADAMW_HYPER)
    rows = []
    for name, fn, plain_fn, per_param, e, library in (
            ("adamw", update, update_plain, 22, err, None),
            ("global_sq_norm", lambda: K.global_sq_norm(grads),
             lambda: K.sq_norm_plain(grads), 2, e_norm,
             lambda: torch.linalg.vector_norm(torch.stack(
                 torch._foreach_norm(grads))))):
        rows.append(row(
            f"{name} minicpm-2b {len(shapes)} leaves n={n}", name,
            "src/repro_torch/csrc/adamw.cu", None,
            time_ms(fn, warm=1), time_ms(plain_fn, reps=3, warm=1),
            adamw_bound(n, per_param),
            library_ms=library and time_ms(library, warm=1),
            max_abs_err=e,
            device_ms=device_ms(fn, per_call=True)[0]))
    del mu, nu
    torch.cuda.empty_cache()
    leaves = [torch.nn.Parameter(p) for p in params]
    for p, g in zip(leaves, grads):
        p.grad = g
    lib = torch.optim.AdamW(leaves, lr=1e-3, betas=ADAMW_HYPER[:2],
                            eps=ADAMW_HYPER[2], weight_decay=ADAMW_HYPER[3],
                            fused=True)
    rows[0]["library_ms"] = time_ms(lib.step, reps=5, warm=1)
    return rows


def path_launches() -> dict:
    """The ``path`` run: each kernel's launches (:func:`counts`) over one
    run of the trainer, the engine and the kernel ops, as the module
    docstring lists them."""
    import gc
    import numpy as np
    import torch
    from repro_torch.core import kernels_lib as K
    from repro_torch.engine import ArtifactCache, Engine, clients
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    before = counts()
    arch, batch, seq, steps = PATH_TRAIN
    train.main(["--arch", arch, "--steps", str(steps), "--batch", str(batch),
                "--seq", str(seq), "--log-every", str(steps), "--seed",
                str(SEED), "--device", "cuda"])
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 7)
    ints = lambda shape: rng.integers(                   # noqa: E731
        -2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(np.int32)
    eng = Engine(backend="cuda", cache=ArtifactCache(memory_only=True))
    NI, NJ, NK = PATH_GEMM
    A, B, C = (rng.integers(-1000, 1000, s).astype(np.int32)
               for s in ((NI, NK), (NK, NJ), (NI, NJ)))
    clients.run_gemm(eng, 3, A, B, 2, C)
    g = K.fft_butterfly()
    art = eng.compile(g)
    n, length = PATH_FFT
    for _ in range(n):
        eng.submit(art, {k: ints(length) for k in g.inputs})
    eng.flush()

    M, Kd, N = MM
    a, b = (rng.standard_normal(s, dtype="float32")
            for s in ((M, Kd), (Kd, N)))
    ops.matmul(a, b)                                     # sgemm
    a16, b16 = (torch.from_numpy(x).cuda().to(torch.bfloat16) for x in (a, b))
    ops.matmul(a16, b16)                                 # wgmma
    off = torch.empty(M * Kd + 1, dtype=torch.bfloat16, device="cuda")
    off = off[1:].view(M, Kd)
    off.copy_(a16)
    ops.matmul(off, b16)                                 # wgmma_realign
    Mh, Kh, Nh = MM_HEAD
    ops.matmul(torch.randn(Mh, Kh, device="cuda").to(torch.bfloat16),
               torch.randn(Kh, Nh, device="cuda").to(torch.bfloat16),
               out_dtype=torch.bfloat16)                 # wgmma_realign
    del a16, b16, off
    ops.conv2d_3x3(rng.standard_normal(CONV, dtype="float32"),
                   rng.standard_normal((3, 3), dtype="float32"))
    _, h, sq, sk, d, causal = FLASH_SHAPES[0]
    ops.attention(*(rng.standard_normal((h, x, d), dtype="float32")
                    for x in (sq, sk, sk)), causal=causal)
    ops.fabric_elementwise(K.relu(), {"x": ints(1 << 24)})
    torch.cuda.synchronize()
    after = counts()
    gc.collect()
    torch.cuda.empty_cache()
    return {k: after[k] - before[k] for k in after}


CASES = {"lanes": bench_lanes, "stream": bench_stream, "f32": bench_f32,
         "bf16": bench_bf16, "conv": bench_conv, "flash": bench_flash,
         "flash_bwd": bench_flash_bwd, "flash_bf16": bench_flash_bf16,
         "adamw": bench_adamw}
ONLY = ("path", *CASES)          # what --only names: the path run, the cases


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", default=HERE,
                   help="the src directory whose kernels to build and time")
    p.add_argument("--only", default=",".join(ONLY),
                   help=f"comma-separated names of {', '.join(ONLY)}")
    args = p.parse_args(argv)
    args.only = args.only.split(",")
    if not set(args.only) <= set(ONLY):
        p.error(f"--only takes names of {', '.join(ONLY)}, got "
                f"{','.join(args.only)}")
    return args


def run(only=ONLY, src=None):
    """The rows of the cases ``only`` names, in ``CASES``' order, each
    with ``src`` and, where ``only`` names ``path``, the path run's
    launches of its kernel (the run goes first); TF32 off, so that the
    plain versions and the library calls compute in full float32."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = path_launches() if "path" in only else {}
    rows = []
    for case, bench in CASES.items():
        if case in only:
            rows += [dict(r, src=src, launches=path.get(r["kernel"]))
                     for r in bench()]
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    args = parse_args(argv)
    src = os.path.abspath(args.src)
    if src != HERE:
        # the other tree's kernels: its package afresh, RA kept
        for m in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
            del sys.modules[m]
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build()
    for r in run(args.only, args.src):
        print(json.dumps(r), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
