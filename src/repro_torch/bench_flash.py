"""Times the CUDA ``flash_attention`` kernels at several head widths.

Run on a machine with one NVIDIA card, from the repository root:

    python3 src/repro_torch/bench_flash.py [--src DIR] [--backward
        [--shape LABEL]]

It builds the kernels of ``DIR/repro_torch`` (the ``src`` directory beside
this file unless ``--src`` names another, so that one run can time two
versions of the kernels on one card, in turns).

Without ``--backward``: for each head width d in 64, 80 and 128 it makes
causal float32 q, k, v of shape (32, 4096, d) from a seed and prints one
JSON line: the forward kernel's time (CUDA events over 20 warm launches),
the time of ``scaled_dot_product_attention`` on the same inputs (a
yardstick only), the bound (the multiply-adds of the allowed pairs over
the FP32 units' 67 TFLOP/s, or the bytes over 3.35 TB/s, whichever is
larger) and the largest difference from the plain version, which must stay
within 3e-5.

With ``--backward``: at every shape training reaches (``BWD_SHAPES``,
float32) it prints one JSON line with the three backward kernels' time
(``flash_bwd_preprocess``, ``flash_bwd_dkdv_kernel``, ``flash_bwd_dq_kernel``)
and each kernel's alone, beside SDPA's backward alone (its forward run
once with a gradient, then ``torch.autograd.grad(..., retain_graph=True)``
timed) and SDPA's forward + backward, each with two bounds: the products
on the FP32 units (67 TFLOP/s) and on the TF32 tensor cores in three
passes (495 / 3 TFLOP/s), and the preprocess also beside
``torch.linalg.vecdot`` (the one PyTorch call computing D) and by its
profiler device time, on the same inputs and over 4 rotated input sets. The kernels' dq,
dk, dv must stay within 1e-4 of max |plain| of the plain backward.
``--shape`` keeps the shapes whose label starts with LABEL.

The last line names the card and its power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
TF32X3_FLOP_PER_S = 495e12 / 3   # TF32 tensor cores, three passes a product
TOL = 3e-5                     # the reference tests' attention tolerance
BWD_REL_TOL = 1e-4             # the backward, of max |plain| (float32)
SEED = 0
HEADS, SEQ = 32, 4096
HEAD_DIMS = (64, 80, 128)      # the kernel's widths past the smallest
# (label, heads, sq, sk, d, causal): every shape training reaches, batch 4
BWD_SHAPES = (("minicpm-2b", 4 * 36, 512, 512, 64, True),
              ("zamba2-2.7b shared block", 4 * 32, 512, 512, 80, True),
              ("internvl2-76b heads (d 128, batch 1)", 64, 512, 512, 128,
               True),
              ("whisper-base encoder", 4 * 8, 1500, 1500, 64, False),
              ("whisper-base cross-attention", 4 * 8, 512, 1500, 64, False))


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


def allowed_pairs(h, sq, sk, causal):
    """(query, key) pairs the end-aligned mask allows, over h heads."""
    if not causal:
        return h * sq * sk
    return h * sum(min(sk, sk - sq + i + 1) for i in range(sq))


def bound_ms(h, sq, sk, d):
    pairs = allowed_pairs(h, sq, sk, True)
    t_ops = 4 * d * pairs / FP32_FLOP_PER_S * 1e3
    t_bytes = 4 * h * d * (2 * sq + 2 * sk) / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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


def bounds(n_bytes, n_flop):
    """(ms, bound_by) on the FP32 units and on the TF32 tensor cores in
    three passes: the larger of bytes over 3.35 TB/s and flop over the
    rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    out = []
    for rate in (FP32_FLOP_PER_S, TF32X3_FLOP_PER_S):
        t_ops = n_flop / rate * 1e3
        out.append((t_bytes, "bytes") if t_bytes >= t_ops
                   else (t_ops, "operations"))
    return out


def forward(args, torch, F, fa) -> bool:
    import numpy as np
    ok = True
    h, s = HEADS, SEQ
    for d in HEAD_DIMS:
        rng = np.random.default_rng(SEED + d)
        q, k, v = (torch.from_numpy(
            rng.standard_normal((h, s, d), dtype="float32")).cuda()
            for _ in range(3))
        got = fa.attention_kernel(q, k, v, True)
        err = float((got - fa.attention_plain(q, k, v, True)).abs().max())
        ok = ok and err <= TOL and bool(torch.isfinite(got).all())
        del got
        torch.cuda.empty_cache()
        ms = time_ms(lambda: fa.attention_kernel(q, k, v, True))
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True))
        b_ms, b_by = bound_ms(h, s, s, d)
        print(json.dumps({
            "src": args.src, "heads": h, "seq": s, "d": d, "causal": True,
            "ms": ms, "sdpa_ms": sdpa_ms, "bound_ms": b_ms, "bound_by": b_by,
            "share": b_ms / ms, "max_abs_err": err}), flush=True)
    return ok


def backward(args, torch, F, fa) -> bool:
    import numpy as np
    from repro_torch.kernels import ref
    ok = True
    for label, h, sq, sk, d, causal in BWD_SHAPES:
        if not label.startswith(args.shape):
            continue
        rng = np.random.default_rng(SEED + h + sq + sk + d)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (h, n, d), dtype="float32")).cuda() for n in (sq, sk, sk, sq))
        o, lse = fa.attention_lse_kernel(q, k, v, causal)
        got = fa.attention_backward_kernel(q, k, v, o, lse, do, causal)
        want = ref.flash_attention_backward(q, k, v, o, lse, do, causal)
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, want)]
        ok = ok and all(e <= BWD_REL_TOL for e in errs) and all(
            bool(torch.isfinite(a).all()) for a in got)
        del got, want
        torch.cuda.empty_cache()
        delta = fa.bwd_preprocess_kernel(o, do)
        fns = {
            "backward": lambda: fa.attention_backward_kernel(
                q, k, v, o, lse, do, causal),
            "flash_bwd_preprocess": lambda: fa.bwd_preprocess_kernel(o, do),
            "flash_bwd_dkdv": lambda: fa.bwd_dkdv_kernel(
                q, k, v, do, lse, delta, causal),
            "flash_bwd_dq": lambda: fa.bwd_dq_kernel(
                q, k, v, do, lse, delta, causal)}
        row = {"src": args.src, "label": label, "heads": h, "sq": sq,
               "sk": sk, "d": d, "causal": causal,
               "max_rel_err": dict(zip(("dq", "dk", "dv"), errs))}
        for name, (n_bytes, n_flop) in bwd_work(h, sq, sk, d,
                                                causal).items():
            ms = time_ms(fns[name])
            (b32, by32), (b3, by3) = bounds(n_bytes, n_flop)
            row[name] = {"ms": ms, "bound_fp32_ms": b32,
                         "bound_fp32_by": by32, "share_fp32": b32 / ms,
                         "bound_tf32x3_ms": b3, "bound_tf32x3_by": by3,
                         "share_tf32x3": b3 / ms}
        row["flash_bwd_preprocess"]["library_ms"] = time_ms(
            lambda: torch.linalg.vecdot(do, o))
        # the preprocess is short enough that back-to-back events time the
        # wrapper's host work too: its device time by the profiler, on the
        # same inputs and over 4 rotated sets the 50 MB L2 cannot hold
        from repro_torch.bench_kernels import device_ms
        sets = [(o, do)] + [(torch.randn_like(o), torch.randn_like(do))
                            for _ in range(3)]
        turn = [0]

        def rotated():
            turn[0] += 1
            return fa.bwd_preprocess_kernel(*sets[turn[0] % len(sets)])
        pre = row["flash_bwd_preprocess"]
        pre["device_ms"], _ = device_ms(
            lambda: fa.bwd_preprocess_kernel(o, do), reps=20)
        pre["rot_device_ms"], _ = device_ms(rotated, reps=20)
        pre["rot_device_share"] = pre["bound_fp32_ms"] / pre["rot_device_ms"]
        del sets
        row["forward_lse_ms"] = time_ms(
            lambda: fa.attention_lse_kernel(q, k, v, causal))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        c = causal and sq == sk      # SDPA's mask is start-aligned

        def sdpa_fwd():
            return F.scaled_dot_product_attention(
                leaves[0][None], leaves[1][None], leaves[2][None],
                is_causal=c)
        out = sdpa_fwd()
        row["sdpa_backward_ms"] = time_ms(lambda: torch.autograd.grad(
            out, leaves, do[None], retain_graph=True))
        row["sdpa_forward_backward_ms"] = time_ms(
            lambda: torch.autograd.grad(sdpa_fwd(), leaves, do[None]))
        print(json.dumps(row), flush=True)
        del q, k, v, do, o, lse, delta, leaves, out
        torch.cuda.empty_cache()
    return ok


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", default=here)
    p.add_argument("--backward", action="store_true",
                   help="time the backward kernels at BWD_SHAPES")
    p.add_argument("--shape", default="",
                   help="with --backward, the shapes whose label starts "
                        "with this")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("bench_flash: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    _build.build()
    ok = (backward if args.backward else forward)(args, torch, F, fa)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())
    if not ok:
        print(f"bench_flash: a result passed its limit against the plain "
              f"version ({TOL} forward, {BWD_REL_TOL} of max |plain| "
              f"backward)", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
