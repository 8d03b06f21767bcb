"""Times the CUDA ``flash_attention`` kernels at several head widths.

Run on a machine with one NVIDIA card, from the repository root:

    python3 src/repro_torch/bench_flash.py [--src DIR] [--backward
        [--shape LABEL]] [--dtype bf16]

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

With ``--dtype bf16``: at the benchmark cells' attention shapes and the
decode shape (``BF16_SHAPES``, bfloat16, each layer's heads times the
batch) it prints one JSON line with the forward (with lse) and the
backward (the three kernels) by CUDA events, dkdv and dq alone, which
route ran (``tc_launches`` and ``bwd_tc_launches``, null for a tree that
has no bf16 route), the bf16 bound (passes x 2 x pairs x d over 989
TFLOP/s: 4 passes forward, S and O = PV in three pieces; 11 backward: S,
dP, and dV, dQ, dK in three pieces each) and SDPA forward and forward +
backward on the same inputs (a yardstick only; its causal mask is
start-aligned, so the decode shape runs it without), and under
``agreement`` the shares of output and gradient elements that equal the
float32 route's rounded to bfloat16 (:func:`route_agreement`), for the
kernels and for P and dS cut to one, two and three pieces. The kernels' output
must stay within 2^-7 and their gradients within 2e-2 of max |plain|, as
the GPU tests hold them. ``--src`` on the parent tree times its kernels on
the same inputs, in turns.

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
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
BF16_PASSES = {"forward": 4, "backward": 11}   # bf16 passes a product pair
BF16_FWD_TOL = 2 ** -7         # the GPU tests' bf16 forward tolerance
BF16_BWD_TOL = 2e-2            # and backward, of max |plain|
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
# (label, heads, sq, sk, d, causal): the bf16 cells' attention, and decode
BF16_SHAPES = (("minicpm-2b.train-4k", 36, 4096, 4096, 64, True),
               ("granite-3.0-3b-a800m.train-2x2048", 2 * 24, 2048, 2048, 64,
                True),
               ("minicpm-2b.train-512", 4 * 36, 512, 512, 64, True),
               ("minicpm-2b decode", 4 * 36, 1, 49, 64, True))


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
    the float32 route's rounded to bfloat16: today's FP32-unit forward and
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


def bf16(args, torch, F, fa) -> bool:
    import numpy as np
    from repro_torch.kernels import ref
    ok = True
    for label, h, sq, sk, d, causal in BF16_SHAPES:
        if not label.startswith(args.shape):
            continue
        rng = np.random.default_rng(SEED + h + sq + sk + d)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (h, n, d), dtype="float32")).cuda().bfloat16()
            for n in (sq, sk, sk, sq))
        routes = (getattr(fa, "tc_launches", None),
                  getattr(fa, "bwd_tc_launches", None))
        o, lse = fa.attention_lse_kernel(q, k, v, causal)
        got = fa.attention_backward_kernel(q, k, v, o, lse, do, causal)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        want_o = ref.flash_attention(*leaves, causal=causal)
        want = torch.autograd.grad(want_o, leaves, do)
        fwd_err = float((o.float() - want_o.float()).abs().max())
        errs = [float((a.float() - b.float()).abs().max()
                      / b.float().abs().max()) for a, b in zip(got, want)]
        ok = ok and fwd_err <= BF16_FWD_TOL and all(
            e <= BF16_BWD_TOL for e in errs)
        del got, want, want_o, leaves
        torch.cuda.empty_cache()
        delta = fa.bwd_preprocess_kernel(o, do)
        pairs = allowed_pairs(h, sq, sk, causal)
        row = {"src": args.src, "label": label, "heads": h, "sq": sq,
               "sk": sk, "d": d, "causal": causal, "dtype": "bf16",
               "fwd_err": fwd_err,
               "bwd_max_rel_err": dict(zip(("dq", "dk", "dv"), errs))}
        for name, fn in (
                ("forward", lambda: fa.attention_lse_kernel(q, k, v,
                                                            causal)),
                ("backward", lambda: fa.attention_backward_kernel(
                    q, k, v, o, lse, do, causal)),
                ("flash_bwd_dkdv", lambda: fa.bwd_dkdv_kernel(
                    q, k, v, do, lse, delta, causal)),
                ("flash_bwd_dq", lambda: fa.bwd_dq_kernel(
                    q, k, v, do, lse, delta, causal))):
            ms = time_ms(fn)
            row[name] = {"ms": ms}
            if name in BF16_PASSES:
                b = (BF16_PASSES[name] * 2 * pairs * d / BF16_FLOP_PER_S
                     * 1e3)
                row[name].update(bound_bf16_ms=b, share_bf16=b / ms)
        row["agreement"] = route_agreement(fa, q, k, v, do, causal)
        row["routes"] = {
            "tc_launches": None if routes[0] is None
            else fa.tc_launches - routes[0],
            "bwd_tc_launches": None if routes[1] is None
            else fa.bwd_tc_launches - routes[1]}
        c = causal and sq == sk      # SDPA's mask is start-aligned
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(
                leaves[0][None], leaves[1][None], leaves[2][None],
                is_causal=c)
        with torch.no_grad():
            row["sdpa_forward_ms"] = time_ms(sdpa_fwd)
        row["sdpa_forward_backward_ms"] = time_ms(
            lambda: torch.autograd.grad(sdpa_fwd(), leaves, do[None]))
        print(json.dumps(row), flush=True)
        del q, k, v, do, o, lse, delta, leaves
        torch.cuda.empty_cache()
    return ok


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", default=here)
    p.add_argument("--backward", action="store_true",
                   help="time the backward kernels at BWD_SHAPES")
    p.add_argument("--shape", default="",
                   help="with --backward or --dtype bf16, the shapes whose "
                        "label starts with this")
    p.add_argument("--dtype", choices=("float32", "bf16"),
                   default="float32",
                   help="bf16: time the bf16 route at BF16_SHAPES")
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
    run = (bf16 if args.dtype == "bf16"
           else backward if args.backward else forward)
    ok = run(args, torch, F, fa)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())
    if not ok:
        print(f"bench_flash: a result passed its limit against the plain "
              f"version (float32: {TOL} forward, {BWD_REL_TOL} of max "
              f"|plain| backward; bf16: {BF16_FWD_TOL}, {BF16_BWD_TOL})",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
