"""Times the CUDA ``flash_attention`` kernel at several head widths.

Run on a machine with one NVIDIA card, from the repository root:

    python3 src/repro_torch/bench_flash.py [--src DIR]

It builds the kernels of ``DIR/repro_torch`` (the ``src`` directory beside
this file unless ``--src`` names another, so that one run can time two
versions of the kernel on one card). For each head width d in 64, 80 and
128 it makes causal float32 q, k, v of shape (32, 4096, d) from a seed
and prints one JSON line: the kernel's time (CUDA events over 20 warm
launches), the time of ``scaled_dot_product_attention`` on the same inputs
(a yardstick only), the bound (the multiply-adds of the allowed pairs over
the FP32 units' 67 TFLOP/s, or the bytes over 3.35 TB/s, whichever is
larger) and the largest difference from the plain version, which must stay
within 3e-5. The last line names the card and its power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
TOL = 3e-5                     # the reference tests' attention tolerance
SEED = 0
HEADS, SEQ = 32, 4096
HEAD_DIMS = (64, 80, 128)      # the kernel's widths past the smallest


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


def bound_ms(h, sq, sk, d):
    pairs = h * sum(min(sk, sk - sq + i + 1) for i in range(sq))
    t_ops = 4 * d * pairs / FP32_FLOP_PER_S * 1e3
    t_bytes = 4 * h * d * (2 * sq + 2 * sk) / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", default=here)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("bench_flash: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    _build.build()
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())
    if not ok:
        print(f"bench_flash: a result passed {TOL} of the plain version",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
