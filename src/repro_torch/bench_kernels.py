"""Times ``stream_matmul`` and the fabric kernels on the card.

Run on a machine with one NVIDIA card, from the repository root:

    python3 src/repro_torch/bench_kernels.py [--src DIR] [--only CASES]

It builds the kernels of ``DIR/repro_torch`` (the ``src`` directory beside
this file unless ``--src`` names another, so that one run can time two
versions of the kernels on one card, in turns). It prints one JSON line per
case, with inputs made from a seed:

- ``stream_matmul`` float32 at 4096 x 2304 x 5760 (minicpm-2b's gate/up
  projection over 4,096 tokens) beside ``torch.matmul`` on the same inputs,
  both with TF32 off; the bound is the multiply-adds over the FP32 units'
  67 TFLOP/s. The result must stay within 1e-5 of max|C| of the plain
  version.
- ``stream_matmul`` bfloat16 where TMA cannot address the rows as they lie
  (the ``wgmma_realign`` route, or whatever route ``DIR``'s rule picks):
  S1, 4096 x 2304 x 5760 with A one element past 16-byte alignment, and
  S2, granite-moe-3b-a800m's LM head at its unpadded vocabulary, 4096 x
  1536 x 49155 (N % 8 = 3), each with a float32 and a bfloat16 result,
  beside ``torch.matmul`` on the same tensors (bfloat16 out); the bound is
  the multiply-adds over the bf16 tensor cores' 989 TFLOP/s. Each result
  must stay within 1e-4 of max|C| of the plain version, plus one bf16
  rounding for a bf16 result.
- ``fabric_reduce_lanes`` on the engine's lane grids: PolyBench gemm MEDIUM
  (``mac3``, 14,800 lanes of 240), gesummv MEDIUM (``mac2x``, 250 x 250)
  and the one-shot mix's ``fft_butterfly`` (256 x 4096); the bound is the
  bytes over 3.35 TB/s. Results must equal the plain version's bit for bit.
- ``fabric_stream`` on relu and vadd at n = 2^24 beside ``torch.relu`` and
  ``torch.add`` (int32, which wraps the same way), and on
  ``fft_butterfly`` at n = 2^22 (4 streams in, 4 out, 18 table rows; no
  library call computes it), and on a copy DFG (out = x) at 2^24 beside
  ``clone``, which isolates the kernel's data movement from its
  interpretation; the bound is the bytes over 3.35 TB/s.
  Results must equal the plain version's, and the library call's, bit for
  bit. Besides the loop over one input set, each is timed over a rotation
  of ROTATE input sets (at least 512 MB with their outputs) whose outputs
  stay alive until their set comes round again, so that no call finds its
  data in the card's 50 MB L2; and by the host clock around one warm call
  and its synchronisation (median and range of WALL_CALLS calls).

- the optimizer's kernels (``kernels/adamw.py``) over minicpm-2b's 362
  bf16 leaves (2.73e9 parameters) with float32 moments: the update with a
  clipping scale and the norm, beside the plain loop (the eager clipping
  and update on the same tensors) and ``torch.optim.AdamW(fused=True)``
  stepping the same parameters and gradients (with bf16 moments, its own
  arithmetic: a yardstick only); the bound is the bytes over 3.35 TB/s,
  22 a parameter for the update and 2 for the norm. The update must equal
  the plain loop's bits over the first ADAMW_CHECKED leaves.

Each case gives the time by CUDA events over 20 warm calls (wrapper
included), the host's time to enqueue a call, and the device time per call
from ``torch.profiler`` with its split by kernel name. The last line names
the card and its power limit.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bfloat16 tensor cores
MM = (4096, 2304, 5760)
MM_HEAD = (4096, 1536, 49155)  # granite-moe-3b-a800m's unpadded LM head
MM_REL_TOL = 1e-5              # of max|C|, float32 at K = 2304
BF16_REL_TOL = 1e-4            # of max|C|, bfloat16 inputs
CASES = ("f32", "bf16", "lanes", "stream", "adamw")
ADAMW_CHECKED = 38             # bit-checked leaves: embed, norm, 4 layers
SEED = 0
REPS = 20
ROTATE = 4                     # input and output sets of a rotated loop
WALL_CALLS = 7


def time_ms(fn, reps=REPS, warm=3):
    """(events ms per call, host ms to enqueue one call)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host


def device_ms(fn, reps=5, per_call=False):
    """Device ms per call from torch.profiler, and its split by name: each
    name's time over the launches of it that the profiler recorded (in a
    long process it may record fewer than were made), so a call that
    launches each kernel once takes their sum. With ``per_call``, each
    name's time over the calls instead, for a call that launches a kernel
    several times."""
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
        if e.device_type == DeviceType.CUDA:
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


def wall_ms(fn, calls=WALL_CALLS):
    """(median, min, max) host ms of one warm call and its synchronise."""
    import torch
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), min(walls), max(walls)


def copy_dfg():
    """out = x: the kernel's data movement alone, beside ``clone``."""
    from repro_torch.core.dfg import DFG
    b = DFG.build("copy")
    b.out("out", b.inp("x"))
    return b.done()


def stream_cases():
    """(label, DFG, n, library call on the inputs or None)."""
    import torch
    from repro_torch.core import kernels_lib as K
    return (("relu", K.relu(), 1 << 24, lambda x: torch.relu(x["x"])),
            ("vadd", K.vadd(), 1 << 24,
             lambda x: torch.add(x["x"], x["y"])),
            ("fft_butterfly", K.fft_butterfly(), 1 << 22, None),
            ("copy", copy_dfg(), 1 << 24, lambda x: x["x"].clone()))


def bench_stream(src):
    import numpy as np
    import torch
    from repro_torch.kernels import fabric_stream as fs
    rng = np.random.default_rng(SEED + 2)
    ok, rows = True, []
    for label, g, n, library in stream_cases():
        sets = [{k: torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)).cuda()
            for k in g.inputs} for _ in range(ROTATE)]
        got = fs.stream_kernel(g, sets[0])
        want = fs.stream_plain(g, sets[0])
        exact = all(torch.equal(got[o], want[o]) for o in want)
        if library is not None:
            exact = exact and torch.equal(library(sets[0]),
                                          got[g.outputs[0]])
        ok = ok and exact
        n_io = len(g.inputs) + len(want)
        n_bytes = 4 * n * n_io
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        kernel = lambda x: fs.stream_kernel(g, x)         # noqa: E731
        row = {"src": src, "case": f"fabric_stream {label} n={n}",
               "bound_ms": bound, "bound_by": "bytes",
               "rotation_mb": ROTATE * n_bytes / 2 ** 20, "bit_exact": exact}
        for who, fn in (("", kernel), ("library_", library)):
            if fn is None:
                continue
            one = lambda fn=fn: fn(sets[0])               # noqa: E731
            row[f"{who}ms"], row[f"{who}host_ms"] = time_ms(one)
            row[f"{who}device_ms"], row[f"{who}by_name"] = device_ms(one)
            rot = rotation(fn, sets)
            # two rounds first: every output buffer allocated before timing
            row[f"{who}rot_ms"], _ = time_ms(rot, warm=2 * len(sets))
            row[f"{who}rot_device_ms"], row[f"{who}rot_by_name"] = \
                device_ms(rot)
            row[f"{who}wall_ms"] = wall_ms(one)
        row["share"] = bound / (row["rot_device_ms"] or row["rot_ms"])
        rows.append(row)
        del sets, got, want
        torch.cuda.empty_cache()
    return ok, rows


def bench_matmul(src):
    import numpy as np
    import torch
    from repro_torch.kernels import stream_matmul as sm
    M, K, N = MM
    rng = np.random.default_rng(SEED)
    a = torch.from_numpy(rng.standard_normal((M, K), dtype="float32")).cuda()
    b = torch.from_numpy(rng.standard_normal((K, N), dtype="float32")).cuda()
    want = sm.matmul_plain(a, b)
    scale = float(want.abs().max())
    err = float((sm.matmul_kernel(a, b) - want).abs().max())
    del want
    torch.cuda.empty_cache()
    ms, host = time_ms(lambda: sm.matmul_kernel(a, b))
    dev, names = device_ms(lambda: sm.matmul_kernel(a, b))
    lib_ms, _ = time_ms(lambda: torch.matmul(a, b))
    bound = 2 * M * N * K / FP32_FLOP_PER_S * 1e3
    ok = err <= MM_REL_TOL * scale
    return ok, {"src": src, "case": f"stream_matmul f32 {M}x{K}x{N}",
                "ms": ms, "host_ms": host, "device_ms": dev,
                "by_name": names, "library_ms": lib_ms, "bound_ms": bound,
                "bound_by": "operations", "share": bound / ms,
                "vs_library": ms / lib_ms, "max_abs_err": err,
                "limit": MM_REL_TOL * scale}


def bench_bf16(src):
    """S1 and S2, each with a float32 and a bfloat16 result."""
    import torch
    from repro_torch.kernels import stream_matmul as sm
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 3)
    ok, rows = True, []
    for label, (M, K, N), off in (("S1 A off alignment", MM, 1),
                                  ("S2 lm head", MM_HEAD, 0)):
        a = torch.randn(M * K + off, device="cuda", generator=g).to(
            torch.bfloat16)[off:].view(M, K)
        b = torch.randn((K, N), device="cuda", generator=g).to(
            torch.bfloat16)
        want = sm.matmul_plain(a, b)
        atol = BF16_REL_TOL * float(want.abs().max())
        row = {"src": src, "case": f"stream_matmul bf16 {label} {M}x{K}x{N}",
               "route": sm.route(a, b), "limit": atol}
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            got = sm.matmul_kernel(a, b, dt).float()
            w = want.to(dt).float()
            rtol = 2 ** -7 if dt == torch.bfloat16 else 0.0
            row[f"{name}_max_abs_err"] = float((got - w).abs().max())
            ok = ok and bool(((got - w).abs() <= atol + rtol * w.abs()).all())
            del got, w
            row[f"{name}_ms"], row[f"{name}_host_ms"] = time_ms(
                lambda dt=dt: sm.matmul_kernel(a, b, dt))
            row[f"{name}_device_ms"], row[f"{name}_by_name"] = device_ms(
                lambda dt=dt: sm.matmul_kernel(a, b, dt))
        del want
        torch.cuda.empty_cache()
        row["library_ms"], _ = time_ms(lambda: torch.matmul(a, b))
        row["bound_ms"] = 2 * M * N * K / BF16_FLOP_PER_S * 1e3
        row["bound_by"] = "operations"
        row["share"] = row["bound_ms"] / row["f32_ms"]
        row["vs_library"] = row["f32_ms"] / row["library_ms"]
        rows.append(row)
        del a, b
        torch.cuda.empty_cache()
    return ok, rows


def lane_grids():
    from repro_torch.core import kernels_lib as K
    return (("gemm mac3", K.mac3(240), 200 * -(-220 // 3), 240),
            ("gesummv mac2x", K.mac2x(250), 250, 250),
            ("fft", K.fft_butterfly(), 256, 4096))


def bench_lanes(src):
    import numpy as np
    import torch
    from repro_torch.kernels import fabric_reduce as fr
    rng = np.random.default_rng(SEED + 1)
    ok, rows = True, []
    for label, g, n_lanes, length in lane_grids():
        ins = {k: torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, (n_lanes, length), dtype=np.int64)
            .astype(np.int32)).cuda() for k in g.inputs}
        kf, kr = fr.reduce_lanes(g, ins)
        pf, pr = fr.reduce_lanes_plain(g, ins)
        exact = (all(torch.equal(kf[o], pf[o]) for o in pf)
                 and all(torch.equal(kr[r], pr[r]) for r in pr))
        ok = ok and exact
        ms, host = time_ms(lambda: fr.reduce_lanes(g, ins))
        dev, names = device_ms(lambda: fr.reduce_lanes(g, ins))
        n_el = n_lanes * length
        n_bytes = 4 * (n_el * len(g.inputs) + n_el * len(pf)
                       + n_lanes * len(pr))
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        rows.append({"src": src, "case": f"fabric_reduce_lanes {label} "
                                         f"{n_lanes}x{length}",
                     "ms": ms, "host_ms": host, "device_ms": dev,
                     "by_name": names, "bound_ms": bound, "bound_by": "bytes",
                     "share": bound / (dev or ms), "bit_exact": exact})
    return ok, rows


def bench_adamw(src):
    """The update and the norm over minicpm-2b's leaves, beside the plain
    loop and the library's fused AdamW."""
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
    hyper = (0.9, 0.95, 1e-8, 0.1)

    # the bit check on copies of the first leaves
    k = ADAMW_CHECKED
    kern = [[t.clone() for t in ts[:k]] for ts in (params, mu, nu)]
    plain = [[t.clone() for t in ts[:k]] for ts in (params, mu, nu)]
    torch.ops.strela.adamw_(*kern, grads[:k], lr, b1c, b2c, scale, *hyper)
    K.update_plain(*plain, grads[:k], lr, b1c, b2c, scale, *hyper)
    exact = all(torch.equal(a, b) for a, b in zip(sum(kern, []),
                                                  sum(plain, [])))
    del kern, plain
    torch.cuda.empty_cache()

    def update():
        torch.ops.strela.adamw_(params, mu, nu, grads, lr, b1c, b2c, scale,
                                *hyper)

    def norm():
        return K.global_sq_norm(grads)

    def eager():
        total = K.sq_norm_plain(grads)
        norm_ = torch.sqrt(total)
        s = torch.clamp(1.0 / (norm_ + 1e-9), max=1.0)
        K.update_plain(params, mu, nu,
                       [(g.float() * s).to(g.dtype) for g in grads], lr,
                       b1c, b2c, None, *hyper)
    rows = []
    for label, fn, per_param, reps in (("update", update, 22, REPS),
                                       ("norm", norm, 2, REPS),
                                       ("plain", eager, 24, 3)):
        ms, host = time_ms(fn, reps=reps, warm=1)
        dev, names = device_ms(fn, reps=min(reps, 5), per_call=True)
        launches = (K.adamw_launches, K.sq_norm_launches)
        fn()
        launches = (K.adamw_launches - launches[0],
                    K.sq_norm_launches - launches[1])
        bound = per_param * n / HBM_BYTES_PER_S * 1e3
        rows.append({"src": src, "case": f"adamw {label} minicpm-2b "
                                         f"{len(shapes)} leaves n={n}",
                     "ms": ms, "host_ms": host, "device_ms": dev,
                     "by_name": dict(sorted(names.items(),
                                            key=lambda kv: -kv[1])[:6]),
                     "launches": launches, "bound_ms": bound,
                     "bound_by": "bytes", "share": bound / (dev or ms),
                     "bit_exact": exact})
    del mu, nu
    torch.cuda.empty_cache()
    leaves = [torch.nn.Parameter(p) for p in params]
    for p, g in zip(leaves, grads):
        p.grad = g
    lib = torch.optim.AdamW(leaves, lr=1e-3, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=0.1, fused=True)
    lib_ms, lib_host = time_ms(lib.step, reps=5, warm=1)
    lib_dev, _ = device_ms(lib.step, reps=3, per_call=True)
    rows.append({"src": src, "case": "adamw library torch.optim.AdamW("
                 "fused=True), bf16 moments", "library_ms": lib_ms,
                 "library_host_ms": lib_host, "library_device_ms": lib_dev})
    return exact, rows


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", default=here)
    p.add_argument("--only", default=",".join(CASES),
                   help=f"comma-separated cases of {CASES}")
    args = p.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(CASES):
        p.error(f"--only takes cases of {CASES}, got {args.only}")
    sys.path.insert(0, os.path.abspath(args.src))

    import torch
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    _build.build()
    ok = True
    for case, bench in (("f32", bench_matmul), ("bf16", bench_bf16),
                        ("lanes", bench_lanes), ("stream", bench_stream),
                        ("adamw", bench_adamw)):
        if case not in only:
            continue
        ok_case, rows = bench(args.src)
        ok = ok and ok_case
        for row in rows if isinstance(rows, list) else [rows]:
            print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())
    if not ok:
        print("bench_kernels: a result disagreed with the plain version",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
