"""stream_matmul — ``C = A @ B`` as hand-written CUDA kernels for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/stream_matmul.py::
stream_matmul`` (``pallas_call`` at line 68, body ``_mm_kernel`` at line
30): A ``(M, K)`` times B ``(K, N)``, float32 or bfloat16 inputs, fp32
accumulation over K, the result written as ``out_dtype``.

Kernels: ``csrc/stream_matmul.cu``, entry point ``strela_stream_matmul``,
one of three routes chosen by :func:`route` from dtype, shape and
alignment alone:

- ``"sgemm"`` (float32 inputs): an SGEMM on the FP32 units, never TF32
  (the reference tolerance is 1e-4): 128 x 128 tiles, two blocks per SM,
  a 4-stage ``cp.async`` ring of 16-deep k tiles, warp-tiled 8 x 8 sums
  per thread, blocks rasterised in groups of 8 M tiles.
- ``"wgmma"`` (bfloat16 inputs, :func:`bf16_route`: K and N multiples of
  8, A and B 16-byte aligned, none of M, N, K empty): a TMA ring of
  128 x 256 x 64 tiles, four stages, feeding two ``wgmma`` warpgroups
  from one producer thread; TMA zero-fills the ragged edges.
- ``"wgmma_realign"`` (every other bfloat16 case: K or N not a multiple
  of 8, or a base address off 16-byte alignment): a hand-written kernel
  (``repack_rows_kernel``) copies each operand TMA cannot address as it
  lies into device scratch with rows a multiple of 8 elements apart, each
  16-byte word shifted into place from two aligned words of the source,
  and the ``"wgmma"`` kernel then reads the copies through maps that end
  at the operand's own last column, so TMA's zero fill still gives the
  padded sums. It is the second route, not a fallback: the rule above
  picks it before the launch, and the C side refuses a ``"wgmma"``
  request whose conditions fail (and code 1, a retired ``mma.sync``
  route).

Each block loops over K itself, where the Pallas kernel carries a VMEM
accumulator across its sequential k grid axis, and the ragged M, N and K
edges are handled in the kernel instead of zero-padded copies of A and
B. The TPU block sizes ``bm``/``bn``/``bk`` are therefore no parameters
here.

Bound on the H100: operations at the main path's shapes (108.7 GFLOP at
4096 x 2304 x 5760: 1.62 ms at 67 TFLOP/s in float32, 0.110 ms at 989
TFLOP/s on the bf16 tensor cores, against 0.042 ms for the 139.8 MB of
bf16 A, B and f32 C).

Beside it, the plain PyTorch version (``ref.matmul``) runs for tensors on
the CPU, and only there: a CUDA tensor launches a kernel or raises.
``launches`` counts kernel launches, ``sgemm_launches``,
``wgmma_launches`` and ``wgmma_realign_launches`` those of each route,
and ``plain_calls`` calls of the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}     # csrc dtype codes
ROUTES = {"sgemm": 0, "wgmma": 2, "wgmma_realign": 3}   # csrc route codes

launches = 0
sgemm_launches = 0
wgmma_launches = 0
wgmma_realign_launches = 0
plain_calls = 0


def _check(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> None:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"stream_matmul: A and B must be 2-D, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"stream_matmul: inner dimensions differ, A "
                         f"{tuple(a.shape)} and B {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in DTYPES:
        raise ValueError(f"stream_matmul: A and B must share a dtype in "
                         f"{sorted(map(str, DTYPES))}, got {a.dtype} and "
                         f"{b.dtype}")
    if out_dtype not in DTYPES:
        raise ValueError(f"stream_matmul: out_dtype must be one of "
                         f"{sorted(map(str, DTYPES))}, got {out_dtype}")
    if a.device != b.device:
        raise ValueError(f"stream_matmul: A on {a.device}, B on {b.device}")


def bf16_route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The route of a bfloat16 product: ``"wgmma"`` where TMA can address
    every row of A ``(M, K)`` and B ``(K, N)`` (row strides of 16-byte
    multiples, ``K % 8 == 0`` and ``N % 8 == 0``; base addresses 16-byte
    aligned) and no dimension is empty, else ``"wgmma_realign"``."""
    (M, K), N = a.shape, b.shape[1]
    if (min(M, N, K) >= 1 and K % 8 == 0 and N % 8 == 0
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0):
        return "wgmma"
    return "wgmma_realign"


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel that ``matmul_kernel`` launches for these inputs."""
    return "sgemm" if a.dtype == torch.float32 else bf16_route(a, b)


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain PyTorch version of :func:`matmul_kernel`."""
    global plain_calls
    _check(a, b, out_dtype)
    plain_calls += 1
    return ref.matmul(a, b).to(out_dtype)


def matmul_kernel(a: torch.Tensor, b: torch.Tensor,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``A @ B`` by the CUDA kernel of :func:`route`: contiguous CUDA
    tensors only."""
    return _launch_route(a, b, out_dtype, route(a, b))


def _launch_route(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype,
                  r: str) -> torch.Tensor:
    """``A @ B`` by the kernel of route ``r`` (a key of ``ROUTES``); the C
    side refuses a route whose conditions these inputs fail. :func:`route`
    is the one public way to choose a route: naming one here exists only
    for the tests of the C side's checks."""
    global launches, sgemm_launches, wgmma_launches, wgmma_realign_launches
    _check(a, b, out_dtype)
    if r not in ROUTES:
        raise ValueError(f"stream_matmul: route must be one of "
                         f"{sorted(ROUTES)}, got {r!r}")
    if a.device.type != "cuda":
        raise ValueError(f"stream_matmul: the kernel runs on CUDA tensors, "
                         f"got {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("stream_matmul: A and B must be contiguous")
    (M, K), N = a.shape, b.shape[1]
    if max(M, N, K) >= 2 ** 31:
        raise ValueError(f"stream_matmul: dimensions must stay below 2^31, "
                         f"got M={M} N={N} K={K}")
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return c
    lib = _build.load()
    # the realign route's copies of the operands TMA cannot address as
    # they lie, on the caching allocator
    n_scratch = (lib.strela_stream_matmul_scratch(
        a.data_ptr(), b.data_ptr(), M, N, K) if r == "wgmma_realign" else 0)
    scratch = (torch.empty(n_scratch, dtype=torch.uint8, device=a.device)
               if n_scratch else None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.strela_stream_matmul(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
            DTYPES[a.dtype], DTYPES[out_dtype], ROUTES[r],
            None if scratch is None else scratch.data_ptr(), n_scratch,
            stream)
    _build.check(lib, rc, f"stream_matmul {M}x{K}x{N} ({r})")
    launches += 1
    if r == "wgmma":
        wgmma_launches += 1
    elif r == "wgmma_realign":
        wgmma_realign_launches += 1
    else:
        sgemm_launches += 1
    return c


def stream_matmul(a: torch.Tensor, b: torch.Tensor,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``C = A @ B`` on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if a.device.type == "cpu":
        return matmul_plain(a, b, out_dtype)
    return matmul_kernel(a, b, out_dtype)
