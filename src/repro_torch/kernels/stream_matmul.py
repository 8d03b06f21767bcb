"""stream_matmul — ``C = A @ B`` as hand-written CUDA kernels for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/stream_matmul.py::
stream_matmul`` (``pallas_call`` at line 68, body ``_mm_kernel`` at line
30): A ``(M, K)`` times B ``(K, N)``, float32 or bfloat16 inputs, fp32
accumulation over K, the result written as ``out_dtype``.

Kernel: ``csrc/stream_matmul.cu``, entry point ``strela_stream_matmul``.
float32 inputs run a register-blocked SGEMM on the FP32 units (never TF32:
the reference tolerance is 1e-4); bfloat16 inputs run ``mma.sync`` tiles
on the tensor cores with fp32 accumulators. Each block loops over K
itself, where the Pallas kernel carries a VMEM accumulator across its
sequential k grid axis, and the ragged M, N and K edges are masked in the
kernel instead of zero-padding copies of A and B. The TPU block sizes
``bm``/``bn``/``bk`` are therefore no parameters here.

Bound on the H100: operations at the main path's shapes (108.7 GFLOP at
4096 x 2304 x 5760 against 185 MB), so the tiles are sized to keep the
arithmetic units fed from shared memory and registers.

Beside it, the plain PyTorch version (``ref.matmul``) runs for tensors on
the CPU, and only there: a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches, ``plain_calls`` calls of the plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}     # csrc dtype codes

launches = 0
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


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain PyTorch version of :func:`matmul_kernel`."""
    global plain_calls
    _check(a, b, out_dtype)
    plain_calls += 1
    return ref.matmul(a, b).to(out_dtype)


def matmul_kernel(a: torch.Tensor, b: torch.Tensor,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``A @ B`` by the CUDA kernel: contiguous CUDA tensors only."""
    global launches
    _check(a, b, out_dtype)
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
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.strela_stream_matmul(a.data_ptr(), b.data_ptr(),
                                      c.data_ptr(), M, N, K, DTYPES[a.dtype],
                                      DTYPES[out_dtype], stream)
    _build.check(lib, rc, f"stream_matmul {M}x{K}x{N}")
    launches += 1
    return c


def stream_matmul(a: torch.Tensor, b: torch.Tensor,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``C = A @ B`` on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if a.device.type == "cpu":
        return matmul_plain(a, b, out_dtype)
    return matmul_kernel(a, b, out_dtype)
