"""flash_attention — tiled online-softmax attention as a hand-written CUDA
kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (``pallas_call`` at line 68, body ``_masked_kernel`` at
line 83): q ``(h, sq, d)``, k and v ``(h, sk, d)`` with the kv heads
already broadcast, float32 or bfloat16, fp32 arithmetic, the output in q's
dtype. The causal mask is aligned to the end of the keys
(``q_off = sk - sq``), masked scores are -1e30, padded keys are masked,
key tiles that lie wholly past a query tile are skipped, and the output is
``acc / max(l, 1e-30)``.

Kernel: ``flash_kernel`` in ``csrc/flash_attention.cu``, entry point
``strela_flash_attention``: one block of 128 threads per (head,
``BLOCK_Q`` = 128-query tile) loops over ``BLOCK_K`` = 64-key tiles,
keeping m, l and the output rows in registers where the Pallas kernel
carries them in VMEM scratch across its sequential key axis. Each thread
owns an 8-query x 8-key block of scores and the same 8 queries' share of
the output columns, so each product does 64 FMAs per two float4 reads of
shared memory. K and V tiles arrive by ``cp.async`` into single buffers,
each overlapping the other product (two blocks per SM at d <= 64, one
above). Both products run on the FP32
units, never TF32: the reference tolerance is 3e-5; the softmax takes
2^x of scores in log2 units. d is 16, 64, 80 or 128.

Bound on the H100: operations (77.3 GFLOP for 36 causal heads at
sq = sk = 4096, d = 64, against 151 MB: 1.15 ms at 67 TFLOP/s).

Causal attention with ``sq > sk`` raises ``ValueError``: query rows then
have no allowed key, where the reference oracle gives NaN rows and the
Pallas kernel values that depend on its block sizes.

Beside it, the plain PyTorch version (``ref.flash_attention``) runs for
tensors on the CPU, and only there: a CUDA tensor launches the kernel or
raises. ``launches`` counts kernel launches, ``plain_calls`` calls of the
plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}     # csrc dtype codes
HEAD_DIMS = (16, 64, 80, 128)                     # the kernel's instances
BLOCK_Q = 128                  # queries per block (csrc/flash_attention.cu)
BLOCK_K = 64                   # keys per tile
NEG_INF = -1e30

launches = 0
plain_calls = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash_attention: q, k, v must be (heads, seq, "
                         f"head_dim), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    h, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != h or k.shape[2] != d:
        raise ValueError(f"flash_attention: k and v must be (heads, sk, "
                         f"head_dim) = ({h}, sk, {d}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: q, k, v must share a dtype in "
                         f"{sorted(map(str, DTYPES))}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    sk = k.shape[1]
    if sk == 0:
        raise ValueError("flash_attention: needs at least one key")
    if causal and sq > sk:
        raise ValueError(
            f"flash_attention: causal attention with sq={sq} > sk={sk} "
            f"leaves query rows with no allowed key (the mask is aligned "
            f"to the end of the keys); the reference gives NaN rows there")


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """The plain PyTorch version of :func:`attention_kernel`."""
    global plain_calls
    _check(q, k, v, causal)
    plain_calls += 1
    return ref.flash_attention(q, k, v, causal=causal)


def attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True) -> torch.Tensor:
    """Attention by the CUDA kernel: contiguous, 16-byte aligned CUDA
    tensors only."""
    global launches
    _check(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: the kernel runs on CUDA "
                         f"tensors, got {q.device}")
    h, sq, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"and 16-byte aligned")
    if h > 65535 or max(sq, sk) >= 2 ** 31:
        raise ValueError(f"flash_attention: at most 65535 heads and 2^31 "
                         f"positions, got h={h} sq={sq} sk={sk}")
    out = torch.empty_like(q)
    if h == 0 or sq == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.strela_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), h, sq,
            sk, d, DTYPES[q.dtype], int(causal), 1.0 / (d ** 0.5), stream)
    _build.check(lib, rc, f"flash_attention h={h} sq={sq} sk={sk} d={d}")
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal)
    return attention_kernel(q, k, v, causal)
