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

The gradient: :class:`FlashAttentionFn` (``torch.autograd.Function``)
runs the forward kernel with a float32 ``lse`` (each row's log-sum-exp in
natural-log units) and saves q, k, v, o and lse; its backward runs three
hand-written kernels of the same source, deterministic and without
atomics: ``flash_bwd_preprocess`` (D = rowsum(dO o O)),
``flash_bwd_dkdv_kernel`` (a block per 64-key tile looping over the query
tiles that see it) and ``flash_bwd_dq_kernel`` (a block per 64-query tile
looping over its key tiles), each recomputing P from q, k and lse. Their
products run on the TF32 tensor cores (``mma.sync`` m16n8k8) in three
passes on hi/lo splits of each float32 operand, which keeps them float32
grade; P and dS stay in registers between products, and the streamed
tiles arrive by ``cp.async`` into double buffers. The Pallas kernel is
forward only: the reference trains through XLA's derivative of its
attention, which these kernels stand in for. Bound: operations, 5
products of 2 sq sk d, halved under the causal mask, at 495 / 3 TFLOP/s
(67 on the FP32 units). :func:`flash_attention` takes the Function
whenever grad mode is on and an input requires a gradient;
:func:`attention_kernel` raises then, since its output would carry no
graph.

Beside them, the plain PyTorch versions (``ref.flash_attention``,
``ref.flash_attention_lse``, ``ref.flash_attention_backward``) run for
tensors on the CPU, and only there: a CUDA tensor launches the kernels or
raises. ``launches`` counts forward launches, ``bwd_*_launches`` each
backward kernel's, ``plain_calls`` and ``backward_plain_calls`` calls of
the plain versions.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}     # csrc dtype codes
HEAD_DIMS = (16, 64, 80, 128)                     # the kernel's instances
BLOCK_Q = 128                  # queries per block (csrc/flash_attention.cu)
BLOCK_K = 64                   # keys per tile
NEG_INF = -1e30

launches = 0                   # flash_kernel, with or without lse
plain_calls = 0
bwd_preprocess_launches = 0
bwd_dkdv_launches = 0
bwd_dq_launches = 0
backward_plain_calls = 0


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


def _check_kernel_inputs(tensors: Dict[str, torch.Tensor], d: int) -> None:
    """CUDA tensors on one device, contiguous and 16-byte aligned, and a
    head_dim the kernels are instantiated for."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"flash_attention: the kernel runs on CUDA "
                         f"tensors, all on one device, got "
                         f"{sorted(map(str, devices))}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"and 16-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, with_lse: bool):
    """One launch of ``flash_kernel``: the output and, with ``with_lse``,
    the rows' float32 log-sum-exp ``(h, sq)`` (else None)."""
    global launches
    _check(q, k, v, causal)
    h, sq, d = q.shape
    sk = k.shape[1]
    _check_kernel_inputs({"q": q, "k": k, "v": v}, d)
    if h > 65535 or max(sq, sk) >= 2 ** 31:
        raise ValueError(f"flash_attention: at most 65535 heads and 2^31 "
                         f"positions, got h={h} sq={sq} sk={sk}")
    out = torch.empty_like(q)
    lse = (torch.empty((h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if h == 0 or sq == 0:
        return out, lse
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.strela_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, h, sq, sk, d,
            DTYPES[q.dtype], int(causal), 1.0 / (d ** 0.5), _stream(q))
    _build.check(lib, rc, f"flash_attention h={h} sq={sq} sk={sk} d={d}")
    launches += 1
    return out, lse


def attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True) -> torch.Tensor:
    """Attention by the CUDA kernel: contiguous, 16-byte aligned CUDA
    tensors only. An input that requires a gradient, with grad mode on,
    raises: the kernel writes through a raw pointer, so its output would
    carry no graph (:func:`flash_attention` takes
    :class:`FlashAttentionFn` then)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention: attention_kernel returns no "
                         "gradient; an input requires one, so call "
                         "flash_attention (FlashAttentionFn) instead")
    return _forward_kernel(q, k, v, causal, False)[0]


def attention_lse_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's output and its rows' log-sum-exp (natural-log
    units, float32 ``(h, sq)``), as the backward needs them."""
    return _forward_kernel(q, k, v, causal, True)


def bwd_preprocess_kernel(o: torch.Tensor, do: torch.Tensor
                          ) -> torch.Tensor:
    """``flash_bwd_preprocess``: D = rowsum(dO o O) in float32, shape
    ``o.shape[:-1]``."""
    global bwd_preprocess_launches
    if o.shape != do.shape or o.dtype != do.dtype or o.dtype not in DTYPES:
        raise ValueError(f"flash_attention backward: o and dO must share a "
                         f"shape and a dtype in {sorted(map(str, DTYPES))}, "
                         f"got {tuple(o.shape)} {o.dtype} and "
                         f"{tuple(do.shape)} {do.dtype}")
    _check_kernel_inputs({"o": o, "dO": do}, o.shape[-1])
    delta = torch.empty(o.shape[:-1], dtype=torch.float32, device=o.device)
    rows = delta.numel()
    if rows == 0:
        return delta
    lib = _build.load()
    with torch.cuda.device(o.device):
        rc = lib.strela_flash_bwd_preprocess(
            o.data_ptr(), do.data_ptr(), delta.data_ptr(), rows, o.shape[-1],
            DTYPES[o.dtype], _stream(o))
    _build.check(lib, rc, f"flash_bwd_preprocess rows={rows}")
    bwd_preprocess_launches += 1
    return delta


def _check_backward(q, k, v, do, lse, delta, causal) -> None:
    _check(q, k, v, causal)
    h, sq, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"flash_attention backward: dO must be q's shape "
                         f"and dtype {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("D", delta)):
        if t.shape != (h, sq) or t.dtype != torch.float32:
            raise ValueError(f"flash_attention backward: {name} must be "
                             f"float32 ({h}, {sq}), got {tuple(t.shape)} "
                             f"{t.dtype}")
    _check_kernel_inputs({"q": q, "k": k, "v": v, "dO": do, "lse": lse,
                          "D": delta}, d)


def bwd_dkdv_kernel(q, k, v, do, lse, delta, causal: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_bwd_dkdv_kernel``: dK and dV in k's and v's dtype."""
    global bwd_dkdv_launches
    _check_backward(q, k, v, do, lse, delta, causal)
    h, sq, d = q.shape
    sk = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if h == 0 or sq == 0:
        return dk.zero_(), dv.zero_()
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.strela_flash_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            h, sq, sk, d, DTYPES[q.dtype], int(causal), 1.0 / (d ** 0.5),
            _stream(q))
    _build.check(lib, rc, f"flash_bwd_dkdv h={h} sq={sq} sk={sk} d={d}")
    bwd_dkdv_launches += 1
    return dk, dv


def bwd_dq_kernel(q, k, v, do, lse, delta, causal: bool = True
                  ) -> torch.Tensor:
    """``flash_bwd_dq_kernel``: dQ in q's dtype."""
    global bwd_dq_launches
    _check_backward(q, k, v, do, lse, delta, causal)
    h, sq, d = q.shape
    sk = k.shape[1]
    dq = torch.empty_like(q)
    if h == 0 or sq == 0:
        return dq
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.strela_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), h, sq, sk, d,
            DTYPES[q.dtype], int(causal), 1.0 / (d ** 0.5), _stream(q))
    _build.check(lib, rc, f"flash_bwd_dq h={h} sq={sq} sk={sk} d={d}")
    bwd_dq_launches += 1
    return dq


def attention_backward_kernel(q, k, v, o, lse, do, causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """dq, dk, dv by the three backward kernels, in the inputs' dtypes."""
    delta = bwd_preprocess_kernel(o, do)
    dk, dv = bwd_dkdv_kernel(q, k, v, do, lse, delta, causal)
    return bwd_dq_kernel(q, k, v, do, lse, delta, causal), dk, dv


def attention_backward_plain(q, k, v, o, lse, do, causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The plain version of :func:`attention_backward_kernel`."""
    global backward_plain_calls
    backward_plain_calls += 1
    dq, dk, dv = ref.flash_attention_backward(q, k, v, o, lse, do, causal)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a gradient: the forward kernel with its log-sum-exp,
    and the three backward kernels, for CUDA tensors; the plain versions
    (``ref.flash_attention_lse``, ``ref.flash_attention_backward``) for CPU
    tensors, and only there. Saves q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        global plain_calls
        if q.device.type == "cpu":
            _check(q, k, v, causal)
            plain_calls += 1
            o, lse = ref.flash_attention_lse(q, k, v, causal)
        else:
            o, lse = attention_lse_kernel(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()             # autograd may hand a strided view
        back = (attention_backward_plain if q.device.type == "cpu"
                else attention_backward_kernel)
        dq, dk, dv = back(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors; through :class:`FlashAttentionFn`
    when grad mode is on and an input requires a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal)
    return attention_kernel(q, k, v, causal)
