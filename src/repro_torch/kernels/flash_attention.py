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

The bf16 tensor-core route (:func:`tc_route`: bfloat16 inputs at d = 64
or 128 with at least ``TC_MIN_QUERIES`` = 64 queries; d = 16 and 80, and a
decode step's single query, where the route measured slower, take the
kernels above) runs the same three products on the bf16 tensor cores at
the same float32-grade contract: ``flash_kernel_tc`` (entry point
``strela_flash_attention_tc``), ``flash_bwd_dkdv_kernel_tc`` and
``flash_bwd_dq_kernel_tc``; ``flash_bwd_preprocess`` is shared. S and dP
take one bf16 pass (a product of two bfloat16 is exact in float32); P and
dS, formed in float32 as above, split into three bfloat16 pieces (hi =
bf16_rn(x), mid = bf16_rn(x - hi), lo = bf16_rn(x - hi - mid)), and each
of O, dV, dQ, dK runs as three passes into one float32 accumulator,
smallest piece first. ``flash_bwd_preprocess`` reads O as the forward
wrote it, in bfloat16, so D = rowsum(dO o O) is bfloat16-grade on this
route: it moves dQ and dK by up to 2^-8 of max |dQ|, |dK| (the order of
their own rounding to bfloat16) and leaves dV as it is. A block is 384
threads: a producer warpgroup whose
one thread keeps a ring of ``kTcStages`` = 2 stages full by TMA and two
consumer warpgroups of 64 rows each issuing ``wgmma`` (setmaxnreg: 40
for the producer, 232 for each consumer; ptxas holds every thread to
168). Tiles: the forward 128 queries a block against 64-key tiles; dq
128 queries against 64-key tiles; dkdv 128 keys and one 64-column box of
dK and dV a block (a grid of d / 64 boxes) against 32-query tiles with
their lse and D. Shared memory, bytes (d = 64 / 128): forward 50,216 /
99,368, dq 66,600 / 132,136, dkdv 52,264 / 101,416. One launch a forward
and three a backward, as on the float32 route, no atomics, bit-identical
runs. ``tc_launches`` counts forward launches on the route and
``bwd_tc_launches`` backward calls on it, one a call (each also as the
``obs`` counter ``flash.tc_launches`` / ``flash.bwd_tc_launches``);
``bwd_dkdv_tc_launches`` and ``bwd_dq_tc_launches`` count each backward
kernel's launches on the route, where the wrappers launch them. On
the H100 at 36 heads x 4,096 x 64, causal: forward 0.454 ms, backward
1.363 ms, against 2.44 and 5.57 ms for the kernels above on the same bf16
inputs.

Beside them, the plain PyTorch versions (``ref.flash_attention``,
``ref.flash_attention_lse``, ``ref.flash_attention_backward``) run for
tensors on the CPU, and only there: a CUDA tensor launches the kernels or
raises. ``launches`` counts forward launches (either route),
``bwd_*_launches`` each backward kernel's, ``plain_calls`` and
``backward_plain_calls`` calls of the plain versions.

The dispatcher knows the kernels as three operators (``torch.library``):
``strela::flash_fwd(q, k, v, causal) -> (o, lse)`` and
``strela::flash_bwd(q, k, v, o, lse, dout, causal) -> (dq, dk, dv)``,
which :class:`FlashAttentionFn` calls, and ``strela::flash_attn(q, k, v,
causal) -> o``, the forward without lse that :func:`flash_attention`
calls without a gradient. Each has the kernel's launch as its CUDA
implementation, the plain version as its CPU one, and a fake one that
gives shapes and dtypes only (``o`` like ``q``, ``lse`` float32 ``(h,
sq)``), so ``FakeTensorMode`` (the dry run) runs through them without
touching a pointer; ``torch.utils.flop_counter`` counts them with SDPA's
formulas: 4 bh sq sk d forward, 10 bh sq sk d backward, no causal
discount. There is no fallback: a launch that fails raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch import obs
from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}     # csrc dtype codes
HEAD_DIMS = (16, 64, 80, 128)                     # the kernel's instances
TC_HEAD_DIMS = (64, 128)       # the bf16 tensor-core route's instances
TC_MIN_QUERIES = 64            # fewer queries (decode) take today's kernels
BLOCK_Q = 128                  # queries per block (csrc/flash_attention.cu)
BLOCK_K = 64                   # keys per tile
NEG_INF = -1e30

launches = 0                   # flash_kernel, with or without lse
plain_calls = 0
bwd_preprocess_launches = 0
bwd_dkdv_launches = 0
bwd_dq_launches = 0
backward_plain_calls = 0
tc_launches = 0                # forward launches on the bf16 route
bwd_tc_launches = 0            # backward calls on the bf16 route, one a call
bwd_dkdv_tc_launches = 0       # of bwd_dkdv_launches, those on the route
bwd_dq_tc_launches = 0         # of bwd_dq_launches, those on the route


def tc_route(q: torch.Tensor, sk: int) -> bool:
    """Whether attention over q ``(h, sq, d)`` and sk keys takes the bf16
    tensor-core kernels: bfloat16 at d = 64 or 128, at least
    ``TC_MIN_QUERIES`` queries (a decode step's single query keeps
    today's kernel, which is faster there), and h max(sq, sk) below 2^31
    (the flat lse map's 32-bit coordinates). Chosen by what the wrapper
    can see, the dtype and the shape."""
    h, sq, d = q.shape
    return (q.dtype == torch.bfloat16 and d in TC_HEAD_DIMS
            and sq >= TC_MIN_QUERIES and h * max(sq, sk) < 2 ** 31)


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


def _check_kernel_inputs(tensors: Dict[str, torch.Tensor], d: int,
                         aligned: bool = True) -> None:
    """CUDA tensors on one device, contiguous and (with ``aligned``)
    16-byte aligned, and a head_dim the kernels are instantiated for."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"flash_attention: the kernel runs on CUDA "
                         f"tensors, all on one device, got "
                         f"{sorted(map(str, devices))}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    for name, t in tensors.items():
        if not t.is_contiguous() or (aligned and t.data_ptr() % 16):
            raise ValueError(f"flash_attention: {name} must be contiguous"
                             f"{' and 16-byte aligned' if aligned else ''}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(entry: str, tc: bool, args: tuple, q: torch.Tensor,
            causal: bool) -> int:
    """``entry`` (``strela_flash_*``), or on the bf16 route ``entry +
    "_tc"``, which takes no dtype code, with the arguments every flash
    entry point ends with; returns the CUDA error code."""
    lib = _build.load()
    tail = (int(causal), 1.0 / (q.shape[-1] ** 0.5), _stream(q))
    with torch.cuda.device(q.device):
        if tc:
            return getattr(lib, entry + "_tc")(*args, *tail)
        return getattr(lib, entry)(*args, DTYPES[q.dtype], *tail)


def _forward_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, with_lse: bool):
    """One launch of ``flash_kernel`` (``flash_kernel_tc`` on the bf16
    route): the output and, with ``with_lse``, the rows' float32
    log-sum-exp ``(h, sq)`` (else None)."""
    global launches, tc_launches
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
    tc = tc_route(q, sk)
    rc = _launch("strela_flash_attention", tc, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, h, sq, sk, d), q, causal)
    _build.check(_build.load(), rc,
                 f"flash_attention h={h} sq={sq} sk={sk} d={d}")
    launches += 1
    if tc:
        tc_launches += 1
        obs.inc("flash.tc_launches")
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
    ``o.shape[:-1]``. Any base address: the kernel reads a base off
    16-byte alignment element by element, in the same order of sums."""
    global bwd_preprocess_launches
    if o.shape != do.shape or o.dtype != do.dtype or o.dtype not in DTYPES:
        raise ValueError(f"flash_attention backward: o and dO must share a "
                         f"shape and a dtype in {sorted(map(str, DTYPES))}, "
                         f"got {tuple(o.shape)} {o.dtype} and "
                         f"{tuple(do.shape)} {do.dtype}")
    _check_kernel_inputs({"o": o, "dO": do}, o.shape[-1], aligned=False)
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
    """``flash_bwd_dkdv_kernel`` (``flash_bwd_dkdv_kernel_tc`` on the bf16
    route): dK and dV in k's and v's dtype."""
    global bwd_dkdv_launches, bwd_dkdv_tc_launches
    _check_backward(q, k, v, do, lse, delta, causal)
    h, sq, d = q.shape
    sk = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if h == 0 or sq == 0:
        return dk.zero_(), dv.zero_()
    tc = tc_route(q, sk)
    rc = _launch("strela_flash_bwd_dkdv", tc, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), h,
        sq, sk, d), q, causal)
    _build.check(_build.load(), rc,
                 f"flash_bwd_dkdv h={h} sq={sq} sk={sk} d={d}")
    bwd_dkdv_launches += 1
    bwd_dkdv_tc_launches += tc
    return dk, dv


def bwd_dq_kernel(q, k, v, do, lse, delta, causal: bool = True
                  ) -> torch.Tensor:
    """``flash_bwd_dq_kernel`` (``flash_bwd_dq_kernel_tc`` on the bf16
    route): dQ in q's dtype."""
    global bwd_dq_launches, bwd_dq_tc_launches
    _check_backward(q, k, v, do, lse, delta, causal)
    h, sq, d = q.shape
    sk = k.shape[1]
    dq = torch.empty_like(q)
    if h == 0 or sq == 0:
        return dq
    tc = tc_route(q, sk)
    rc = _launch("strela_flash_bwd_dq", tc, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), h, sq, sk, d), q,
        causal)
    _build.check(_build.load(), rc,
                 f"flash_bwd_dq h={h} sq={sq} sk={sk} d={d}")
    bwd_dq_launches += 1
    bwd_dq_tc_launches += tc
    return dq


def attention_backward_kernel(q, k, v, o, lse, do, causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """dq, dk, dv by the three backward kernels, in the inputs' dtypes
    (``bwd_tc_launches`` counts the calls on the bf16 route; each
    kernel's wrapper counts its own launches there)."""
    global bwd_tc_launches
    delta = bwd_preprocess_kernel(o, do)
    dk, dv = bwd_dkdv_kernel(q, k, v, do, lse, delta, causal)
    dq = bwd_dq_kernel(q, k, v, do, lse, delta, causal)
    if tc_route(q, k.shape[1]):
        bwd_tc_launches += 1
        obs.inc("flash.bwd_tc_launches")
    return dq, dk, dv


def attention_backward_plain(q, k, v, o, lse, do, causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The plain version of :func:`attention_backward_kernel`."""
    global backward_plain_calls
    backward_plain_calls += 1
    dq, dk, dv = ref.flash_attention_backward(q, k, v, o, lse, do, causal)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels as operators the dispatcher knows
# ---------------------------------------------------------------------------

_lib = torch.library.Library("strela", "DEF")
_lib.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal) "
            "-> (Tensor, Tensor)")
_lib.define("flash_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, "
            "Tensor dout, bool causal) -> (Tensor, Tensor, Tensor)")
_lib.define("flash_attn(Tensor q, Tensor k, Tensor v, bool causal) "
            "-> Tensor")


def _fwd_plain(q, k, v, causal):
    global plain_calls
    _check(q, k, v, causal)
    plain_calls += 1
    return ref.flash_attention_lse(q, k, v, causal)


_lib.impl("flash_fwd", attention_lse_kernel, "CUDA")
_lib.impl("flash_fwd", _fwd_plain, "CPU")
_lib.impl("flash_bwd", attention_backward_kernel, "CUDA")
_lib.impl("flash_bwd", attention_backward_plain, "CPU")
_lib.impl("flash_attn", attention_kernel, "CUDA")
_lib.impl("flash_attn", attention_plain, "CPU")


@torch.library.register_fake("strela::flash_fwd", lib=_lib)
def _fwd_fake(q, k, v, causal):
    _check(q, k, v, causal)
    return (torch.empty_like(q), q.new_empty(q.shape[:2],
                                             dtype=torch.float32))


@torch.library.register_fake("strela::flash_bwd", lib=_lib)
def _bwd_fake(q, k, v, o, lse, dout, causal):
    _check(q, k, v, causal)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@torch.library.register_fake("strela::flash_attn", lib=_lib)
def _attn_fake(q, k, v, causal):
    _check(q, k, v, causal)
    return torch.empty_like(q)


def _pairs(q_shape, k_shape) -> int:
    """bh * sq * sk * d: every product's work, with no causal discount
    (``torch.utils.flop_counter`` counts SDPA so)."""
    h, sq, d = q_shape
    return h * sq * k_shape[1] * d


@register_flop_formula(torch.ops.strela.flash_fwd)
def _fwd_flop(q, k, v, causal, out_shape=None, **kwargs) -> int:
    return 4 * _pairs(q, k)             # S = QK^T and O = PV


@register_flop_formula(torch.ops.strela.flash_attn)
def _attn_flop(q, k, v, causal, out_shape=None, **kwargs) -> int:
    return 4 * _pairs(q, k)


@register_flop_formula(torch.ops.strela.flash_bwd)
def _bwd_flop(q, k, v, o, lse, dout, causal, out_shape=None,
              **kwargs) -> int:
    return 10 * _pairs(q, k)            # S again, dP, dV, dQ and dK


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a gradient through ``strela::flash_fwd`` (the
    forward kernel with its log-sum-exp) and ``strela::flash_bwd`` (the
    three backward kernels) for CUDA tensors, their plain versions
    (``ref.flash_attention_lse``, ``ref.flash_attention_backward``) for
    CPU tensors, and only there. Saves q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = torch.ops.strela.flash_fwd(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()             # autograd may hand a strided view
        dq, dk, dv = torch.ops.strela.flash_bwd(q, k, v, o, lse, do,
                                                ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors, as ``strela::flash_attn``; through
    :class:`FlashAttentionFn` when grad mode is on and an input requires
    a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal)
    return torch.ops.strela.flash_attn(q, k, v, causal)
