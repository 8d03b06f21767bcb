"""Shared transformer building blocks, as plain functions on tensors
(counterpart of ``repro.models.layers``).

Conventions, as in the reference:
  * activations ``(batch, seq, d_model)``; attention inner ``(batch, seq,
    heads, head_dim)``;
  * dtype policy: parameters and activations in the config's dtype,
    reductions and softmax in float32.

On a mesh (``runtime.partition.use_mesh``) attention and the MLP are
tensor parallel over 'model' (``runtime.tp``): attention splits its
heads over the 'model' ranks when ``n_heads % msize == 0 or n_heads >=
msize`` (the reference's rule, ``layers.py:165-169``), else the query
sequence; the MLP splits its ff dim. Each region enters through
``tp.enter_model`` and leaves through ``tp.leave_model``, and the flash
kernel sees the rank's local ``(b_loc*h_loc, s, d)`` tensors. Outside a
mesh they run the one-device operations unchanged.

Attention's softmax-times-V core runs in
``repro_torch.kernels.flash_attention.flash_attention``, on q, k and v in
the activations' dtype (bf16 takes the kernel's tensor-core route): the
hand-written CUDA kernel for CUDA tensors, its plain version for CPU
tensors. Both of the reference's ``attention_impl`` values (``"full"``,
and ``"chunked"``, its XLA analogue of the same online-softmax kernel)
take this one path, so ``AttnCfg`` carries no ``impl``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.runtime import tp

Params = Dict[str, torch.Tensor]
F32 = torch.float32


# ---------------------------------------------------------------------------
# init helpers: the reference's distributions, drawn from a torch.Generator
# on the generator's device
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, std: float,
            dtype: torch.dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=F32, device=gen.device)
    return (x * std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return _normal(gen, (d_in, d_out), (2.0 / (d_in + d_out)) ** 0.5, dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return _normal(gen, (vocab, d), 0.02, dtype)


# ---------------------------------------------------------------------------
# scalars, norms, rope
# ---------------------------------------------------------------------------

def scale_by(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x * c`` as JAX computes an array times a Python float: the float
    is first rounded to the array's dtype (torch would keep it in float32
    for a bfloat16 tensor)."""
    return x * float(torch.tensor(c, dtype=x.dtype))


def rmsnorm(x: torch.Tensor, g: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Normalise in float32, cast to x's dtype, *then* scale by ``g``."""
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * g


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Rotates the
    two halves of the head (not interleaved pairs), in float32."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = positions[..., :, None, None].to(F32) * freqs     # (..., s, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional bias — qwen-style)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True


def attn_init(gen: torch.Generator, cfg: AttnCfg,
              dtype: torch.dtype = torch.bfloat16) -> Params:
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    p = {"wq": dense_init(gen, cfg.d_model, hq, dtype),
         "wk": dense_init(gen, cfg.d_model, hkv, dtype),
         "wv": dense_init(gen, cfg.d_model, hkv, dtype),
         "wo": dense_init(gen, hq, cfg.d_model, dtype)}
    if cfg.qkv_bias:
        for name, n in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros(n, dtype=dtype, device=gen.device)
    return p


def repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """Broadcast kv heads (dim 2) to the query heads as ``jnp.repeat``
    does: each kv head ``group`` times in a row (``repeat_interleave``,
    not ``Tensor.repeat``, which would tile the heads)."""
    return torch.repeat_interleave(x, group, dim=2)


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(b, s, h, d) -> (b*h, s, d), contiguous: the kernel's layout."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


def head_layout(n_heads: int, seq: int, divisible_only: bool = False
                ) -> Tuple[List[Tuple[int, int]],
                           Optional[List[Tuple[int, int]]]]:
    """Every 'model' rank's (head range, query-row range or None). Heads
    split when ``n_heads % msize == 0 or n_heads >= msize`` (the second
    test dropped with ``divisible_only``, as whisper's cross-attention),
    else every rank takes all heads and its rows of the query sequence
    (with fewer rows than ranks, the last ranks take none)."""
    _, m = tp.model_split()
    if n_heads % m == 0 or (n_heads >= m and not divisible_only):
        return tp.ranges(n_heads, m), None
    return [(0, n_heads)] * m, tp.ranges(seq, m)


def _kv_bounds(heads: List[Tuple[int, int]], group: int
               ) -> List[Tuple[int, int]]:
    """The kv heads each rank's query heads read."""
    return [(lo // group, (hi - 1) // group + 1) for lo, hi in heads]


def _scaled(bounds: List[Tuple[int, int]], c: int) -> List[Tuple[int, int]]:
    return [(lo * c, hi * c) for lo, hi in bounds]


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            heads: Tuple[int, int], kv_lo: int, group: int,
            causal: bool, kernel=None) -> torch.Tensor:
    """q (b, sq, h_loc, d); k, v (b, sk, kv_loc, d) from kv head
    ``kv_lo``: the kv heads broadcast to the query heads and cut to this
    rank's, then ``kernel`` (default ``flash_attention``) on ``(b*h_loc,
    s, d)`` in their shared dtype (float32 where they differ, as a float32
    query against a bfloat16 cache); returns (b, sq, h_loc*d) in that
    dtype. The kernel computes in float32 whatever it is given; a bfloat16
    output is rounded once, as the caller rounded a float32 one before, and
    bfloat16 inputs take the kernel's bf16 tensor-core route."""
    kernel = kernel or flash_attention
    b, sq, nh, hd = q.shape
    dt = q.dtype if q.dtype == k.dtype == v.dtype else F32
    kf, vf = repeat_kv(k, group), repeat_kv(v, group)
    off = heads[0] - kv_lo * group
    if (off, nh) != (0, kf.shape[2]):
        kf, vf = kf.narrow(2, off, nh), vf.narrow(2, off, nh)
    out = kernel(_heads_first(q.to(dt)), _heads_first(kf.to(dt)),
                 _heads_first(vf.to(dt)), causal=causal)
    out = out.reshape(b, nh, sq, hd).permute(0, 2, 1, 3)
    return out.reshape(b, sq, nh * hd)


def _rows_out(out: torch.Tensor, rows: Optional[Tuple[int, int]],
              seq: int) -> torch.Tensor:
    """A rank's rows of the output at their place in the sequence, zeros
    elsewhere, for ``tp.leave_model`` to sum."""
    if rows is None:
        return out
    b, _, d = out.shape
    return torch.cat([out.new_zeros(b, rows[0], d), out,
                      out.new_zeros(b, seq - rows[1], d)], dim=1)


def attention(p: Params, cfg: AttnCfg, x: torch.Tensor,
              positions: torch.Tensor,
              kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_len: int = 0,
              ) -> Tuple[torch.Tensor,
                         Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """GQA attention. Training: ``kv_cache`` None. Decode: x is the new
    token block at positions ``cache_len ..``; the caches (k, v) of shape
    (b, S_max, n_kv, hd) are written at ``cache_len`` in the caches' dtype
    (in place; the reference returns updated copies) and attention runs
    over their first ``cache_len + s`` positions. On a mesh each 'model'
    rank computes its heads (or query rows) and the ranks' out-projections
    are summed; there the caches are DTensors placed by
    ``partition.kv_cache_spec``: each rank computes k and v for every kv
    head, writes its shard of them, and gathers the caches whole (bar the
    batch rows) for its heads."""
    b, s, _ = x.shape
    r, m = tp.model_split()
    hd, group = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    heads, rows = head_layout(cfg.n_heads, s)
    kvs = _kv_bounds(heads, group)
    placed = kv_cache is not None and isinstance(kv_cache[0], DTensor)
    if kv_cache is not None and m > 1 and not placed:
        raise ValueError("attention: KV caches on a model axis must be "
                         "DTensors placed by partition.kv_cache_spec")
    if placed:      # every kv head: the caches' shards need them all
        kvs = [(0, cfg.n_kv_heads)] * m
    xin = tp.enter_model(x)
    q = xin @ tp.part(p["wq"], 1, _scaled(heads, hd))
    k = xin @ tp.part(p["wk"], 1, _scaled(kvs, hd))
    v = xin @ tp.part(p["wv"], 1, _scaled(kvs, hd))
    if cfg.qkv_bias:
        q = q + tp.part(p["bq"], 0, _scaled(heads, hd))
        k = k + tp.part(p["bk"], 0, _scaled(kvs, hd))
        v = v + tp.part(p["bv"], 0, _scaled(kvs, hd))
    (lo, hi), (klo, khi) = heads[r], kvs[r]
    q = rope(q.reshape(b, s, hi - lo, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, khi - klo, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, khi - klo, hd)

    if kv_cache is not None:
        ck, cv = kv_cache
        end = cache_len + s
        if cache_len < 0 or end > ck.shape[1]:
            raise ValueError(f"attention: positions {cache_len}..{end} do "
                             f"not fit a cache of {ck.shape[1]}")
        # placed caches: this rank's shard of the new positions, then the
        # caches gathered whole (bar the batch) for its heads
        tp.state_write(ck, k, cache_len, 1)
        tp.state_write(cv, v, cache_len, 1)
        k, v = tp.state_whole(ck)[:, :end], tp.state_whole(cv)[:, :end]
        new_cache = (ck, cv)
    else:
        new_cache = None

    # the keys are the first cache_len + s positions, so the kernel's
    # end-aligned causal mask (query i sees keys up to cache_len + i) is the
    # reference's position mask together with its cache-length mask; a
    # rank with query rows [r0, r1) takes the keys before r1, which keeps
    # that alignment
    row = None if rows is None else rows[r]
    if row is not None:
        q = q[:, row[0]:row[1]]
        if cfg.causal:
            n = k.shape[1] - s + row[1]
            k, v = k[:, :n], v[:, :n]
    out = _attend(q, k, v, heads[r], klo, group, cfg.causal).to(x.dtype)
    out = out @ tp.part(p["wo"], 0, _scaled(heads, hd))
    return tp.leave_model(_rows_out(out, row, s)), new_cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU or GELU)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MlpCfg:
    d_model: int
    d_ff: int
    activation: str = "swiglu"     # swiglu | gelu


def mlp_init(gen: torch.Generator, cfg: MlpCfg,
             dtype: torch.dtype = torch.bfloat16) -> Params:
    if cfg.activation == "swiglu":
        return {"wg": dense_init(gen, cfg.d_model, cfg.d_ff, dtype),
                "wu": dense_init(gen, cfg.d_model, cfg.d_ff, dtype),
                "wd": dense_init(gen, cfg.d_ff, cfg.d_model, dtype)}
    return {"wu": dense_init(gen, cfg.d_model, cfg.d_ff, dtype),
            "wd": dense_init(gen, cfg.d_ff, cfg.d_model, dtype)}


def mlp(p: Params, cfg: MlpCfg, x: torch.Tensor) -> torch.Tensor:
    """The activation in float32, cast back before the gate's product;
    ``jax.nn.gelu`` defaults to the tanh form. On a mesh each 'model'
    rank computes its range of the ff dim."""
    _, m = tp.model_split()
    ff = tp.ranges(cfg.d_ff, m)
    xin = tp.enter_model(x)
    if cfg.activation == "swiglu":
        h = F.silu((xin @ tp.part(p["wg"], 1, ff)).to(F32)).to(x.dtype) \
            * (xin @ tp.part(p["wu"], 1, ff))
    else:
        h = F.gelu((xin @ tp.part(p["wu"], 1, ff)).to(F32),
                   approximate="tanh").to(x.dtype)
    return tp.leave_model(h @ tp.part(p["wd"], 0, ff))


# ---------------------------------------------------------------------------
# cross-entropy loss, padded vocab
# ---------------------------------------------------------------------------

def xent_loss(logits: torch.Tensor, targets: torch.Tensor,
              vocab: Optional[int] = None) -> torch.Tensor:
    """Cross-entropy; columns >= ``vocab`` (embedding padding) are masked.
    On a mesh, each rank's mean over its rows made the global batch's."""
    lf = logits.to(F32)
    if vocab is not None and vocab < logits.shape[-1]:
        lf = mask_padded_vocab(lf, vocab)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return tp.batch_mean(torch.mean(logz - gold))


def mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    if vocab >= logits.shape[-1]:
        return logits
    cols = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(cols >= vocab, -1e30)
