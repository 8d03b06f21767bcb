"""Shared transformer building blocks, as plain functions on tensors
(counterpart of ``repro.models.layers``).

Conventions, as in the reference:
  * activations ``(batch, seq, d_model)``; attention inner ``(batch, seq,
    heads, head_dim)``;
  * dtype policy: parameters and activations in the config's dtype,
    reductions and softmax in float32.

The reference's ``shard(...)`` constraints are dropped: they are no-ops
outside a mesh, and the port has no partitioning yet.

Attention's softmax-times-V core runs in
``repro_torch.kernels.flash_attention.flash_attention``: the hand-written
CUDA kernel for CUDA tensors, its plain version for CPU tensors. Both of
the reference's ``attention_impl`` values (``"full"``, and ``"chunked"``,
its XLA analogue of the same online-softmax kernel) take this one path,
so ``AttnCfg`` carries no ``impl``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention

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
    over their first ``cache_len + s`` positions."""
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(b, s, cfg.n_heads, cfg.head_dim), positions,
             cfg.rope_theta)
    k = rope(k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim), positions,
             cfg.rope_theta)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)

    if kv_cache is not None:
        ck, cv = kv_cache
        end = cache_len + s
        if cache_len < 0 or end > ck.shape[1]:
            raise ValueError(f"attention: positions {cache_len}..{end} do "
                             f"not fit a cache of {ck.shape[1]}")
        ck[:, cache_len:end] = k.to(ck.dtype)
        cv[:, cache_len:end] = v.to(cv.dtype)
        k, v = ck[:, :end], cv[:, :end]
        new_cache = (ck, cv)
    else:
        new_cache = None

    # the keys are the first cache_len + s positions, so the kernel's
    # end-aligned causal mask (query i sees keys up to cache_len + i) is the
    # reference's position mask together with its cache-length mask
    group = cfg.n_heads // cfg.n_kv_heads
    qf = _heads_first(q.to(F32))
    kf = _heads_first(repeat_kv(k, group).to(F32))
    vf = _heads_first(repeat_kv(v, group).to(F32))
    out = flash_attention(qf, kf, vf, causal=cfg.causal)
    out = out.reshape(b, cfg.n_heads, s, cfg.head_dim).permute(0, 2, 1, 3)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim).to(x.dtype)
    return out @ p["wo"], new_cache


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
    ``jax.nn.gelu`` defaults to the tanh form."""
    if cfg.activation == "swiglu":
        h = F.silu((x @ p["wg"]).to(F32)).to(x.dtype) * (x @ p["wu"])
    else:
        h = F.gelu((x @ p["wu"]).to(F32), approximate="tanh").to(x.dtype)
    return h @ p["wd"]


# ---------------------------------------------------------------------------
# cross-entropy loss, padded vocab
# ---------------------------------------------------------------------------

def xent_loss(logits: torch.Tensor, targets: torch.Tensor,
              vocab: Optional[int] = None) -> torch.Tensor:
    """Cross-entropy; columns >= ``vocab`` (embedding padding) are masked."""
    lf = logits.to(F32)
    if vocab is not None and vocab < logits.shape[-1]:
        lf = mask_padded_vocab(lf, vocab)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    if vocab >= logits.shape[-1]:
        return logits
    cols = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(cols >= vocab, -1e30)
