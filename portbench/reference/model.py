"""The decoder-only transformer of the configuration, in float32: token
embedding times its multiplier, ``n_layers`` pre-norm blocks (causal GQA
attention with rotary positions on the two halves of each head; SwiGLU,
or the MoE layer), residuals times their multiplier, a final RMS norm and
the logits (the tied embedding, or ``lm_head``).

The MoE layer routes as the configuration states: a float32 router,
softmax, the top-k experts by a stable descending sort (ties to the
lower index), gates renormalised over the k, and a capacity of
``max(int(capacity_factor * N * k / E), 1)`` slots an expert for the
``N`` tokens of the call, taken in token order; pairs past it are
dropped. The load-balancing loss is ``aux_coef * E * mean(density *
mean_prob)``.

Weights come as the stacked tree (``layers/...`` leaves with a leading L
axis). Scalars the configuration multiplies by are rounded to its dtype
first, as a model held in that dtype holds them.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision
from portbench.spec import ModelSpec

F32 = torch.float32
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
QUERY_BLOCK = 1024       # query rows a block, so scores fit at 4096
CACHE_DTYPE = torch.bfloat16


def scalar(c: float, spec: ModelSpec) -> float:
    return float(torch.tensor(c, dtype=DTYPES[spec.dtype]))


def mm(a: torch.Tensor, b: torch.Tensor, p: Precision) -> torch.Tensor:
    return p.product(a) @ p.product(b)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, hd) at positions 0 .. S-1."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     p: Precision) -> torch.Tensor:
    """q, k, v (heads, S, hd), query i seeing keys 0 .. i; softmax of the
    scores over sqrt(hd), in blocks of query rows."""
    S, hd = q.shape[1], q.shape[2]
    scale = 1.0 / math.sqrt(hd)
    kt, vq = p.product(k).transpose(1, 2), p.product(v)
    cols = torch.arange(S, device=q.device)
    out = []
    for lo in range(0, S, QUERY_BLOCK):
        hi = min(lo + QUERY_BLOCK, S)
        s = (p.product(q[:, lo:hi]) @ kt) * scale
        rows = torch.arange(lo, hi, device=q.device)
        s = s.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
        out.append(p.product(torch.softmax(s, dim=-1)) @ vq)
    return torch.cat(out, dim=1)


def attention(x: torch.Tensor, w: Dict[str, torch.Tensor], spec: ModelSpec,
              p: Precision, cache: Optional[torch.dtype] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> the block's attention output and its k, v (B, S,
    n_kv, hd) after rotary positions. With a KV cache of dtype ``cache``
    (prefill), k and v are held in it and attention reads them there."""
    B, S, _ = x.shape
    H, KV, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = rope(mm(x, w["wq"], p).view(B, S, H, hd), spec.rope_theta)
    k = rope(mm(x, w["wk"], p).view(B, S, KV, hd), spec.rope_theta)
    v = mm(x, w["wv"], p).view(B, S, KV, hd)
    if cache is not None:
        k, v = p.held(k, cache), p.held(v, cache)
    rows = []
    for b in range(B):
        kb = k[b].repeat_interleave(spec.group, dim=1).transpose(0, 1)
        vb = v[b].repeat_interleave(spec.group, dim=1).transpose(0, 1)
        o = causal_attention(q[b].transpose(0, 1), kb, vb, p)
        rows.append(o.transpose(0, 1).reshape(S, H * hd))
    return mm(torch.stack(rows), w["wo"], p), k, v


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor, p: Precision) -> torch.Tensor:
    return mm(F.silu(mm(x, wg, p)) * mm(x, wu, p), wd, p)


def moe(x: torch.Tensor, w: Dict[str, torch.Tensor], spec: ModelSpec,
        p: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (the MoE layer's output, its aux loss)."""
    m = spec.moe
    B, S, D = x.shape
    N, E, k = B * S, m.n_experts, m.top_k
    xf = x.reshape(N, D)
    probs = torch.softmax(mm(xf, w["router"], p), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[:, :k], idx[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    density = F.one_hot(experts, E).sum(1).to(F32).mean(0)
    aux = m.aux_coef * E * torch.mean(density * probs.mean(0))
    cap = max(int(m.capacity_factor * N * k / E), 1)
    flat = experts.reshape(-1)                  # pairs in token order
    out = torch.zeros_like(xf)
    for e in range(E):
        pairs = torch.nonzero(flat == e).flatten()[:cap]
        if pairs.numel() == 0:
            continue
        tok, slot = pairs // k, pairs % k
        y = swiglu(xf[tok], w["w_experts_gate"][e], w["w_experts_up"][e],
                   w["w_experts_down"][e], p)
        out = out.index_add(0, tok, y * gates[tok, slot][:, None])
    return out.view(B, S, D), aux


def block(x: torch.Tensor, w: Dict[str, torch.Tensor], spec: ModelSpec,
          p: Precision, cache: Optional[torch.dtype] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer: (x, k, v, aux)."""
    r = scalar(spec.residual_multiplier, spec)
    h, k, v = attention(rmsnorm(x, w["ln1"], spec.rms_norm_eps), w, spec, p,
                        cache)
    x = x + h * r
    y = rmsnorm(x, w["ln2"], spec.rms_norm_eps)
    if spec.moe is None:
        h, aux = swiglu(y, w["wg"], w["wu"], w["wd"], p), x.new_zeros(())
    else:
        h, aux = moe(y, w, spec, p)
    return x + h * r, k, v, aux


def layer_weights(tree: Dict, spec: ModelSpec, i: int
                  ) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves from the stacked tree, in float32."""
    layers = tree["layers"]
    w = {"ln1": layers["ln1"][i], "ln2": layers["ln2"][i]}
    w.update({n: t[i] for n, t in layers["attn"].items()})
    w.update({n: t[i] for n, t in layers["mlp" if spec.moe is None
                                         else "moe"].items()})
    return {n: t.to(F32) for n, t in w.items()}


def head(tree: Dict, spec: ModelSpec) -> torch.Tensor:
    return (tree["embed"].T if spec.tie_embeddings else tree["lm_head"])


def embed(tree: Dict, spec: ModelSpec, tokens: torch.Tensor) -> torch.Tensor:
    x = tree["embed"][tokens.long()].to(F32)
    return x * scalar(spec.embedding_multiplier, spec)


@torch.no_grad()
def prefill(spec: ModelSpec, tree: Dict, tokens: torch.Tensor,
            p: Precision,
            on_kv: Optional[Callable[[int, torch.Tensor, torch.Tensor],
                                     None]] = None) -> torch.Tensor:
    """The last position's logits ``(B, vocab_padded)`` of prompts
    ``tokens (B, S)``; ``on_kv(layer, k, v)`` sees each layer's KV cache
    entries (B, S, n_kv, hd) as the caches hold them (bfloat16, the
    caches' dtype whatever the configuration's)."""
    x = embed(tree, spec, tokens)
    for i in range(spec.n_layers):
        x, k, v, _ = block(x, layer_weights(tree, spec, i), spec, p,
                           CACHE_DTYPE)
        if on_kv is not None:
            on_kv(i, k, v)
        del k, v
    last = rmsnorm(x[:, -1], tree["final_norm"].to(F32), spec.rms_norm_eps)
    return p.out(mm(last, head(tree, spec).to(F32), p))
