"""The Whisper-style encoder-decoder as ``nn.Module``s (counterpart of
``repro.models.encdec``; the conv frontend is stubbed, as in the
reference: the encoder takes precomputed frame embeddings).

Encoder: learned positions added to the frames, pre-LN layers of
non-causal self-attention and a GELU MLP, a final LayerNorm. Decoder:
token embedding plus learned positions, pre-LN layers of causal
self-attention (KV caches written in place), cross-attention over the
encoder's output and a GELU MLP, a final LayerNorm and the output head
tied to the embedding.

As in the reference:
  * every self-attention is ``layers.attention``, which ropes q and k at
    ``arange`` positions although whisper has learned positions; its
    softmax-V core runs on the flash kernel for CUDA tensors (the
    encoder's ``causal=False``);
  * cross-attention has no rope, no mask and no cache: its k and v are
    recomputed from the encoder's output on every call, the kv heads
    broadcast by ``repeat_interleave``, and its core is one
    ``flash_attention(..., causal=False)`` over the encoder's frames;
  * the KV caches are in the config's dtype (float32 in a float32
    config, where the transformer's default is bfloat16).

On a mesh the LayerNorms, positions and the embedding run whole on every
'model' rank, self-attention and the MLPs tensor parallel (``layers``),
and cross-attention splits its heads over 'model' when they divide, else
its query rows (the reference's test, ``encdec.py:101-105``); the hidden
states between layers are DTensors whose rows lie over the batch axes.

Deliberate differences: a write past the cache raises ``ValueError``
(``layers.attention``), and so do decoder positions past the learned
table (``MAX_DEC_POS``), where JAX clamps both silently.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.transformer import Caches
from repro_torch.runtime import tp

MAX_DEC_POS = 32768 + 8          # decode_32k support
F32 = torch.float32


def _attn_cfg(cfg: ArchConfig, causal: bool) -> L.AttnCfg:
    """The reference's ``_attn_cfg``: no qkv bias whatever the config
    says."""
    return L.AttnCfg(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                     rope_theta=cfg.rope_theta, causal=causal)


def _mlp_cfg(cfg: ArchConfig) -> L.MlpCfg:
    return L.MlpCfg(cfg.d_model, cfg.d_ff, "gelu")


def _ln(x: torch.Tensor, p: nn.ParameterDict) -> torch.Tensor:
    return L.layernorm(x, tp.whole(p["g"]), tp.whole(p["b"]))


def cross_attention(p: L.Params, cfg: ArchConfig, x: torch.Tensor,
                    enc_out: torch.Tensor) -> torch.Tensor:
    """Full attention of the decoder's x over the encoder's output: q from
    x, k and v recomputed from ``enc_out``, no rope and no mask; q, k and
    v reach the kernel in x's dtype (it computes the softmax in float32
    whatever it is given), the output in x's dtype before ``wo``. On a
    mesh each 'model' rank takes its heads (or its query rows)."""
    b, s, _ = x.shape
    t = enc_out.shape[1]
    r, _ = tp.model_split()
    group, hd = cfg.n_heads // cfg.n_kv_heads, cfg.hd
    heads, rows = L.head_layout(cfg.n_heads, s, divisible_only=True)
    kvs = L._kv_bounds(heads, group)
    (lo, hi), (klo, khi) = heads[r], kvs[r]
    q = tp.enter_model(x) @ tp.part(p["wq"], 1, L._scaled(heads, hd))
    e = tp.enter_model(enc_out)
    k = e @ tp.part(p["wk"], 1, L._scaled(kvs, hd))
    v = e @ tp.part(p["wv"], 1, L._scaled(kvs, hd))
    q = q.reshape(b, s, hi - lo, hd)
    k = k.reshape(b, t, khi - klo, hd)
    v = v.reshape(b, t, khi - klo, hd)
    row = None if rows is None else rows[r]
    if row is not None:
        q = q[:, row[0]:row[1]]
    out = L._attend(q, k, v, heads[r], klo, group, False,
                    flash_attention).to(x.dtype)
    out = out @ tp.part(p["wo"], 0, L._scaled(heads, hd))
    return tp.leave_model(L._rows_out(out, row, s))


class EncoderLayer(nn.Module):
    """``x + attn(ln1(x))`` (non-causal), then ``x + mlp(ln2(x))``."""

    def __init__(self, cfg: ArchConfig, tree: Dict):
        super().__init__()
        self.attn_cfg, self.mlp_cfg = _attn_cfg(cfg, False), _mlp_cfg(cfg)
        self.ln1 = nn.ParameterDict(tree["ln1"])
        self.ln2 = nn.ParameterDict(tree["ln2"])
        self.attn = nn.ParameterDict(tree["attn"])
        self.mlp = nn.ParameterDict(tree["mlp"])

    def forward(self, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        h, _ = L.attention(self.attn, self.attn_cfg, _ln(x, self.ln1),
                           positions)
        x = x + h
        return x + L.mlp(self.mlp, self.mlp_cfg, _ln(x, self.ln2))


class DecoderLayer(nn.Module):
    """ln1 and causal self-attention (its cache at ``cache_len``), ln2 and
    cross-attention over the encoder's output, ln3 and the MLP, each added
    to x."""

    def __init__(self, cfg: ArchConfig, tree: Dict):
        super().__init__()
        self.cfg = cfg
        self.attn_cfg, self.mlp_cfg = _attn_cfg(cfg, True), _mlp_cfg(cfg)
        for name in ("ln1", "ln2", "ln3", "self_attn", "cross_attn", "mlp"):
            setattr(self, name, nn.ParameterDict(tree[name]))

    def forward(self, x: torch.Tensor, enc_out: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Caches] = None,
                cache_len: int = 0) -> torch.Tensor:
        h, _ = L.attention(self.self_attn, self.attn_cfg, _ln(x, self.ln1),
                           positions, cache, cache_len)
        x = x + h
        x = x + cross_attention(self.cross_attn, self.cfg, _ln(x, self.ln2),
                                enc_out)
        return x + L.mlp(self.mlp, self.mlp_cfg, _ln(x, self.ln3))


class EncDec(nn.Module):
    """The embedding (tied output head), the decoder's and the encoder's
    learned positions, ``n_enc_layers`` :class:`EncoderLayer`s,
    ``n_layers`` :class:`DecoderLayer`s and the two final LayerNorms.
    ``tree`` holds the reference's parameter tree with each layer stack as
    a list."""

    def __init__(self, cfg: ArchConfig, tree: Dict):
        super().__init__()
        n_enc = cfg.encdec.n_enc_layers
        if (len(tree["enc_layers"]), len(tree["dec_layers"])) != (
                n_enc, cfg.n_layers):
            raise ValueError(
                f"{cfg.arch_id}: {len(tree['enc_layers'])} encoder and "
                f"{len(tree['dec_layers'])} decoder layers given, the "
                f"config has {n_enc} and {cfg.n_layers}")
        self.cfg = cfg
        for name in ("embed", "pos_embed", "enc_pos_embed"):
            setattr(self, name, nn.Parameter(tree[name]))
        self.enc_final_ln = nn.ParameterDict(tree["enc_final_ln"])
        self.dec_final_ln = nn.ParameterDict(tree["dec_final_ln"])
        self.enc_layers = nn.ModuleList(EncoderLayer(cfg, t)
                                        for t in tree["enc_layers"])
        self.dec_layers = nn.ModuleList(DecoderLayer(cfg, t)
                                        for t in tree["dec_layers"])

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, T, D), the stub frontend's output -> (B, T, D)."""
        B, T, _ = frames.shape
        x = frames + tp.whole(self.enc_pos_embed)[:T][None]
        positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
        x = tp.activations(x)
        for layer in self.enc_layers:
            x = tp.activations(layer(tp.local(x), positions))
        return _ln(tp.local(x), self.enc_final_ln)

    def forward(self, tokens: torch.Tensor, enc_out: torch.Tensor,
                caches: Optional[Caches] = None, cache_len: int = 0
                ) -> Tuple[torch.Tensor, Optional[Caches], torch.Tensor]:
        """The decoder: (logits, caches, aux = 0). ``caches`` are the
        stacked (L, B, S_max, n_kv, hd) k and v, updated in place at
        ``cache_len``; None runs the tokens given causally. On a mesh
        ``enc_out`` may be a DTensor of this rank's rows."""
        enc_out = tp.local(enc_out)
        B, S = tokens.shape
        end = cache_len + S
        if cache_len < 0 or end > self.pos_embed.shape[0]:
            raise ValueError(f"decode: positions {cache_len}..{end} are "
                             f"past the {self.pos_embed.shape[0]} learned "
                             f"decoder positions")
        embed = tp.whole(self.embed)
        pos = tp.whole(self.pos_embed)[cache_len:end]
        x = embed[tokens.long()] + pos[None]
        positions = torch.arange(cache_len, end, device=x.device,
                                 dtype=torch.int32)[None, :].expand(B, S)
        x = tp.activations(x)
        for i, layer in enumerate(self.dec_layers):
            x = tp.activations(layer(
                tp.local(x), enc_out, positions, None if caches is None
                else (caches[0][i], caches[1][i]), cache_len))
        x = _ln(tp.local(x), self.dec_final_ln)
        return (x @ embed.T, caches,
                torch.zeros((), dtype=F32, device=x.device))


def init_params(gen: torch.Generator, cfg: ArchConfig) -> EncDec:
    """Random parameters with the reference's distributions, drawn on the
    generator's device (the values differ from the reference's)."""
    dt = cfg.torch_dtype

    def ln():
        return {"g": torch.ones(cfg.d_model, dtype=dt, device=gen.device),
                "b": torch.zeros(cfg.d_model, dtype=dt, device=gen.device)}

    enc: List[Dict] = [
        {"ln1": ln(), "ln2": ln(),
         "attn": L.attn_init(gen, _attn_cfg(cfg, False), dt),
         "mlp": L.mlp_init(gen, _mlp_cfg(cfg), dt)}
        for _ in range(cfg.encdec.n_enc_layers)]
    dec: List[Dict] = [
        {"ln1": ln(), "ln2": ln(), "ln3": ln(),
         "self_attn": L.attn_init(gen, _attn_cfg(cfg, True), dt),
         "cross_attn": L.attn_init(gen, _attn_cfg(cfg, False), dt),
         "mlp": L.mlp_init(gen, _mlp_cfg(cfg), dt)}
        for _ in range(cfg.n_layers)]
    return EncDec(cfg, {
        "embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dt),
        "pos_embed": L.embed_init(gen, MAX_DEC_POS, cfg.d_model, dt),
        "enc_pos_embed": L.embed_init(gen, cfg.encdec.enc_len, cfg.d_model,
                                      dt),
        "enc_layers": enc, "dec_layers": dec,
        "enc_final_ln": ln(), "dec_final_ln": ln()})


def _same_cfg(params: EncDec, cfg: ArchConfig, what: str) -> None:
    if params.cfg != cfg:
        raise ValueError(f"{what}: the parameters were built for "
                         f"{params.cfg.arch_id}, not this config")


def encode(params: EncDec, cfg: ArchConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """The reference's ``encode(params, cfg, frames)``."""
    _same_cfg(params, cfg, "encode")
    return params.encode(frames)


def decode(params: EncDec, cfg: ArchConfig, tokens: torch.Tensor,
           enc_out: torch.Tensor, caches: Optional[Caches] = None,
           cache_len: Optional[int] = None):
    """The reference's ``decode(params, cfg, tokens, enc_out, caches,
    cache_len)``; ``cache_len`` is a Python int (None is 0)."""
    _same_cfg(params, cfg, "decode")
    return params(tokens, enc_out, caches, cache_len or 0)


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                device="cuda") -> Caches:
    """Zeroed (n_layers, B, max_len, n_kv, hd) k and v caches in the
    config's dtype."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return tp.kv_cache_zeros(cfg, shape, cfg.torch_dtype, device)
