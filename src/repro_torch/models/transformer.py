"""The dense decoder-only transformer (llama family) as ``nn.Module``s
(counterpart of ``repro.models.transformer``, dense family only).

Covers minicpm-2b, internlm2-20b, qwen1.5-4b and yi-9b. The reference
stacks its layers under ``lax.scan`` with a leading L axis; here each layer
is a :class:`Block` and the forward loops over them. Its parameters keep
the reference's tree layout and names (``layers.<i>.attn.wq``, ...), so
``repro_torch.convert.lm_params_from_reference`` carries a reference tree
across by unstacking the L axis. ``remat`` (activation checkpointing)
has no effect: the port runs no backward pass yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

Caches = Tuple[torch.Tensor, torch.Tensor]

PENDING = "is not ported yet: ROADMAP.md queue 1 item 2b"


def _attn_cfg(cfg: ArchConfig) -> L.AttnCfg:
    return L.AttnCfg(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                     cfg.qkv_bias, cfg.rope_theta)


def _mlp_cfg(cfg: ArchConfig) -> L.MlpCfg:
    return L.MlpCfg(cfg.d_model, cfg.d_ff, cfg.activation)


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.arch_id}: the MoE layer "
                                  f"(models/moe.py) {PENDING}")


class Block(nn.Module):
    """One pre-norm layer: attention and MLP, each on a scaled residual."""

    def __init__(self, cfg: ArchConfig, tree: Dict):
        super().__init__()
        self.residual_scale = cfg.residual_scale
        self.attn_cfg, self.mlp_cfg = _attn_cfg(cfg), _mlp_cfg(cfg)
        self.ln1 = nn.Parameter(tree["ln1"])
        self.ln2 = nn.Parameter(tree["ln2"])
        self.attn = nn.ParameterDict(tree["attn"])
        self.mlp = nn.ParameterDict(tree["mlp"])

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Caches] = None, cache_len: int = 0
                ) -> Tuple[torch.Tensor, Optional[Caches]]:
        h, new_cache = L.attention(self.attn, self.attn_cfg,
                                   L.rmsnorm(x, self.ln1), positions, cache,
                                   cache_len)
        x = x + L.scale_by(h, self.residual_scale)
        h = L.mlp(self.mlp, self.mlp_cfg, L.rmsnorm(x, self.ln2))
        return x + L.scale_by(h, self.residual_scale), new_cache


class Transformer(nn.Module):
    """Token embedding, ``n_layers`` blocks, final norm and the logits
    (tied to the embedding, or ``lm_head``). ``tree`` holds the
    reference's parameter tree with the layer stack as a list."""

    def __init__(self, cfg: ArchConfig, tree: Dict):
        super().__init__()
        _check_dense(cfg)
        if len(tree["layers"]) != cfg.n_layers:
            raise ValueError(f"{cfg.arch_id}: {len(tree['layers'])} layers "
                             f"given, the config has {cfg.n_layers}")
        self.cfg = cfg
        self.embed = nn.Parameter(tree["embed"])
        self.final_norm = nn.Parameter(tree["final_norm"])
        self.layers = nn.ModuleList(Block(cfg, t) for t in tree["layers"])
        self.lm_head = (None if cfg.tie_embeddings
                        else nn.Parameter(tree["lm_head"]))

    def forward(self, tokens: torch.Tensor,
                caches: Optional[Caches] = None, cache_len: int = 0
                ) -> Tuple[torch.Tensor, Optional[Caches], torch.Tensor]:
        """Returns (logits, caches, aux_loss). ``caches`` are the stacked
        (L, B, S_max, n_kv, hd) pair, updated in place at ``cache_len``."""
        cfg = self.cfg
        x = self.embed[tokens.long()]
        # minicpm scales its tied embedding (the reference's rule, by name)
        if cfg.tie_embeddings and cfg.arch_id.startswith("minicpm"):
            x = L.scale_by(x, cfg.d_model ** 0.5)
        B, S, _ = x.shape
        positions = (cache_len + torch.arange(S, device=x.device,
                                              dtype=torch.int32))
        positions = positions[None, :].expand(B, S)
        for i, block in enumerate(self.layers):
            layer_cache = None if caches is None else (caches[0][i],
                                                       caches[1][i])
            x, _ = block(x, positions, layer_cache, cache_len)
        x = L.rmsnorm(x, self.final_norm)
        logits = x @ (self.embed.T if self.lm_head is None else self.lm_head)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, caches, aux


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Transformer:
    """Random parameters with the reference's distributions, drawn on the
    generator's device (the values differ from the reference's, whose
    draws come from ``jax.random``)."""
    dt = cfg.torch_dtype
    ones = lambda: torch.ones(cfg.d_model, dtype=dt,     # noqa: E731
                              device=gen.device)
    _check_dense(cfg)
    layers: List[Dict] = [
        {"ln1": ones(), "ln2": ones(),
         "attn": L.attn_init(gen, _attn_cfg(cfg), dt),
         "mlp": L.mlp_init(gen, _mlp_cfg(cfg), dt)}
        for _ in range(cfg.n_layers)]
    tree = {"embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dt),
            "final_norm": ones(), "layers": layers}
    if not cfg.tie_embeddings:
        tree["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_padded, dt)
    return Transformer(cfg, tree)


def forward(params: Transformer, cfg: ArchConfig,
            tokens: torch.Tensor, caches: Optional[Caches] = None,
            cache_len: int = 0
            ) -> Tuple[torch.Tensor, Optional[Caches], torch.Tensor]:
    """The reference's ``forward(params, cfg, tokens, caches, cache_len)``."""
    if params.cfg != cfg:
        raise ValueError(f"forward: the parameters were built for "
                         f"{params.cfg.arch_id}, not this config")
    return params(tokens, caches, cache_len)


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16,
                device="cuda") -> Caches:
    """Zeroed (L, B, max_len, n_kv, hd) k and v caches. The dtype defaults
    to bfloat16 whatever the config's dtype, as in the reference, whose
    callers pass none: k and v are rounded to it before attention."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
