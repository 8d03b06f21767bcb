"""The dense / MoE decoder-only transformer (llama family) as
``nn.Module``s (counterpart of ``repro.models.transformer``).

Covers minicpm-2b, internlm2-20b, qwen1.5-4b, yi-9b (dense), llama4-scout
and granite (MoE through ``moe.py``) and internvl2-76b (vlm: patch
embeddings prepended to the token embeddings; the vision encoder is
stubbed, as in the reference). The reference stacks its layers under
``lax.scan`` with a leading L axis; here each layer is a :class:`Block`
and the forward loops over them. Its parameters keep the reference's
tree layout and names (``layers.<i>.attn.wq``, ``layers.<i>.moe.router``,
...), so ``repro_torch.convert.lm_params_from_reference`` carries a
reference tree across by unstacking the L axis. ``remat`` (activation
checkpointing) has no effect: training keeps every layer's activations
for the backward. On a mesh (``runtime.partition.use_mesh``, parameters
placed by ``partition.place_model``) the hidden state between blocks is
a DTensor whose rows lie over the batch axes; norms, the embedding and
the logits run whole on every 'model' rank, attention and the MLP
tensor parallel (``layers``), the MoE layer as its ``impl`` says.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.runtime import tp

Caches = Tuple[torch.Tensor, torch.Tensor]


def _attn_cfg(cfg: ArchConfig) -> L.AttnCfg:
    return L.AttnCfg(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                     cfg.qkv_bias, cfg.rope_theta)


def _mlp_cfg(cfg: ArchConfig) -> L.MlpCfg:
    return L.MlpCfg(cfg.d_model, cfg.d_ff, cfg.activation)


class MoE(nn.Module):
    """A layer's MoE parameters (the reference's ``moe`` subtree: the
    router, ``w_experts_*`` and, with a shared expert, ``shared``) as a
    module that reads like that dict; calling it runs ``moe_apply`` on
    them, so a forward hook sees the layer's input. Each leaf keeps its
    dtype: the router stays float32 in a bfloat16 model."""

    def __init__(self, cfg: ArchConfig, tree: Dict):
        super().__init__()
        self.spec, self.d_ff, self.impl = cfg.moe, cfg.d_ff, cfg.moe_impl
        for k, v in tree.items():
            setattr(self, k, nn.ParameterDict(v) if isinstance(v, dict)
                    else nn.Parameter(v))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_apply(self, self.spec, self.d_ff, x, impl=self.impl)


class Block(nn.Module):
    """One pre-norm layer: attention, then the MLP or the MoE layer, each
    on a scaled residual."""

    def __init__(self, cfg: ArchConfig, tree: Dict):
        super().__init__()
        self.residual_scale = cfg.residual_scale
        self.attn_cfg, self.mlp_cfg = _attn_cfg(cfg), _mlp_cfg(cfg)
        self.ln1 = nn.Parameter(tree["ln1"])
        self.ln2 = nn.Parameter(tree["ln2"])
        self.attn = nn.ParameterDict(tree["attn"])
        if cfg.moe is not None:
            self.moe = MoE(cfg, tree["moe"])
        else:
            self.mlp = nn.ParameterDict(tree["mlp"])

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Caches] = None, cache_len: int = 0
                ) -> Tuple[torch.Tensor, Optional[Caches],
                           Optional[torch.Tensor]]:
        """Returns (x, cache, aux): aux is the MoE layer's float32 loss,
        None for a dense layer."""
        h, new_cache = L.attention(self.attn, self.attn_cfg,
                                   L.rmsnorm(x, tp.whole(self.ln1)),
                                   positions, cache, cache_len)
        x = x + L.scale_by(h, self.residual_scale)
        aux = None
        ln2 = tp.whole(self.ln2)
        if hasattr(self, "moe"):
            h, aux = self.moe(L.rmsnorm(x, ln2))
        else:
            h = L.mlp(self.mlp, self.mlp_cfg, L.rmsnorm(x, ln2))
        return x + L.scale_by(h, self.residual_scale), new_cache, aux


class Transformer(nn.Module):
    """Token embedding, ``n_layers`` blocks, final norm and the logits
    (tied to the embedding, or ``lm_head``). ``tree`` holds the
    reference's parameter tree with the layer stack as a list."""

    def __init__(self, cfg: ArchConfig, tree: Dict):
        super().__init__()
        if len(tree["layers"]) != cfg.n_layers:
            raise ValueError(f"{cfg.arch_id}: {len(tree['layers'])} layers "
                             f"given, the config has {cfg.n_layers}")
        self.cfg = cfg
        self.embed = nn.Parameter(tree["embed"])
        self.final_norm = nn.Parameter(tree["final_norm"])
        self.layers = nn.ModuleList(Block(cfg, t) for t in tree["layers"])
        self.lm_head = (None if cfg.tie_embeddings
                        else nn.Parameter(tree["lm_head"]))

    def forward(self, tokens: Optional[torch.Tensor] = None,
                caches: Optional[Caches] = None, cache_len: int = 0,
                embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Caches], torch.Tensor]:
        """Returns (logits, caches, aux_loss). tokens (B, S) and/or embeds
        (B, P, D): a vlm prepends its patch embeddings, cast to the
        activations' dtype; with no tokens, x is ``embeds`` as given.
        ``caches`` are the stacked (L, B, S_max, n_kv, hd) pair, updated in
        place at ``cache_len``. aux sums the MoE layers' losses in
        float32."""
        cfg = self.cfg
        embed = tp.whole(self.embed)
        if tokens is not None:
            x = embed[tokens.long()]
            # minicpm scales its tied embedding (the reference's rule, by
            # name)
            if cfg.tie_embeddings and cfg.arch_id.startswith("minicpm"):
                x = L.scale_by(x, cfg.d_model ** 0.5)
            if embeds is not None:
                x = torch.cat([embeds.to(x.dtype), x], dim=1)
        else:
            x = embeds
        B, S, _ = x.shape
        positions = (cache_len + torch.arange(S, device=x.device,
                                              dtype=torch.int32))
        positions = positions[None, :].expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x = tp.activations(x)
        for i, block in enumerate(self.layers):
            layer_cache = None if caches is None else (caches[0][i],
                                                       caches[1][i])
            x, _, a = block(tp.local(x), positions, layer_cache, cache_len)
            x = tp.activations(x)
            if a is not None:
                aux = aux + a
        x = L.rmsnorm(tp.local(x), tp.whole(self.final_norm))
        logits = x @ (embed.T if self.lm_head is None
                      else tp.whole(self.lm_head))
        return logits, caches, aux


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Transformer:
    """Random parameters with the reference's distributions, drawn on the
    generator's device (the values differ from the reference's, whose
    draws come from ``jax.random``)."""
    dt = cfg.torch_dtype
    ones = lambda: torch.ones(cfg.d_model, dtype=dt,     # noqa: E731
                              device=gen.device)
    layers: List[Dict] = []
    for _ in range(cfg.n_layers):
        lp = {"ln1": ones(), "ln2": ones(),
              "attn": L.attn_init(gen, _attn_cfg(cfg), dt)}
        if cfg.moe is not None:
            lp["moe"] = moe_init(gen, cfg.d_model, cfg.d_ff, cfg.moe, dt)
        else:
            lp["mlp"] = L.mlp_init(gen, _mlp_cfg(cfg), dt)
        layers.append(lp)
    tree = {"embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dt),
            "final_norm": ones(), "layers": layers}
    if not cfg.tie_embeddings:
        tree["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_padded, dt)
    return Transformer(cfg, tree)


def forward(params: Transformer, cfg: ArchConfig,
            tokens: Optional[torch.Tensor] = None,
            caches: Optional[Caches] = None, cache_len: int = 0,
            embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[Caches], torch.Tensor]:
    """The reference's ``forward(params, cfg, tokens, embeds, caches,
    cache_len)``; ``embeds`` comes last here."""
    if params.cfg != cfg:
        raise ValueError(f"forward: the parameters were built for "
                         f"{params.cfg.arch_id}, not this config")
    return params(tokens, caches, cache_len, embeds)


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16,
                device="cuda") -> Caches:
    """Zeroed (L, B, max_len, n_kv, hd) k and v caches. The dtype defaults
    to bfloat16 whatever the config's dtype, as in the reference, whose
    callers pass none: k and v are rounded to it before attention. On a
    mesh (``batch`` this rank's rows) they are DTensors placed by
    ``partition.kv_cache_spec``."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return tp.kv_cache_zeros(cfg, shape, dtype, device)
