"""The Zamba-2 hybrid as ``nn.Module``s (counterpart of
``repro.models.hybrid``): a Mamba-2 backbone and one *shared* attention
block applied after every ``share_every`` SSD layers, its input the
concatenation of the hidden state and the original embedding through a
down-projection.

The shared block's weights are one module, run at ``n_layers //
share_every`` sites; each site has its own KV cache. Its attention is
``layers.attention``, so its softmax-V core runs on the flash kernel for
CUDA tensors. As in the reference, the layers past ``sites *
share_every`` are never run, and the KV caches are in the config's dtype
(a float32 config attends over float32 caches, where the transformer's
default is bfloat16). Decode states and caches are written in place. On
a mesh the SSD layers run whole on every 'model' rank and the shared
block's attention and MLP tensor parallel, as in ``transformer``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.runtime import tp
from repro_torch.models.transformer import Caches, _attn_cfg, _mlp_cfg


def n_shared_sites(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.share_every


class SharedBlock(nn.Module):
    """``h = cat([x, x0]) @ concat_proj``; attention on ``rmsnorm(h,
    ln1)`` and the MLP on ``rmsnorm(h, ln2)``, each added to h; returns
    ``x + h``. ``tree`` is the reference's ``shared`` subtree."""

    def __init__(self, cfg: ArchConfig, tree: Dict):
        super().__init__()
        self.attn_cfg, self.mlp_cfg = _attn_cfg(cfg), _mlp_cfg(cfg)
        self.concat_proj = nn.Parameter(tree["concat_proj"])
        self.ln1 = nn.Parameter(tree["ln1"])
        self.ln2 = nn.Parameter(tree["ln2"])
        self.attn = nn.ParameterDict(tree["attn"])
        self.mlp = nn.ParameterDict(tree["mlp"])

    def forward(self, x: torch.Tensor, x0: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Caches] = None,
                cache_len: int = 0
                ) -> Tuple[torch.Tensor, Optional[Caches]]:
        h = torch.cat([x, x0], dim=-1) @ tp.whole(self.concat_proj)
        a, new_cache = L.attention(self.attn, self.attn_cfg,
                                   L.rmsnorm(h, tp.whole(self.ln1)),
                                   positions, cache, cache_len)
        h = h + a
        h = h + L.mlp(self.mlp, self.mlp_cfg,
                      L.rmsnorm(h, tp.whole(self.ln2)))
        return x + h, new_cache


class Hybrid(nn.Module):
    """Embedding, ``n_layers`` :class:`ssm.SSMBlock`s, one
    :class:`SharedBlock`, the final norm and tied logits. ``tree`` holds
    the reference's parameter tree with the layer stack as a list."""

    def __init__(self, cfg: ArchConfig, tree: Dict):
        super().__init__()
        if len(tree["layers"]) != cfg.n_layers:
            raise ValueError(f"{cfg.arch_id}: {len(tree['layers'])} layers "
                             f"given, the config has {cfg.n_layers}")
        self.cfg = cfg
        self.embed = nn.Parameter(tree["embed"])
        self.final_norm = nn.Parameter(tree["final_norm"])
        self.layers = nn.ModuleList(S.SSMBlock(cfg, t)
                                    for t in tree["layers"])
        self.shared = SharedBlock(cfg, tree["shared"])

    def forward(self, tokens: torch.Tensor,
                states: Optional[S.State] = None,
                caches: Optional[Caches] = None, cache_len: int = 0):
        """Returns (logits, (states, caches), aux = 0). ``states`` are the
        stacked per-layer SSM states, ``caches`` the stacked per-site
        (sites, B, S_max, n_kv, hd) k and v; both are updated in place,
        and None runs without them (the chunked form, attention over the
        tokens given). The states returned are the first ``sites *
        share_every`` layers' (views), as the reference returns."""
        cfg = self.cfg
        embed = tp.whole(self.embed)
        x = embed[tokens.long()]
        x0 = x
        B, S_len = tokens.shape
        positions = cache_len + torch.arange(S_len, device=x.device,
                                             dtype=torch.int32)
        positions = positions[None, :].expand(B, S_len)
        k, sites = cfg.share_every, n_shared_sites(cfg)
        x = tp.activations(x)
        for g in range(sites):
            for i in range(g * k, (g + 1) * k):
                x, _ = self.layers[i](tp.local(x), None if states is None
                                      else (states[0][i], states[1][i]))
                x = tp.activations(x)
            x, _ = self.shared(tp.local(x), x0, positions,
                               None if caches is None
                               else (caches[0][g], caches[1][g]), cache_len)
            x = tp.activations(x)
        x = L.rmsnorm(tp.local(x), tp.whole(self.final_norm))
        ns = (None if states is None
              else (states[0][:sites * k], states[1][:sites * k]))
        return (x @ embed.T, (ns, caches),
                torch.zeros((), dtype=torch.float32, device=x.device))


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Hybrid:
    """Random parameters with the reference's distributions, drawn on the
    generator's device (the values differ from the reference's)."""
    dt = cfg.torch_dtype
    ones = lambda: torch.ones(cfg.d_model, dtype=dt,     # noqa: E731
                              device=gen.device)
    layers = [{"norm": ones(), "ssm": S.ssm_init(gen, cfg, dt)}
              for _ in range(cfg.n_layers)]
    shared = {"concat_proj": L.dense_init(gen, 2 * cfg.d_model, cfg.d_model,
                                          dt),
              "ln1": ones(), "ln2": ones(),
              "attn": L.attn_init(gen, _attn_cfg(cfg), dt),
              "mlp": L.mlp_init(gen, _mlp_cfg(cfg), dt)}
    return Hybrid(cfg, {"embed": L.embed_init(gen, cfg.vocab_padded,
                                              cfg.d_model, dt),
                        "final_norm": ones(), "layers": layers,
                        "shared": shared})


def forward(params: Hybrid, cfg: ArchConfig, tokens: torch.Tensor,
            states: Optional[S.State] = None,
            caches: Optional[Caches] = None, cache_len: Optional[int] = None):
    """The reference's ``forward(params, cfg, tokens, states, caches,
    cache_len)``; ``cache_len`` is a Python int (None is 0)."""
    if params.cfg != cfg:
        raise ValueError(f"forward: the parameters were built for "
                         f"{params.cfg.arch_id}, not this config")
    return params(tokens, states, caches, cache_len or 0)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device="cuda") -> Tuple[S.State, Caches]:
    """Zeroed SSM states for every layer and (sites, B, max_len, n_kv, hd)
    k and v caches in the config's dtype."""
    shape = (n_shared_sites(cfg), batch, max_len, cfg.n_kv_heads, cfg.hd)
    return (S.init_lm_states(cfg, batch, device),
            tp.kv_cache_zeros(cfg, shape, cfg.torch_dtype, device))
