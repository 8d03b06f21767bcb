"""The system under test, the port ``repro_torch``, as the drivers reach
it: its config for a configuration file's widths, its model from the
benchmark's weights tree, and its entry points. Every import of the port
happens here, at call time, so a fault planted in a port module is the
one that runs."""
from __future__ import annotations

import dataclasses
from typing import Dict

from portbench.spec import ModelSpec


def config(conf: Dict, spec: ModelSpec):
    """The port's ``ArchConfig`` for ``conf['arch']`` with the widths of
    the configuration file (equal to the port's registry at published
    size)."""
    from repro_torch.configs.base import MoESpec, get_arch
    moe = None if spec.moe is None else MoESpec(
        n_experts=spec.moe.n_experts, top_k=spec.moe.top_k,
        capacity_factor=spec.moe.capacity_factor,
        aux_coef=spec.moe.aux_coef)
    cfg = dataclasses.replace(
        get_arch(conf["arch"]), n_layers=spec.n_layers,
        d_model=spec.d_model, n_heads=spec.n_heads,
        n_kv_heads=spec.n_kv_heads, head_dim=spec.head_dim, d_ff=spec.d_ff,
        vocab=spec.vocab, tie_embeddings=spec.tie_embeddings,
        residual_scale=spec.residual_multiplier, moe=moe, dtype=spec.dtype)
    if cfg.vocab_padded != spec.vocab_padded:
        raise ValueError(f"{conf['name']}: the port pads the vocabulary to "
                         f"{cfg.vocab_padded}, the file says "
                         f"{spec.vocab_padded}")
    return cfg


def model(tree: Dict, cfg, device):
    """The port's model holding copies of the tree's leaves."""
    from repro_torch.convert import lm_params_from_reference
    return lm_params_from_reference(tree, cfg, device)


def api(cfg):
    from repro_torch.models import api as port_api
    return port_api.build_model(cfg)


def trainer(api_, optimizer: Dict, schedule: Dict):
    """The port's AdamW with the mix's WSD schedule, and its training
    step (``launch.train.make_step``, clipping at 1.0)."""
    from repro_torch.launch import train as port_train
    from repro_torch.optim import adamw
    if optimizer["clip"] != 1.0:
        raise ValueError("the port's training step clips at 1.0")
    lr = adamw.wsd_schedule(schedule["base_lr"], schedule["warmup"],
                            schedule["stable"], schedule["decay"],
                            schedule["final_frac"])
    opt = adamw.AdamW(lr=lr, b1=optimizer["b1"], b2=optimizer["b2"],
                      eps=optimizer["eps"],
                      weight_decay=optimizer["weight_decay"])
    return opt, port_train.make_step(api_, opt, False)


def plain_attention_calls() -> int:
    """Calls of the flash kernel's plain (CPU) versions, forward and
    backward: none may run in a window on the card."""
    from repro_torch.kernels import flash_attention as fa
    return fa.plain_calls + fa.backward_plain_calls
