"""Architecture + shape configuration registry (counterpart of
``repro.configs.base``, copied apart from ``torch_dtype``, which takes
the place of the reference's ``jdtype``).

Every assigned architecture provides one ``ArchConfig`` (exact dims from the
assignment table) plus a ``reduced()`` smoke-test variant. Shapes are the
four assigned input-shape cells; ``long_500k`` is only *runnable* for
sub-quadratic archs (ssm / hybrid) — full-attention archs record a skip
(DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    shared_expert: bool = False
    capacity_factor: float = 1.25
    aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int = 128
    expand: int = 2
    d_conv: int = 4
    head_dim: int = 64
    chunk: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class EncDecSpec:
    n_enc_layers: int = 6
    enc_len: int = 1500          # whisper 30 s -> 1500 frames (stub input)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    activation: str = "swiglu"
    norm: str = "rms"            # rms | ln
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    residual_scale: float = 1.0  # minicpm depth-scaled residuals
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    share_every: int = 0         # hybrid: shared attn block cadence
    encdec: Optional[EncDecSpec] = None
    n_patches: int = 256         # vlm stub patch count
    dtype: str = "bfloat16"
    remat: bool = True           # activation checkpointing per layer
    attention_impl: str = "full"     # full | chunked (online-softmax scan)
    attention_chunk: int = 1024
    moe_impl: str = "shard_map"      # shard_map (local EP, §Perf A2: 149x
                                     #   less collective) | gspmd (baseline)
    source: str = ""             # provenance tag from the assignment

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding-table vocab padded to a multiple of 256 so the vocab
        dim shards evenly over the 16-way model axis (padded logit columns
        are masked in the loss and at decode). Standard production practice
        (MaxText/Megatron pad vocab the same way)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def has_decoder(self) -> bool:
        return True              # all assigned archs decode (none enc-only)

    def reduced(self) -> "ArchConfig":
        """Smoke-test configuration: same family, tiny dims."""
        kw = dataclasses.asdict(self)
        kw.update(
            n_layers=2 if self.share_every == 0 else max(2, 2 * 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            head_dim=16,
        )
        if self.moe:
            kw["moe"] = MoESpec(n_experts=4,
                                top_k=min(self.moe.top_k, 2),
                                shared_expert=self.moe.shared_expert)
        else:
            kw["moe"] = None
        if self.ssm:
            kw["ssm"] = SSMSpec(d_state=16, expand=2, d_conv=4, head_dim=16,
                                chunk=16)
        else:
            kw["ssm"] = None
        if self.share_every:
            kw["share_every"] = 2
            kw["n_layers"] = 4
        if self.encdec:
            kw["encdec"] = EncDecSpec(n_enc_layers=2, enc_len=32)
        kw["n_patches"] = 8 if self.family == "vlm" else self.n_patches
        kw["remat"] = False
        return ArchConfig(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_arch(arch_id: str) -> ArchConfig:
    if not _REGISTRY:
        load_all()
    return _REGISTRY[arch_id]


def all_archs() -> Dict[str, ArchConfig]:
    if not _REGISTRY:
        load_all()
    return dict(_REGISTRY)


def load_all() -> None:
    """Import every config module (they self-register)."""
    from repro_torch.configs import (  # noqa: F401
        llama4_scout_17b_a16e, granite_moe_3b_a800m, minicpm_2b,
        internlm2_20b, qwen1_5_4b, yi_9b, mamba2_1_3b, zamba2_2_7b,
        internvl2_76b, whisper_base)


def cell_runnable(cfg: ArchConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    """Is this (arch x shape) cell runnable? (False, reason) if skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic():
        return False, ("full quadratic attention at 524k context is not "
                       "deployable; arch ships no sub-quadratic variant "
                       "(DESIGN.md §4)")
    return True, ""
