"""The model as run, read from ``configs/<name>.json``'s ``as_run`` group:
the numbers the reference, the weights and the FLOP counts work from."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class MoE:
    n_experts: int
    top_k: int
    capacity_factor: float
    aux_coef: float


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    vocab_padded: int
    tie_embeddings: bool
    embedding_multiplier: float
    residual_multiplier: float
    rms_norm_eps: float
    rope_theta: float
    dtype: str
    moe: Optional[MoE] = None

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads


def model_spec(conf: Dict[str, Any]) -> ModelSpec:
    """The ``as_run`` group of a configuration file as a ``ModelSpec``."""
    kw = dict(conf["as_run"])
    moe = kw.pop("moe", None)
    return ModelSpec(moe=MoE(**moe) if moe else None, **kw)
