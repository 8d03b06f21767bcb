"""The precisions the reference runs in.

``REFERENCE``: every product and sum in float32 (TF32 off); the
parameters are held between training steps in the configuration's dtype
(bfloat16, no float32 master copy), as the configuration states.

``CONTROL``: the nearest precision below bfloat16, float8 e4m3 with one
scale per tensor: both operands of every product, the parameters held
between steps, and the KV caches and logits the model hands out.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

F32 = torch.float32
E4M3_MAX = 448.0


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def as_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and held in float32."""
    return x.to(dtype).to(F32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to e4m3's largest finite value."""
    amax = x.detach().abs().amax().to(F32)
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    return ((x * scale).to(torch.float8_e4m3fn).to(F32) / scale).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    product: Callable[[torch.Tensor], torch.Tensor]   # each operand
    held: Callable[[torch.Tensor, torch.dtype], torch.Tensor]  # params
    out: Callable[[torch.Tensor], torch.Tensor]       # caches, logits


REFERENCE = Precision("float32", exact, as_dtype, exact)
CONTROL = Precision("float8_e4m3", fp8, lambda x, dtype: fp8(x), fp8)
