"""Gradient compression for cross-pod data parallelism (counterpart of
``repro.optim.grad_compress``).

int8 block-quantized gradients with **error feedback** (the residual is
carried to the next step, so compression error does not bias convergence
— Seide et al. / Karimireddy et al.). Blocks of 1024 values, zero padded;
``scale = max|block| / 127 + 1e-12``; ``torch.round`` (half to even, as
``jnp.round``), clamped to ±127 in int8. The trainer applies it as a pure
transform of the gradient list before clipping, as the reference does on
one host.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

BLOCK = 1024
F32 = torch.float32


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization. Returns (q, scales)."""
    flat = g.to(F32).reshape(-1)
    pad = (-flat.numel()) % BLOCK
    blocks = F.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
                size: int) -> torch.Tensor:
    flat = (q.to(F32) * scale).reshape(-1)[:size]
    return flat.reshape(shape)


def compress_decompress(g: torch.Tensor, err: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback round: returns (g_hat, new_err) with
    g_hat = Q(g + err), new_err = (g + err) - g_hat."""
    target = g.to(F32) + err
    q, scale = _quantize(target)
    g_hat = _dequantize(q, scale, g.shape, g.numel())
    return g_hat.to(g.dtype), target - g_hat


def init_error(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.zeros(p.shape, dtype=F32, device=p.device)
            for p in params]


@torch.no_grad()
def apply(grads: Sequence[torch.Tensor], err_state: Sequence[torch.Tensor]
          ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Compress every gradient with error feedback."""
    outs = [compress_decompress(g, e) for g, e in zip(grads, err_state)]
    return [o[0] for o in outs], [o[1] for o in outs]
