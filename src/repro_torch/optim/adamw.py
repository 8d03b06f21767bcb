"""AdamW with cosine / WSD (warmup-stable-decay, MiniCPM) schedules
(counterpart of ``repro.optim.adamw``).

The state is a plain ``NamedTuple`` so the checkpoint layer treats it like
any tree: ``mu`` and ``nu`` are float32 lists in the order of the
parameter list the optimizer is handed (a model's ``parameters()``, which
is ``named_parameters()`` order), ``count`` an int32 0-d tensor. The
update runs in place under ``torch.no_grad()`` (the reference returns new
trees): the moments and the parameters are overwritten, so a step holds no
second copy of either.

Numerics follow the reference's float32 arithmetic: ``count`` is
incremented before use; the bias corrections ``1 - b ** count`` and the
learning rate ``lr(count)`` are float32 tensors, as JAX's weakly typed
Python floats make them (not Python doubles); the step
``(m2 / b1c) / (sqrt(v2 / b2c) + eps) + wd * p`` is float32, and
``p_f32 - lr * step`` is cast back to the parameter's dtype, so bfloat16
parameters keep no float32 master copy, as in the reference. Weight decay
applies to every leaf, norms and embeddings included.

On CUDA tensors the norm and the update are two hand-written
multi-tensor kernels (``kernels/adamw.py``): the trainer computes the norm
and the clipping scale (:func:`clip_scale`, which returns the gradients
with the scale beside them, :class:`ScaledGrads`) and hands them to
:meth:`AdamW.update`, which applies the scale as it reads each gradient, so no scaled copy of the
gradients is made. On CPU tensors the plain loop runs, which equals
clip-then-update bit for bit.

The update runs inside the span ``optim.adamw`` and the norm and scale
inside ``optim.clip`` (``obs.ranges``: free unless a profiler or ``obs``
records).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Sequence, Tuple

import torch
import torch.distributed

from repro_torch.kernels import adamw as kernels
from repro_torch.obs import ranges

F32 = torch.float32


class ScaledGrads(list):
    """Gradients with the float32 0-d scale that clipping found for them,
    not yet applied: :meth:`AdamW.update` multiplies each gradient by it
    (in float32, cast back to its dtype) as it reads it."""

    def __init__(self, grads: Sequence[torch.Tensor], scale: torch.Tensor):
        super().__init__(grads)
        self.scale = scale


class AdamWState(NamedTuple):
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, dtype=F32)      # noqa: E731
        device = params[0].device if len(params) else "cpu"
        return AdamWState([zeros(p) for p in params],
                          [zeros(p) for p in params],
                          torch.zeros((), dtype=torch.int32, device=device))

    def bias_corrections(self, count: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``1 - b1 ** count`` and ``1 - b2 ** count`` in float32."""
        cf = count.to(F32)
        return 1 - torch.pow(self.b1, cf), 1 - torch.pow(self.b2, cf)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamWState,
               params: Sequence[torch.Tensor]
               ) -> Tuple[Sequence[torch.Tensor], AdamWState]:
        """One step over the parameter list, in place: returns ``params``
        (the same tensors, updated) and the state with the same moment
        tensors (updated) and the incremented count. :class:`ScaledGrads`
        are scaled as they are read, as :func:`clip_by_global_norm`'s
        copy would be."""
        if not (len(grads) == len(params) == len(state.mu)
                == len(state.nu)):
            raise ValueError(f"AdamW.update: {len(grads)} grads, "
                             f"{len(params)} params, {len(state.mu)} moments")
        with ranges.span("optim.adamw"):
            count = state.count + 1
            b1c, b2c = self.bias_corrections(count)
            kernels.update(params, state.mu, state.nu, grads,
                           self.lr(count), b1c, b2c,
                           getattr(grads, "scale", None), self.b1, self.b2,
                           self.eps, self.weight_decay)
        return params, AdamWState(state.mu, state.nu, count)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable:
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(F32)
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clip((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, base_lr * cos)
    return lr


def wsd_schedule(base_lr: float, warmup: int, stable: int, decay: int,
                 final_frac: float = 0.01) -> Callable:
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): linear warmup,
    long flat stage, sharp (exponential-ish) decay tail."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(F32)
        warm = base_lr * s / max(warmup, 1)
        in_decay = torch.clip((s - warmup - stable) / max(decay, 1), 0.0,
                              1.0)
        dec = base_lr * torch.pow(final_frac, in_decay)
        flat = torch.full_like(s, base_lr)
        return torch.where(s < warmup, warm,
                           torch.where(s < warmup + stable, flat, dec))
    return lr


@torch.no_grad()
def clip_scale(grads: Sequence[torch.Tensor], max_norm: float
               ) -> Tuple[ScaledGrads, torch.Tensor]:
    """The gradients with their clipping scale ``min(1, max_norm / (norm
    + 1e-9))`` not yet applied (:class:`ScaledGrads`), and the float32
    global norm; the scale and the norm are 0-d on the gradients' device.
    The sum of squares runs over the leaves in order, as the reference's
    Python ``sum`` (on CUDA tensors: the norm kernel's fixed order)."""
    with ranges.span("optim.clip"):
        return _scaled(grads, kernels.global_sq_norm(grads), max_norm)


@torch.no_grad()
def clip_scale_on_mesh(grads: Sequence[torch.Tensor],
                       placements: Sequence[Sequence], mesh,
                       max_norm: float) -> Tuple[ScaledGrads, torch.Tensor]:
    """:func:`clip_scale` of sharded gradients: ``grads`` are this rank's
    local shards, ``placements`` their DTensor placements on ``mesh``.
    Each shard's squares count once (on the ranks at index 0 of every
    mesh dim that replicates it), in leaf order, and one all-reduce over
    the mesh's ranks sums them; on one rank it is :func:`clip_scale`
    exactly."""
    with ranges.span("optim.clip"):
        coord = mesh.get_coordinate()
        include = [all(c == 0 for c, p in zip(coord, pl) if p.is_replicate())
                   for pl in placements]
        total = kernels.global_sq_norm(grads, include)
        if mesh.size() > 1:
            torch.distributed.all_reduce(total)
        return _scaled(grads, total, max_norm)


def _scaled(grads: Sequence[torch.Tensor], total: torch.Tensor,
            max_norm: float) -> Tuple[ScaledGrads, torch.Tensor]:
    norm = torch.sqrt(total)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return ScaledGrads(grads, scale), norm


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))`` (in
    float32, cast back to its dtype) and return them with the float32
    global norm: :func:`clip_scale` with the scale applied."""
    scaled, norm = clip_scale(grads, max_norm)
    return [(g.to(F32) * scaled.scale).to(g.dtype) for g in scaled], norm

