"""GPipe-style pipeline parallelism over a mesh axis (default: 'pod')
(counterpart of ``repro.runtime.pipeline``).

The multi-pod mesh's leading axis defaults to data parallelism, but
cross-pod links are far slower than those inside a pod: for models whose
gradient all-reduce would saturate them, pipelining the *layers* across
pods sends only microbatch activations over the slow links instead of
full gradients.

One process per stage: stage ``s`` of ``n_stages`` runs layers ``[s*L/n,
(s+1)*L/n)`` of the stack; microbatches flow through the reference's
schedule of ``n_micro + n_stages - 1`` slots, stage 0 injecting
microbatch ``t`` at slot ``t`` and the last stage banking microbatch ``t -
(n_stages - 1)``; the boundary transfer is :class:`_Shift`, a
``torch.autograd.Function`` whose forward sends to the next stage and
receives from the previous one (``dist.batch_isend_irecv``; the first
stage receives zeros, as from ``lax.ppermute``) and whose backward does
the reverse. Outputs are zeroed off the last stage and summed over the
axis, so every stage returns the result (bubble fraction (S-1)/(M+S-1)).

The parameters and ``x`` are whole on every stage, as replicated inputs:
each stage cuts its layers out, and their gradients and ``x``'s are
summed over the axis in the backward, so every stage ends with the whole
gradient. The final sum is an all-reduce whose backward is the identity
(every stage holds the same output and back-propagates it alike); the
all-reduce of ``torch.distributed.nn.functional`` sums the stages'
cotangents in its backward, which would count the gradient ``n_stages``
times.

Without a mesh, or without the axis, the layers run serially.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch
import torch.distributed as dist

from repro_torch.runtime import tp
from repro_torch.runtime.partition import _tree_map, current_mesh


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _serial(layer_fn, stacked_params, x, lo: int, hi: int) -> torch.Tensor:
    for i in range(lo, hi):
        x = layer_fn(_tree_map(lambda leaf: leaf[i], stacked_params), x)
    return x


class _Shift(torch.autograd.Function):
    """Forward: send ``h`` to the next stage, return what the previous
    stage sent (zeros on the first). Backward: the reverse."""

    @staticmethod
    def forward(ctx, h, group, stage, n_stages, tag):
        ctx.args = (group, stage, n_stages, tag)
        return _exchange(h.contiguous(), group, stage, n_stages, +1, tag)

    @staticmethod
    def backward(ctx, dy):
        group, stage, n_stages, tag = ctx.args
        return (_exchange(dy.contiguous(), group, stage, n_stages, -1, tag),
                None, None, None, None)


def _exchange(h: torch.Tensor, group, stage: int, n_stages: int,
              direction: int, tag: int) -> torch.Tensor:
    """Send ``h`` to stage ``stage + direction`` and receive from ``stage -
    direction``, where those exist; zeros where nothing arrives."""
    out = torch.zeros_like(h)
    dst, src = stage + direction, stage - direction
    ops = []
    if 0 <= dst < n_stages:
        ops.append(dist.P2POp(dist.isend, h, dist.get_global_rank(
            group, dst), group, tag))
    if 0 <= src < n_stages:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(
            group, src), group, tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def pipeline_forward(layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stacked_params: Any, x: torch.Tensor,
                     n_microbatches: int, axis: str = "pod") -> torch.Tensor:
    """Run ``layer_fn`` over a stage-split layer stack.

    layer_fn(params_slice_for_one_layer, x) -> x  (applied per layer)
    stacked_params: tree with leading layer axis L (L % n_stages == 0)
    x: (B, ...) global batch (B % n_microbatches == 0)
    """
    mesh = current_mesh()
    L = _leaves(stacked_params)[0].shape[0]
    if mesh is None or axis not in mesh.mesh_dim_names:
        # no stage axis available: run serially (single-host debug)
        return _serial(layer_fn, stacked_params, x, 0, L)
    i = mesh.mesh_dim_names.index(axis)
    n_stages, stage = mesh.size(i), mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    B = x.shape[0]
    if B % n_microbatches or L % n_stages:
        raise ValueError(f"pipeline_forward: batch {B} over "
                         f"{n_microbatches} microbatches, {L} layers over "
                         f"{n_stages} stages")
    mb, per = B // n_microbatches, L // n_stages
    axes = [axis] if n_stages > 1 else []

    def replicated(t):
        # a whole input on every stage: its gradient summed over the axis
        return tp._ReduceBackward.apply(t, axes) if axes else t
    params = _tree_map(lambda t: replicated(t)[stage * per:(stage + 1) * per],
                       stacked_params)
    mbs = replicated(x).reshape(n_microbatches, mb, *x.shape[1:])

    n_slots = n_microbatches + n_stages - 1
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)
    carry = torch.zeros_like(mbs[0])
    outputs = [torch.zeros_like(mbs[0]) for _ in range(n_microbatches)]
    for t in range(n_slots):
        # stage 0 injects microbatch t (clipped); a ``where`` as in the
        # reference, so that every stage's graph holds x and the backward
        # sums over the axis meet on every stage
        h_in = torch.where(first, mbs[min(t, n_microbatches - 1)], carry)
        h_out = _serial(layer_fn, params, h_in, 0, per)
        # the last stage banks its result for microbatch t - (n_stages - 1)
        # (a ``where`` on every stage, which keeps each stage's output in
        # its graph)
        j = t - (n_stages - 1)
        if j >= 0:
            outputs[j] = torch.where(last, h_out, outputs[j])
        if t < n_slots - 1:
            carry = _Shift.apply(h_out, group, stage, n_stages, t)
    # every stage holds `outputs`, but only the last stage's are real: the
    # others are zeros, and the sum over the axis hands every stage the
    # result
    out = torch.stack(outputs)
    if axes:
        out = tp._ReduceForward.apply(out, axes)
    return out.reshape(B, *x.shape[1:])
