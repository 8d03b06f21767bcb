"""Tensor-parallel compute on the ambient mesh (``partition.use_mesh``):
how a layer takes its parameters and moves its activations when the model
runs on a ("data", "model") or ("pod", "data", "model") mesh.

One process per rank (SPMD). Each rank holds its rows of the batch (the
batch axes 'pod' and 'data') and the model's parameters as DTensors with
their specs' placements (``partition.place_model``). A layer computes on
local tensors:

  * :func:`whole` — a parameter gathered in full, for a computation every
    'model' rank repeats (norms, embeddings, the SSD layer, the router of
    the global MoE); its gradient is partial over the batch axes and
    equal on every 'model' rank;
  * :func:`part` — this 'model' rank's slice of a parameter (a head, ff
    or expert range), straight from its shard where the placement already
    holds that slice, else gathered and cut; its gradient is partial over
    the batch axes and over 'model'.

A parameter's gradient thus arrives as a DTensor whose placements say
which sums are still due (``Partial``); the trainer reduces each into its
parameter's placements once a step, whatever number of uses it had.
  * :func:`enter_model` / :func:`leave_model` — Megatron's f and g around
    a tensor-parallel region: identity forward and an all-reduce of the
    gradient over 'model', an all-reduce forward and identity backward;
  * :func:`batch_mean` — a per-rank mean made the mean over the global
    batch (an all-reduce over the batch axes, identity backward: every
    rank holds the same loss and back-propagates its own rows).

Outside a mesh, or on a plain tensor, each of these returns its input
unchanged, so the one-device path runs the same operations as before.
Groups of one rank take no collective, which keeps a one-rank mesh
bit-equal to no mesh.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.runtime.partition import (BATCH_AXES, MODEL, P,
                                          current_mesh, placements)


def _axes(names: Sequence[str]) -> List[str]:
    """The axes of ``names`` the ambient mesh has with more than one
    rank, in the mesh's order."""
    m = current_mesh()
    if m is None:
        return []
    return [a for a, n in zip(m.mesh_dim_names, m.shape)
            if a in names and n > 1]


def _all_reduce(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    m = current_mesh()
    x = x.clone(memory_format=torch.contiguous_format)
    for a in axes:
        dist.all_reduce(x, group=m.get_group(a))
    return x


class _ReduceForward(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axes):
        return _all_reduce(x, axes)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _ReduceBackward(torch.autograd.Function):
    """Identity forward, all-reduce (sum) of the gradient backward."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.axes), None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward, the gradient times ``s`` backward."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return dy * ctx.s, None


def model_split() -> Tuple[int, int]:
    """(this rank's index, size) along 'model'; (0, 1) outside a mesh."""
    m = current_mesh()
    if m is None or MODEL not in m.mesh_dim_names:
        return 0, 1
    return m.get_local_rank(MODEL), m.size(m.mesh_dim_names.index(MODEL))


def batch_split() -> Tuple[int, int]:
    """(this rank's index, count) over the batch axes, row-major: which
    contiguous block of a global batch's rows it holds."""
    m = current_mesh()
    idx, n = 0, 1
    if m is None:
        return idx, n
    for a, size in zip(m.mesh_dim_names, m.shape):
        if a in BATCH_AXES:
            idx, n = idx * size + m.get_local_rank(a), n * size
    return idx, n


def ranges(n: int, parts: int) -> List[Tuple[int, int]]:
    """``n`` items in ``parts`` contiguous ranges whose sizes differ by at
    most one, the larger first (``numpy.array_split``)."""
    q, r = divmod(n, parts)
    out, lo = [], 0
    for i in range(parts):
        hi = lo + q + (i < r)
        out.append((lo, hi))
        lo = hi
    return out


def enter_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f: into a region split over 'model'."""
    axes = _axes((MODEL,))
    return _ReduceBackward.apply(x, axes) if axes else x


def leave_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's g: the 'model' ranks' partial results summed."""
    axes = _axes((MODEL,))
    return _ReduceForward.apply(x, axes) if axes else x


def reduce_batch(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the batch axes, identity backward."""
    axes = _axes(BATCH_AXES)
    return _ReduceForward.apply(x, axes) if axes else x


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """A per-rank mean over equal row blocks as the global mean."""
    _, n = batch_split()
    return reduce_batch(x) / n if n > 1 else x


def share_grad_over_model(x: torch.Tensor) -> torch.Tensor:
    """A value every 'model' rank computes alike, inside a region whose
    parameter gradients are summed over 'model': its gradient is split
    evenly among the ranks so that the sum counts it once."""
    _, n = model_split()
    return _ScaleGrad.apply(x, 1.0 / n) if n > 1 else x


def all_gather_batch(x: torch.Tensor) -> List[torch.Tensor]:
    """``x`` of every rank along the batch axes, in row order, with no
    gradient (row-major over the axes, as :func:`batch_split`)."""
    m = current_mesh()
    out = [x]
    for a in reversed(_axes(BATCH_AXES)):
        gathered = []
        for t in out:
            parts = [torch.empty_like(t) for _ in range(
                m.size(m.mesh_dim_names.index(a)))]
            dist.all_gather(parts, t.contiguous(), group=m.get_group(a))
            gathered.append(parts)
        # the outer axis is slower: its blocks go first
        out = [p[j] for j in range(len(gathered[0])) for p in gathered]
    return out


def _grad_placements(model: str) -> List:
    """Gradient placements for a parameter's local view: summed over the
    batch axes, and over 'model' as ``model`` says (``"partial"``,
    ``"replicate"`` or a ``Shard``)."""
    m = current_mesh()
    out = []
    for a, size in zip(m.mesh_dim_names, m.shape):
        if size == 1:
            out.append(Replicate())       # one rank: nothing to sum
        elif a in BATCH_AXES:
            out.append(Partial())
        elif a == MODEL:
            out.append(Partial() if model == "partial" else
                       Replicate() if model == "replicate" else model)
        else:
            out.append(Replicate())
    return out


def whole(p: torch.Tensor) -> torch.Tensor:
    """A parameter in full on every rank, for a computation the 'model'
    ranks repeat alike."""
    m = current_mesh()
    if m is None or not isinstance(p, DTensor):
        return p
    return _whole(p, m).to_local(
        grad_placements=_grad_placements("replicate"))


def _whole(p: DTensor, m) -> DTensor:
    """``p`` replicated on every mesh dim (itself when it already is)."""
    if all(pl.is_replicate() for pl in p.placements):
        return p
    return p.redistribute(m, [Replicate()] * m.ndim)


def part(p: torch.Tensor, dim: int,
         bounds: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """This 'model' rank's slice ``bounds[rank]`` of dim ``dim`` of a
    parameter (``bounds`` holds every rank's), its gradient summed over
    'model'. Taken straight from the shard where the parameter is already
    split that way over 'model', else gathered and cut."""
    r, n = model_split()
    lo, hi = bounds[r]
    m = current_mesh()
    if m is None or not isinstance(p, DTensor):
        return p if (lo, hi) == (0, p.shape[dim]) else p.narrow(dim, lo,
                                                                 hi - lo)
    if n > 1:
        i = m.mesh_dim_names.index(MODEL)
        c = p.shape[dim] // n
        if (p.placements[i] == Shard(dim) and p.shape[dim] % n == 0
                and list(bounds) == [(j * c, (j + 1) * c)
                                     for j in range(n)]):
            keep = [Shard(dim) if j == i else Replicate()
                    for j in range(m.ndim)]
            view = p if list(p.placements) == keep else p.redistribute(m,
                                                                       keep)
            return view.to_local(
                grad_placements=_grad_placements(Shard(dim)))
    full = _whole(p, m).to_local(grad_placements=_grad_placements("partial"))
    return full if (lo, hi) == (0, p.shape[dim]) else full.narrow(
        dim, lo, hi - lo)


def local_shard(full: torch.Tensor, placements: Sequence) -> torch.Tensor:
    """This rank's shard of a tensor every rank holds in full, cut as a
    DTensor of ``placements`` on the ambient mesh cuts it (even splits)."""
    m = current_mesh()
    t = full
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = m.size(i)
            if t.shape[pl.dim] % n:
                raise ValueError(f"local_shard: dim {pl.dim} of "
                                 f"{tuple(full.shape)} does not split "
                                 f"evenly over {n} ranks")
            t = torch.chunk(t, n, pl.dim)[m.get_local_rank(
                m.mesh_dim_names[i])]
    return t.contiguous()


def activations(x: torch.Tensor) -> torch.Tensor:
    """A rank's rows of the hidden state ``(b_loc, s, d)`` as the DTensor
    between layers: rows over the batch axes, whole over 'model'; the
    local tensor itself outside a mesh."""
    m = current_mesh()
    if m is None:
        return x
    return DTensor.from_local(x, m, placements(P(BATCH_AXES, None, None), m),
                              run_check=False)


def local(x: torch.Tensor) -> torch.Tensor:
    """The local tensor of a DTensor (a plain tensor as it is)."""
    return x.to_local() if isinstance(x, DTensor) else x
