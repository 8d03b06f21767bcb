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
                                          current_mesh, kv_cache_spec,
                                          placements)


def _axes(names: Sequence[str]) -> List[str]:
    """The axes of ``names`` the ambient mesh has with more than one
    rank, in the mesh's order."""
    m = current_mesh()
    if m is None:
        return []
    return [a for a, n in zip(m.mesh_dim_names, m.shape)
            if a in names and n > 1]


def _groups(axes: Sequence[str]) -> List:
    """The process groups of the ambient mesh's ``axes``."""
    m = current_mesh()
    return [m.get_group(a) for a in axes]


def _all_reduce(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    for g in groups:
        dist.all_reduce(x, group=g)
    return x


class _ReduceForward(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axes):
        return _all_reduce(x, _groups(axes))

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _ReduceBackward(torch.autograd.Function):
    """Identity forward, all-reduce (sum) of the gradient backward over
    the groups the forward found (autograd runs a CUDA tensor's backward
    on a device thread of its own, outside the ambient mesh)."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.groups = _groups(axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.groups), None


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


# ---------------------------------------------------------------------------
# decode state on a mesh (KV caches, SSM states)
# ---------------------------------------------------------------------------

def shard_box(shape: Sequence[int], mesh, pls: Sequence
              ) -> Tuple[List[int], List[int]]:
    """This rank's shard of a tensor of ``shape`` placed by ``pls`` on
    ``mesh``: its local shape and its offset in the whole, cut as DTensor
    cuts (``torch.chunk``, mesh dims in order)."""
    size, off = list(shape), [0] * len(shape)
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard):
            n, r = mesh.size(i), mesh.get_local_rank(i)
            c = -(-size[pl.dim] // n)
            lo = min(r * c, size[pl.dim])
            hi = min(lo + c, size[pl.dim])
            off[pl.dim] += lo
            size[pl.dim] = hi - lo
    return size, off


def contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (computed, so that
    no tensor is made for them, not even a meta one a cost tracker would
    see)."""
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def single_request(batch: int) -> bool:
    """Whether ``batch`` rows on this rank make a global batch of one
    (the long-context decode layout of ``partition.kv_cache_spec``)."""
    return batch * batch_split()[1] == 1


def state_zeros(shape: Sequence[int], dtype: torch.dtype, device,
                spec: P, bdim: int = 1) -> torch.Tensor:
    """Zeroed decode state of ``shape`` (this rank's batch rows at dim
    ``bdim``): a plain tensor outside a mesh, else a DTensor placed by
    ``spec`` from this rank's zeroed shard (the global batch is the rows
    of every batch rank where ``spec`` shards it)."""
    m = current_mesh()
    if m is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    pl = placements(spec, m)
    glob = list(shape)
    if spec[bdim] is not None:
        glob[bdim] *= batch_split()[1]
    local, _ = shard_box(glob, m, pl)
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=device), m, pl,
        run_check=False, shape=torch.Size(glob),
        stride=contiguous_strides(glob))


def kv_cache_zeros(cfg, shape: Sequence[int], dtype: torch.dtype, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed k and v caches of ``shape`` (L or sites, this rank's batch
    rows, S, n_kv, hd): plain tensors outside a mesh, else DTensors placed
    by ``partition.kv_cache_spec``."""
    if current_mesh() is None:
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))
    spec = kv_cache_spec(cfg, single_request(shape[1]))
    return (state_zeros(shape, dtype, device, spec),
            state_zeros(shape, dtype, device, spec))


def state_whole(x: torch.Tensor) -> torch.Tensor:
    """A layer's decode state (batch at dim 0) as this rank's rows, whole
    along every other dim (gathered where its placements shard them); a
    plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    keep = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in x.placements]
    return x.redistribute(x.device_mesh, keep).to_local()


def state_write(x: torch.Tensor, new: torch.Tensor, start: int = 0,
                dim: int = -1) -> None:
    """Write ``new`` (this rank's rows, whole along every other dim) into
    a layer's decode state ``x`` in place, in ``x``'s dtype, at ``start``
    along ``dim`` (the whole of ``x`` with ``dim`` -1): into this rank's
    shard only for a DTensor."""
    if not isinstance(x, DTensor):
        (x if dim < 0 else x.narrow(dim, start, new.shape[dim])).copy_(new)
        return
    loc = x.to_local()
    _, off = shard_box(x.shape, x.device_mesh, x.placements)
    src, dst = new, loc
    for d in range(1, loc.dim()):
        if d == dim:                    # positions start .. start + n
            a = max(start, off[d])
            b = min(start + new.shape[d], off[d] + loc.shape[d])
            if a >= b:
                return
            src = src.narrow(d, a - start, b - a)
            dst = dst.narrow(d, a - off[d], b - a)
        else:
            src = src.narrow(d, off[d], loc.shape[d])
    dst.copy_(src.to(dst.dtype))
