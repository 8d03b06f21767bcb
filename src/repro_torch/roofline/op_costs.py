"""Cost extraction from an eager step, op by op (counterpart of
``repro.roofline.hlo_costs``, which parses XLA's optimized HLO text).

:class:`OpCosts` is a ``TorchDispatchMode``: every aten, ``c10d`` and
registered op that runs inside it — on real tensors or under
``FakeTensorMode``, where nothing runs — adds its costs:

  * **FLOPs** — from ``torch.utils.flop_counter``'s registry of
    formulas (matmuls, convolutions, SDPA, and the flash kernel's
    ``strela::flash_fwd``/``flash_bwd``/``flash_attn``, registered in
    ``kernels/flash_attention.py``).
  * **HBM bytes** — each op's input and output tensors, read and written
    once each. Views and metadata ops (``view``, ``t``, ``expand``,
    ``detach``, ``_unsafe_view``, ``empty`` and the like: the aten
    counterparts of what the reference leaves out, ``bitcast``,
    ``reshape``, ``tuple``, ``parameter``) count nothing. A registered op
    is one boundary: the flash forward counts q, k, v, o and lse once, as
    a fusion counts in the HLO parser. An op that returns nothing and
    writes into its arguments (``strela::adamw_``) counts the tensors it
    writes as its outputs: the update reads g, p, m and v and writes p, m
    and v, 22 bytes a bf16 parameter.
  * **Collective bytes** — the input bytes of each ``c10d`` or
    ``_c10d_functional`` all-reduce, all-gather, reduce-scatter and
    all-to-all, keyed by the reference's five names (:data:`COLLECTIVES`);
    a ``send`` counts as ``collective-permute`` (a ``recv`` is the other
    end of a send and counts nothing).
  * **Live bytes** — the storages each op creates, held from the op that
    makes them to the death of their last tensor (a weakref finalizer on
    the storage). The tensors handed in as ``arguments`` (parameters,
    optimizer state, the batch) are counted apart, as XLA's
    ``memory_analysis`` counts its arguments: ``peak_bytes`` is their
    bytes plus the peak of the live bytes the step creates.

A DTensor op is left to DTensor (the mode returns ``NotImplemented``), so
what is counted are the local ops it runs: every number is one rank's,
as the reference's post-SPMD HLO is one chip's. A Python loop over L
layers runs, and is counted, L times, so the reference's while-loop trip
counts (``hlo_costs.py:228``) have no counterpart.
"""
from __future__ import annotations

import collections
import weakref
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# (namespace's op name) -> (collective, index of the input argument)
_COLLECTIVE_OPS = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_out": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "all_to_all_single": ("all-to-all", 0),
    "send": ("collective-permute", 0),
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")

# ops that move no data: aliases, metadata and allocations without a write
_NO_BYTES = {
    "detach", "_unsafe_view", "alias", "lift_fresh", "t", "view",
    "expand", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_reshape_alias", "as_strided", "unsqueeze",
    "squeeze", "permute", "transpose", "select", "slice", "split",
    "split_with_sizes", "unbind", "chunk", "narrow", "reshape",
    "view_as", "_to_copy_no_op", "wait_tensor", "recv_", "barrier",
    "monitored_barrier_", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "_local_scalar_dense", "is_same_size",
}


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _written(func, args, kwargs) -> List[Any]:
    """The arguments that ``func``'s schema marks as written (``Tensor(a!)``
    or ``Tensor(a!)[]``)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        if a.name in kwargs:
            out.append(kwargs[a.name])
        elif i < len(args):
            out.append(args[i])
    return out


def _is_dtensor(t: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def argument_tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree of modules (their parameters), dicts, lists
    and tuples, a DTensor as its local shard."""
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in argument_tensors(v)]
    if isinstance(tree, torch.Tensor):
        return [tree._local_tensor if _is_dtensor(tree) else tree]
    return []


class OpCosts(TorchDispatchMode):
    """Counts what runs inside it (see the module's docstring).
    ``arguments`` is a tree of the tensors the step is handed, whose
    bytes count apart from the live bytes the step creates."""

    def __init__(self, arguments: Any = ()):
        super().__init__()
        self._flops = 0
        self._bytes = 0.0
        self._coll = {c: 0.0 for c in COLLECTIVES}
        self._bytes_by: Dict[tuple, List[float]] = \
            collections.defaultdict(lambda: [0.0, 0])
        self._coll_by: Dict[tuple, List[float]] = \
            collections.defaultdict(lambda: [0.0, 0])
        self.calls: Dict[str, int] = collections.Counter()
        self._args = {}
        for t in argument_tensors(arguments):
            st = t.untyped_storage()
            self._args[id(st)] = st
        self.argument_bytes = sum(st.nbytes() for st in self._args.values())
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._suspended = 0
        self._patched = None

    def __enter__(self):
        # DTensor derives an op's global output shape by running the op on
        # fake tensors of the global shapes: not the rank's work, so
        # nothing it runs is counted
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        name = "_propagate_tensor_meta_non_cached"
        fn = getattr(SP, name)

        def propagate(*args, **kwargs):
            self._suspended += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._suspended -= 1
        setattr(SP, name, propagate)
        self._patched = (SP, name, fn)
        return super().__enter__()

    def __exit__(self, *exc):
        SP, name, fn = self._patched
        setattr(SP, name, fn)
        return super().__exit__(*exc)

    # ------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        if any(_is_dtensor(t) for t in flat):
            return NotImplemented       # DTensor runs the local ops
        out = func(*args, **kwargs)
        if self._suspended:
            return out                  # DTensor's shape propagation
        name = func._opname
        self.calls[f"{func.namespace}::{name}"] += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self._flops += int(formula(*args, **kwargs, out_val=out))
        # a meta tensor holds no memory anywhere
        ins = [t for t in flat if isinstance(t, torch.Tensor)
               and t.device.type != "meta"]
        outs = [t for t in _tensors(out) if t.device.type != "meta"]
        written = [] if outs else [
            t for t in _tensors(_written(func, args, kwargs))
            if t.device.type != "meta"]
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                b = float(sum(_nbytes(t) for t in _tensors(args[kind[1]])))
                self._coll[kind[0]] += b
                self._record(self._coll_by, kind[0], func, ins, b)
        if (outs or written) and name not in _NO_BYTES and not func.is_view:
            b = float(sum(map(_nbytes, ins))
                      + sum(map(_nbytes, outs or written)))
            self._bytes += b
            self._record(self._bytes_by, name, func, ins, b)
        for t in outs:
            self._hold(t)
        return out

    @staticmethod
    def _record(table, kind: str, func, ins, b: float) -> None:
        """``b`` bytes against (kind, op, input dtypes and shapes)."""
        rec = table[(kind, func.namespace, func._opname,
                     tuple((t.dtype, tuple(t.shape)) for t in ins))]
        rec[0] += b
        rec[1] += 1

    @staticmethod
    def _rows(table, n: int) -> List[Tuple[float, str, str]]:
        rows = []
        for (kind, ns, op, shapes), (b, c) in table.items():
            args = ",".join(f"{str(dt)[6:]}{list(sh)}" for dt, sh in shapes)
            rows.append((b, kind, f"{ns}::{op}({args}) x {int(c)}"))
        return sorted(rows, key=lambda r: -r[0])[:n]

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live or key in self._args:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # ------------------------------------------------------------------
    def flops(self) -> float:
        return float(self._flops)

    def hbm_bytes(self) -> float:
        return self._bytes

    def collective_bytes(self) -> Dict[str, float]:
        return dict(self._coll)

    @property
    def peak_bytes(self) -> int:
        """The arguments' bytes plus the peak of the live bytes the step
        created (one rank's)."""
        return self.argument_bytes + self.peak_live_bytes

    def top_bytes(self, n: int = 15) -> List[Tuple[float, str, str]]:
        """Largest HBM-byte contributors: (bytes, op, "op(input shapes) x
        calls"), the same op on the same shapes summed."""
        return self._rows(self._bytes_by, n)

    def top_collectives(self, n: int = 12) -> List[Tuple[float, str, str]]:
        """Largest collectives: (bytes, kind, "op(input shapes) x
        calls")."""
        return self._rows(self._coll_by, n)
