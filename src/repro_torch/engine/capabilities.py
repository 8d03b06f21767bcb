"""Per-backend capability sets — the declared contract of what each
execution substrate can lower.

The port's counterpart of ``repro.engine.capabilities``: the accelerator
backend is ``"cuda"`` (the hand-written CUDA fabric interpreter,
``kernels/fabric_reduce.py``), and its capability set equals the
reference's ``"pallas"`` set, so skip reasons and the conformance pins
carry over unchanged.  Eligibility is *feature detection*:

  * :func:`dfg_features` analyzes one DFG and returns the set of fabric
    features its execution requires (conditionals, reductions, loop state,
    recirculation, ...);
  * :data:`CAPS` declares, per backend, which features that substrate can
    lower;
  * :func:`check_backend` raises a :class:`CapabilityError` **naming every
    offending feature** when a kernel exceeds its backend's capability set
    — mirroring the frontend's named-equation diagnostics.

The split between compile-time (structural) and dispatch-time checks:
``emit_every`` is a node property but "single emission" depends on the
stream length, which DFG-compiled artifacts only learn at dispatch — so
:func:`check_stream_length` runs inside the CUDA dispatcher as well.

Capability matrix (DESIGN.md §11):

  feature               sim   cuda     why cuda can('t)
  ------------------------------------------------------------------
  elementwise chains     x      x      flat tiles, 1-8 items a thread
  branch-merge conds     x      x      speculative legs + masked select
  reductions (1 emit)    x      x      one pass per lane (a warp up to 256
                                       elements, a block up to 4096); only
                                       longer lanes fold slices after
  segmented reductions   x      -      mid-stream emissions misalign units
  loop-state cells       x      -      per-element sequential carry
  recirculation loops    x      -      data-dependent trip counts
  multi-shot plans       x      x      per-shot kernels, IMN/OMN handoff
  lane batching          x      x      one grid of lanes (lane_layout)
"""
from __future__ import annotations

from fractions import Fraction
from typing import Dict, FrozenSet, Iterable, Tuple

from repro_torch.core import dfg as D
from repro_torch.core.isa import AluOp


class CapabilityError(ValueError):
    """A kernel requires a feature its backend's capability set lacks."""


# reduction ops a tile-parallel substrate can re-associate (the identity /
# combine table in kernels/fabric_reduce.py); SHL/SHR/NOP accumulators are
# order-dependent and stay on the sequential simulator
ASSOCIATIVE_REDUCTION_OPS = (AluOp.ADD, AluOp.SUB, AluOp.MUL, AluOp.AND,
                             AluOp.OR, AluOp.XOR)

# feature flags a DFG (or plan) may require
FEATURE_DESC: Dict[str, str] = {
    "branch-merge": "Branch/Merge conditional (select-reducible legs)",
    "merge-order": "arrival-ordered MERGE (legs are not complementary "
                   "branch paths)",
    "reduction": "accumulator reduction feeding an output",
    "reduction-interior": "reduction consumed by an interior node",
    "reduction-op": "reduction with a non-associative op (SHL/SHR/NOP)",
    "reduction-subrate": "reduction paced by a sub-rate (branch-leg) stream",
    "subrate-output": "sub-rate output stream (unmerged branch leg)",
    "loop-state": "loop-carried back edge (state cell)",
    "recirculation": "recirculation edge (data-dependent loop)",
    "multi-shot": "multi-shot plan (IMN/OMN buffer handoff between shots)",
}

# what each backend can lower; "sim" is the semantic reference and takes
# everything the IR can express
CAPS: Dict[str, FrozenSet[str]] = {
    "sim": frozenset(FEATURE_DESC),
    "cuda": frozenset({"branch-merge", "reduction", "multi-shot"}),
}

BACKENDS = tuple(sorted(CAPS))


def _rates(g: D.DFG) -> Dict[Tuple[str, str], Fraction]:
    """Token rate of every signal relative to the input streams — the
    partitioner's analysis, reused verbatim so capability classification
    can never drift from the rates the planner actually cuts on. Callers
    only consult it for graphs without recirculation (data-dependent loops
    have no static rates), where the partitioner's loop-body cases are
    inert. Lazy import: the frontend layers above the engine."""
    from repro_torch.frontend.partition import _rates as partition_rates
    return partition_rates(g)


def select_conds(g: D.DFG):
    """Per-wire structural validity provenance: the set of
    ((predicate wire), leg) constraints ANDed into each wire's token
    validity. Proves select-reducibility — every MERGE's legs must be
    complementary t/f paths of ONE predicate wire. The single shared
    implementation behind both the compile-time capability gate (here)
    and the plain evaluator's check (``kernels/ref.eval_dfg_streams``),
    so the two can never drift. Back-edge operands carry an
    always-present register token (empty condition set).

    Returns ``(conds, offender)``: the provenance map plus the name of
    the first non-reducible MERGE (``None`` when every merge reduces;
    ``conds`` is partial past an offender)."""
    conds: Dict[Tuple[str, str], frozenset] = {}

    def cond(e) -> frozenset:
        if e is None or e.back:
            return frozenset()
        return conds.get((e.src, e.src_port), frozenset())

    for name in g.topo_order():
        n = g.nodes[name]
        if n.kind in (D.INPUT, D.CONST):
            conds[(name, "out")] = frozenset()
        elif n.kind == D.BRANCH:
            ec = g.operand(name, "ctrl")
            base = cond(g.operand(name, "a")) | cond(ec)
            pred = (ec.src, ec.src_port)
            conds[(name, "t")] = base | {(pred, "t")}
            conds[(name, "f")] = base | {(pred, "f")}
        elif n.kind == D.MERGE:
            ca = cond(g.operand(name, "a"))
            cb = cond(g.operand(name, "b"))
            da, db = ca - cb, cb - ca
            ok = len(da) == 1 and len(db) == 1
            if ok:
                ((pa, la),) = da
                ((pb, lb),) = db
                ok = pa == pb and {la, lb} == {"t", "f"}
            if not ok:
                return conds, name
            conds[(name, "out")] = ca & cb
        elif n.kind != D.OUTPUT:
            conds[(name, "out")] = frozenset().union(
                *(cond(e) for e in g.in_edges(name)))
    return conds, None


def _merges_select_reducible(g: D.DFG) -> bool:
    return select_conds(g)[1] is None


def dfg_features(g: D.DFG) -> FrozenSet[str]:
    """The feature set one DFG requires of its execution substrate.

    Memoized on the DFG object (dropped by ``DFG.__getstate__`` like the
    executor's plan cache): the analysis includes the partitioner's rate
    model and runs on dispatch paths, so repeat requests must not re-walk
    the graph."""
    memo = g.__dict__.get("_features_memo")
    if memo is not None:
        return memo
    feats = set()
    if g.has_recirculation():
        feats.add("recirculation")
    if any(e.back and e.init is not None for e in g.edges):
        feats.add("loop-state")
    if any(n.kind in (D.BRANCH, D.MERGE) for n in g.nodes.values()):
        feats.add("branch-merge")
        if "recirculation" not in feats and not _merges_select_reducible(g):
            feats.add("merge-order")
    reductions = [n for n in g.nodes.values() if n.is_reduction()]
    if reductions:
        feats.add("reduction")
        for n in reductions:
            if n.op not in ASSOCIATIVE_REDUCTION_OPS:
                feats.add("reduction-op")
            if any(g.nodes[e.dst].kind != D.OUTPUT
                   for e in g.out_edges(n.name)):
                feats.add("reduction-interior")
    if "recirculation" not in feats:
        rate = _rates(g)
        for o in g.outputs:
            e = g.operand(o, "a")
            if g.nodes[e.src].is_reduction():
                continue        # covered by the reduction flags
            if rate.get((e.src, e.src_port)) != Fraction(1):
                feats.add("subrate-output")
        for n in reductions:
            # a branch-masked accumulator fires only on arriving tokens; a
            # speculative tile-reduce would fold every lane — flag it so
            # tile-parallel backends reject instead of silently diverging
            e = g.operand(n.name, "a")
            if e is not None and \
                    rate.get((e.src, e.src_port)) != Fraction(1):
                feats.add("reduction-subrate")
    g.__dict__["_features_memo"] = frozenset(feats)
    return g.__dict__["_features_memo"]


def plan_features(plan) -> FrozenSet[str]:
    """Feature union over a partition plan's shots (+ the plan shape)."""
    feats = set()
    for shot in plan.shots:
        feats |= dfg_features(shot.dfg)
    if plan.n_shots > 1:
        feats.add("multi-shot")
    return frozenset(feats)


def missing_features(features: Iterable[str], backend: str) -> Tuple[str, ...]:
    if backend not in CAPS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    return tuple(sorted(f for f in features if f not in CAPS[backend]))


def check_backend(features: Iterable[str], backend: str, name: str) -> None:
    """Raise a named diagnostic when ``features`` exceed the backend caps."""
    missing = missing_features(features, backend)
    if missing:
        detail = "; ".join(f"{FEATURE_DESC.get(f, f)} [{f}]" for f in missing)
        raise CapabilityError(
            f"{name}: backend '{backend}' cannot lower: {detail} — "
            f"use backend='sim'")


def backend_skip_reason(g: D.DFG, length: int,
                        backend: str = "cuda"):
    """One-stop eligibility probe: the named reason ``backend`` cannot run
    ``g`` at ``length`` (missing capability features joined with '+', or
    ``"segmented-reduction"``), or ``None`` when it must run. The single
    source of truth shared by the conformance gate, the benchmarks, and
    any caller that wants to route around a rejection instead of catching
    :class:`CapabilityError`."""
    missing = missing_features(dfg_features(g), backend)
    if missing:
        return "+".join(missing)
    if backend != "sim":               # a tile-parallel-only constraint
        try:
            check_stream_length(g, length, backend)
        except CapabilityError:
            return "segmented-reduction"
    return None


def check_stream_length(g: D.DFG, length: int,
                        backend: str = "cuda") -> None:
    """Dispatch-time reduction-emission check: a tile-parallel backend only
    lowers *single-emission* reductions (``emit_every`` of 0 or the full
    stream length); mid-stream segment emissions misalign with the tile
    grid.  Raises naming the offending node."""
    for n in g.nodes.values():
        if n.is_reduction() and n.emit_every not in (0, length):
            raise CapabilityError(
                f"{g.name}: reduction node '{n.name}' emits every "
                f"{n.emit_every} tokens mid-stream (stream length {length}); "
                f"the '{backend}' backend lowers only single-emission "
                f"reductions (emit_every 0 or the full stream length) — "
                f"use backend='sim'")
