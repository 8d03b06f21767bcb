"""Partition oversized traced DFGs into multi-shot plans (Sec. IV-B, strat. 3).

A traced graph that exceeds the 4x4 fabric (16 PEs, 4 IMNs, 4 OMNs) cannot
run as one shot. This module cuts it at *stream boundaries* — full-rate
signals whose values can round-trip through memory between fabric
executions — into an ordered list of shots, each a valid, mappable sub-DFG.
Execution goes through ``core.multishot.ShotRunner``: intermediate streams
live in the interleaved banks between shots, and the runner's config-class
accounting models the per-shot reconfiguration + stream re-arm cost exactly
as for the paper's hand-decomposed benchmarks (mm/conv2d/gemver).

Cut legality:
  * only rate-1 signals may cross a shot boundary (a reduction's output
    stream is ``length/emit_every`` tokens — re-injecting it would starve
    the joins downstream), and
  * back-edge strongly-connected components stay within one shot (loop
    state cannot round-trip through memory mid-stream).

The partitioner is greedy over clusters in topological order, verified by
the real place-and-route: a closed shot that fails ``map_dfg`` sheds
clusters until it maps (route-through PEs make pure node counting an
underestimate of fabric pressure).
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import dfg as D
from repro_torch.core.fabric import Fabric
from repro_torch.core.mapper import Mapping, MappingError, map_dfg
from repro_torch.core.multishot import ShotRunner
from repro_torch.frontend.tracer import FrontendError

Sig = Tuple[str, str]      # (producer node in the original DFG, out port)


@dataclasses.dataclass
class Shot:
    """One fabric execution: a mappable sub-DFG plus its stream bindings."""

    key: str
    dfg: D.DFG
    mapping: Mapping
    inputs: List[Tuple[str, Sig]]     # shot INPUT node -> source signal
    outputs: List[Tuple[str, Sig]]    # shot OUTPUT node -> signal it carries
    finals: Dict[str, str]            # original output name -> shot OUTPUT


@dataclasses.dataclass
class Plan:
    """An ordered multi-shot decomposition of one traced DFG."""

    name: str
    dfg: D.DFG                        # the original (pre-partition) graph
    shots: List[Shot]

    @property
    def n_shots(self) -> int:
        return len(self.shots)

    def run(self, inputs: Dict[str, np.ndarray],
            runner: Optional[ShotRunner] = None,
            with_timing: bool = True) -> Dict[str, np.ndarray]:
        """Execute the plan; returns the original DFG's output streams."""
        r = runner or ShotRunner(with_timing=with_timing)
        for shot in self.shots:            # reuse compile-time mappings
            r.seed_mapping(shot.key, shot.mapping)
        env: Dict[Sig, np.ndarray] = {
            (name, "out"): np.asarray(inputs[name], dtype=np.int32)
            for name in self.dfg.inputs}
        results: Dict[str, np.ndarray] = {}
        for shot in self.shots:
            ins = {iname: env[sig] for iname, sig in shot.inputs}
            outs = r.run_shot(
                shot.key, shot.dfg, ins,
                streams_changed=len(shot.inputs) + len(shot.outputs),
                config_class=shot.key)
            for oname, sig in shot.outputs:
                env[sig] = outs[oname]
            for orig, oname in shot.finals.items():
                results[orig] = outs[oname]
        missing = [o for o in self.dfg.outputs if o not in results]
        if missing:
            raise FrontendError(f"{self.name}: plan never produced {missing}")
        return {o: results[o] for o in self.dfg.outputs}


# ---------------------------------------------------------------------------
# analysis helpers
# ---------------------------------------------------------------------------

def _functional(g: D.DFG) -> List[str]:
    return [n for n in g.topo_order()
            if g.nodes[n].kind in (D.ALU, D.CMP, D.MUX, D.BRANCH, D.MERGE)]

def _clusters(g: D.DFG, order: Sequence[str]) -> List[List[str]]:
    """Group functional nodes so loop components stay atomic: a back edge
    src->dst closes a cycle through every forward path dst ->* src, and all
    nodes on those paths carry loop state within one shot."""
    parent = {n: n for n in order}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    pos = {n: i for i, n in enumerate(order)}
    fwd: Dict[str, List[str]] = {n: [] for n in order}
    rev: Dict[str, List[str]] = {n: [] for n in order}
    for e in g.edges:
        if not e.back and e.src in pos and e.dst in pos:
            fwd[e.src].append(e.dst)
            rev[e.dst].append(e.src)

    def _reach(start: str, adj: Dict[str, List[str]]) -> set:
        seen = {start}
        stack = [start]
        while stack:
            for nxt in adj[stack.pop()]:
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return seen

    for e in g.back_edges():
        if e.src not in pos or e.dst not in pos:
            continue
        # the loop body: forward-reachable from the consumer AND reaching
        # the producer
        body = _reach(e.dst, fwd) & _reach(e.src, rev)
        body.update((e.src, e.dst))
        anchor = e.dst
        for n in body:
            union(anchor, n)
    groups: Dict[str, List[str]] = {}
    for n in order:
        groups.setdefault(find(n), []).append(n)
    return sorted(groups.values(), key=lambda grp: min(pos[n] for n in grp))


def _rates(g: D.DFG) -> Dict[Sig, Fraction]:
    """Token rate of every signal relative to the input streams.

    Nodes inside a data-dependent loop body (Branch/Merge recirculation)
    follow loop semantics instead of the cond semantics: the loop-exit
    BRANCH releases exactly one token per admitted element (full rate) and
    the entry MERGE passes the admitted element's rate through — so a plan
    may legally cut right after a loop, while the loop body itself stays
    atomic via the back-edge clustering."""
    loop_body = g.recirculation_nodes()
    rate: Dict[Sig, Fraction] = {}
    for n in g.topo_order():
        node = g.nodes[n]
        if node.kind == D.INPUT:
            rate[(n, "out")] = Fraction(1)
            continue
        ins = [rate.get((e.src, e.src_port), Fraction(1))
               for e in g.in_edges(n) if not e.back]
        base = min(ins) if ins else Fraction(1)
        if node.is_reduction():
            k = node.emit_every
            base = base / k if k > 1 else (Fraction(0) if k == 0 else base)
            # emit_every == length traces to Fraction(1/length) via k > 1
        if node.kind == D.BRANCH and n not in loop_body:
            # branch legs carry data-dependent sub-rate token streams (only
            # the taken side fires); a non-unit marker makes them — and
            # everything downstream until the complementary MERGE — illegal
            # cut points
            for p in ("t", "f"):
                rate[(n, p)] = base / 2
        elif node.kind == D.BRANCH:
            # loop branch: per element, the taken leg fires a data-dependent
            # number of times but the exit leg fires exactly once
            for p in ("t", "f"):
                rate[(n, p)] = base
        elif node.kind == D.MERGE and n not in loop_body:
            # the frontend only emits MERGEs joining complementary branch
            # legs, which restores the pre-branch rate
            rate[(n, "out")] = base * 2
        else:
            rate[(n, "out")] = base
    return rate


def _shot_io(g: D.DFG, members: Sequence[str]
             ) -> Tuple[List[Sig], List[Sig], List[str]]:
    """External input signals, cut output signals, and original OUTPUT
    nodes fed by ``members``."""
    mset = set(members)
    in_sigs: List[Sig] = []
    for n in members:
        for e in g.in_edges(n):
            if e.back:
                if e.src not in mset:
                    raise FrontendError(
                        f"{g.name}: loop-carried edge {e.src}->{e.dst} "
                        f"crosses a shot boundary; state cannot round-trip "
                        f"through memory")
                continue
            if e.src in mset:
                continue
            sig = (e.src, e.src_port)
            if sig not in in_sigs:
                in_sigs.append(sig)
    out_sigs: List[Sig] = []
    finals: List[str] = []
    for n in members:
        for e in g.out_edges(n):
            if e.back:
                continue
            if g.nodes[e.dst].kind == D.OUTPUT:
                finals.append(e.dst)
            elif e.dst not in mset:
                sig = (e.src, e.src_port)
                if sig not in out_sigs:
                    out_sigs.append(sig)
    return in_sigs, out_sigs, finals


def _cut_name(sig: Sig) -> str:
    node, port = sig
    return f"cut_{node}" if port == "out" else f"cut_{node}_{port}"


def _build_shot_dfg(g: D.DFG, members: Sequence[str], idx: int,
                    rate: Dict[Sig, Fraction]) -> Tuple[D.DFG, List[Tuple[str, Sig]],
                                                        List[Tuple[str, Sig]],
                                                        Dict[str, str]]:
    mset = set(members)
    in_sigs, out_sigs, finals = _shot_io(g, members)
    for sig in in_sigs + out_sigs:
        if g.nodes[sig[0]].kind != D.INPUT and rate.get(sig) != Fraction(1):
            raise FrontendError(
                f"{g.name}: cannot cut at signal {sig} (token rate "
                f"{rate.get(sig)}); only full-rate stream boundaries can "
                f"round-trip through memory between shots")
    b = D.DFG.build(f"{g.name}_s{idx}")
    name_of: Dict[Sig, str] = {}
    inputs: List[Tuple[str, Sig]] = []
    for sig in in_sigs:
        iname = sig[0] if g.nodes[sig[0]].kind == D.INPUT else _cut_name(sig)
        b.inp(iname)
        name_of[sig] = iname
        inputs.append((iname, sig))
    for n in members:
        b._add(dataclasses.replace(g.nodes[n]))
    for e in g.edges:
        if e.dst in mset:
            if e.src in mset:
                b.edges.append(D.Edge(e.src, e.src_port, e.dst, e.dst_port,
                                      e.back, e.init))
            else:
                src = name_of[(e.src, e.src_port)]
                b.edges.append(D.Edge(src, "out", e.dst, e.dst_port))
    outputs: List[Tuple[str, Sig]] = []
    finals_map: Dict[str, str] = {}
    for sig in out_sigs:
        oname = _cut_name(sig)
        b.outputs.append(oname)
        b._add(D.Node(oname, D.OUTPUT))
        b.edges.append(D.Edge(sig[0], sig[1], oname, "a"))
        outputs.append((oname, sig))
    for fout in finals:
        e = g.operand(fout, "a")
        b.outputs.append(fout)
        b._add(dataclasses.replace(g.nodes[fout]))
        b.edges.append(D.Edge(e.src, e.src_port, fout, "a"))
        outputs.append((fout, ("final", fout)))
        finals_map[fout] = fout
    shot_g = b.done()
    return shot_g, inputs, outputs, finals_map


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

def plan(g: D.DFG, fabric: Optional[Fabric] = None, restarts: int = 200,
         pe_limit: Optional[int] = None, mapper: Optional[str] = None,
         seed: Optional[int] = None) -> Plan:
    """Decompose ``g`` into mappable shots (a single shot when it fits).

    The shot-shedding *search* always maps greedily — feasibility probing
    must stay cheap — and when ``mapper`` resolves to ``"anneal"``
    (``STRELA_MAPPER``), only the finally-accepted shot mappings are
    annealed, each with its greedy mapping as the never-worse baseline."""
    from repro_torch.core.mapper import default_mapper, default_seed
    fabric = fabric or Fabric()
    pe_limit = pe_limit if pe_limit is not None else fabric.rows * fabric.cols
    mapper = default_mapper() if mapper is None else mapper
    seed = default_seed() if seed is None else seed

    def _finalize(shot_g: D.DFG, m):
        if mapper == "anneal":
            from repro_torch.core.opt_mapper import anneal_map
            return anneal_map(shot_g, fabric, seed=seed, baseline=m)
        return m

    # fast path: the whole graph in one shot
    if (len(g.inputs) <= fabric.n_imns and len(g.outputs) <= fabric.n_omns
            and g.n_pes_used() <= pe_limit):
        try:
            m = _finalize(g, map_dfg(g, fabric, seed=seed, restarts=restarts,
                                     optimize="greedy"))
            shot = Shot(key=g.name, dfg=g, mapping=m,
                        inputs=[(n, (n, "out")) for n in g.inputs],
                        outputs=[(o, ("final", o)) for o in g.outputs],
                        finals={o: o for o in g.outputs})
            return Plan(g.name, g, [shot])
        except MappingError:
            pass                        # fall through to partitioning

    rate = _rates(g)
    order = _functional(g)
    clusters = _clusters(g, order)
    shots: List[Shot] = []
    i = 0
    while i < len(clusters):
        # grow greedily while the cheap resource counts fit
        j = i + 1
        while j <= len(clusters):
            members = [n for cl in clusters[i:j] for n in cl]
            ins, outs, finals = _shot_io(g, members)
            if (len(members) > pe_limit or len(ins) > fabric.n_imns
                    or len(outs) + len(finals) > fabric.n_omns):
                break
            j += 1
        j = max(j - 1, i + 1)
        # close the shot; shed clusters until the cut is legal (no branch
        # legs / reduced-rate signals crossing) and it actually places & routes
        while True:
            members = [n for cl in clusters[i:j] for n in cl]
            try:
                shot_g, s_ins, s_outs, s_finals = _build_shot_dfg(
                    g, members, len(shots), rate)
                m = map_dfg(shot_g, fabric, seed=seed, restarts=restarts,
                            optimize="greedy")
                break
            except (FrontendError, MappingError) as e:
                if j - 1 <= i:
                    raise FrontendError(
                        f"{g.name}: shot {len(shots)} has no feasible "
                        f"decomposition at one cluster ({members}): {e}"
                    ) from e
                j -= 1
        shots.append(Shot(key=shot_g.name, dfg=shot_g, mapping=_finalize(
                              shot_g, m),
                          inputs=s_ins, outputs=s_outs, finals=s_finals))
        i = j

    # identity outputs (INPUT wired straight to OUTPUT) only make sense in
    # the single-shot fast path above
    for o in g.outputs:
        src = g.operand(o, "a").src
        if g.nodes[src].kind == D.INPUT:
            raise FrontendError(
                f"{g.name}: output {o} is a pass-through of input {src}; "
                f"not supported in a multi-shot plan")
    return Plan(g.name, g, shots)
