"""Place & route of DFGs onto the elastic fabric (the paper's Sec. IV flow).

The paper maps kernels *manually*; this module provides the automatic
equivalent (the 'compiler guidelines' of Sec. VIII): a deterministic greedy
placer with randomized restarts plus a breadth-first signal router over the
fabric's port-resource graph. Manual placement hints are accepted so the
paper's published mappings (Fig. 7) can be reproduced exactly.

Conventions (Sec. IV-B): inputs enter through IMNs on the north border,
outputs leave through OMNs on the south border, and the E/W border columns
provide the south-to-north return paths for feedback signals.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import random
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core import dfg as D
from repro_torch.core.fabric import FU_INS, FU_OUT, Fabric, Res
from repro_torch.core.isa import (AluOp, CmpOp, CtrlSel, JoinMergeMode, OperandSel,
                                  OutMux, OutSel, PEConfig, config_cycles)

Signal = Tuple[str, str]          # (node name, out port)  e.g. ("c1","out")
FU_PORT_OF = {"a": "FU_A", "b": "FU_B", "ctrl": "FU_C"}

MAPPERS = ("greedy", "anneal")


def default_seed() -> int:
    """The mapper RNG seed: ``STRELA_MAP_SEED`` in the environment, else 0.

    Read at call time (not import) so tests and CI steps can re-seed
    without re-importing; every ``map_dfg``/annealer entry point resolves
    ``seed=None`` through this one function."""
    return int(os.environ.get("STRELA_MAP_SEED", "0"))


def default_mapper() -> str:
    """Mapper selection: ``STRELA_MAPPER`` in the environment, else greedy."""
    m = os.environ.get("STRELA_MAPPER", "greedy")
    if m not in MAPPERS:
        raise ValueError(f"STRELA_MAPPER must be one of {MAPPERS}, got {m!r}")
    return m


@dataclasses.dataclass
class Route:
    """Claimed resource tree for one signal: res -> parent res (None at src)."""

    source: Res
    parent: Dict[Res, Optional[Res]]

    def path_to(self, dst: Res) -> List[Res]:
        out: List[Res] = []
        cur: Optional[Res] = dst
        while cur is not None:
            out.append(cur)
            cur = self.parent[cur]
        return list(reversed(out))


@dataclasses.dataclass
class Mapping:
    dfg: D.DFG
    fabric: Fabric
    place: Dict[str, Tuple[int, int]]            # functional node -> (r, c)
    imn_of: Dict[str, int]                       # INPUT node -> IMN column
    omn_of: Dict[str, int]                       # OUTPUT node -> OMN column
    routes: Dict[Signal, Route]
    edge_dest: Dict[Tuple[str, str, str, str], Res]   # (src,sp,dst,dp) -> sink

    def __getstate__(self):
        # drop memo fields (_active_pes, _station_graph — the latter holds
        # compiled closures) so pickled artifacts stay lean and loadable
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    def active_pes(self) -> Set[Tuple[int, int]]:
        """PEs carrying an FU or any route-through traffic (need config).
        Memoized: routes are immutable once mapped, and per-request
        dispatch asks for the config cost on every run."""
        act = self.__dict__.get("_active_pes")
        if act is None:
            act = set(self.place.values())
            for route in self.routes.values():
                for res in route.parent:
                    if 0 <= res.r < self.fabric.rows and \
                            0 <= res.c < self.fabric.cols:
                        act.add((res.r, res.c))
            self.__dict__["_active_pes"] = act
        return act

    def n_active_pes(self) -> int:
        return len(self.active_pes())

    def config_cycles(self) -> int:
        return config_cycles(self.n_active_pes())

    def arithmetic_pes(self) -> int:
        return sum(1 for n in self.dfg.nodes.values() if n.kind == D.ALU)

    def control_pes(self) -> int:
        return sum(1 for n in self.dfg.nodes.values()
                   if n.kind in (D.CMP, D.MUX, D.BRANCH, D.MERGE))

    def n_mem_nodes(self) -> int:
        return len(self.imn_of) + len(self.omn_of)

    def digest(self) -> str:
        """Stable content hash of the mapping decision (placement, stream
        bindings, and every claimed route edge). Two mappings with equal
        digests configure the fabric identically — the determinism tests
        compare this across processes, and it is independent of memo
        fields and dict insertion order."""
        h = hashlib.sha1()
        for n in sorted(self.place):
            h.update(f"P|{n}|{self.place[n]}".encode())
        for n in sorted(self.imn_of):
            h.update(f"I|{n}|{self.imn_of[n]}".encode())
        for n in sorted(self.omn_of):
            h.update(f"O|{n}|{self.omn_of[n]}".encode())
        for sig in sorted(self.routes):
            route = self.routes[sig]
            edges = sorted((repr(res), repr(par))
                           for res, par in route.parent.items())
            h.update(f"R|{sig}|{edges}".encode())
        for key in sorted(self.edge_dest):
            h.update(f"D|{key}|{self.edge_dest[key]!r}".encode())
        return h.hexdigest()


class MappingError(RuntimeError):
    pass


def auto_unroll(g: D.DFG, fabric: Optional[Fabric] = None,
                max_factor: int = 4, chained: bool = False,
                restarts: int = 250, seed: int = 0
                ) -> Tuple["Mapping", int]:
    """Automate mapping strategy 2 (Sec. IV-B): replicate a small DFG as
    many times as still places & routes — the paper caps at 4 (one lane per
    IMN) and found relu fits x3 and dither x2 'due to congestion'; this
    search reproduces those numbers mechanically.

    ``chained``: use cross-lane state chaining (stateful kernels like
    dither); otherwise independent lanes. Returns (mapping, factor).
    """
    from repro_torch.core.dfg import unroll, unroll_chained
    fabric = fabric or Fabric()
    best: Optional[Tuple[Mapping, int]] = None
    for factor in range(1, max_factor + 1):
        # gated data-dependent loops are self-contained per element: they
        # replicate as independent lanes, never with cross-lane chaining
        gu = (unroll_chained(g, factor)
              if chained and g.back_edges() and not g.has_recirculation()
              else unroll(g, factor))
        if len(gu.inputs) > fabric.n_imns or len(gu.outputs) > fabric.n_omns:
            break
        try:
            m = map_dfg(gu, fabric, seed=seed, restarts=restarts)
            best = (m, factor)
        except MappingError:
            break
    if best is None:
        raise MappingError(f"{g.name}: not mappable even at factor 1")
    return best


# ---------------------------------------------------------------------------
# Router — PathFinder-style negotiated congestion (McMurchie & Ebeling),
# the standard algorithm for mesh fabrics. Signals first route greedily
# (sharing allowed at a cost), then congestion history drives rip-up/reroute
# until every port resource is owned by exactly one signal.
#
# The hot loop runs on the fabric's dense integer resource index
# (``Fabric.rindex``): ids replace frozen ``Res`` dataclasses, whose
# hashing dominated mapping wall time. The search order, cost
# arithmetic, and RNG consumption are exactly those of the original
# ``Res``-keyed router, so every mapping (and every downstream cycle
# count) is bit-identical.
# ---------------------------------------------------------------------------

import heapq

_INF = float("inf")


class _NegotiatedRouter:
    def __init__(self, fabric: Fabric, rng: random.Random):
        self.fabric = fabric
        self.rng = rng
        self.idx = fabric.rindex()
        n = len(self.idx.res_of)
        self.hist: List[float] = [0.0] * n
        # version-stamped per-resource search state: arrays live across
        # dijkstra calls, a bumped epoch invalidates them in O(1)
        self._dist: List[float] = [0.0] * n
        self._parent: List[int] = [0] * n
        self._seen: List[int] = [0] * n           # epoch when dist was set
        self._done: List[int] = [0] * n           # epoch when finalized
        self._epoch = 0
        self._usage: List[Optional[Set[Signal]]] = [None] * n

    def route_all(self, demands: List[Tuple[Signal, Res, List[Res]]],
                  max_iters: int = 48) -> Dict[Signal, Route]:
        """demands: (signal, source res, sink res list). Returns conflict-free
        routes or raises MappingError."""
        idx = self.idx
        id_of = idx.id_of
        dem = [(sig, id_of[src], [id_of[d] for d in sinks])
               for sig, src, sinks in demands]
        pres_fac = 0.6
        trees: Dict[Signal, Dict[int, int]] = {}
        n_over = 0
        for it in range(max_iters):
            usage = self._usage = [None] * len(idx.res_of)
            trees = {}
            for sig, src, sinks in dem:
                # sources (FU_OUT / IMN) are exclusive by placement; branch
                # t/f legs legitimately share their FU_OUT, so sources are
                # not congestion-counted.
                tree = {src: -1}                  # res id -> parent id (-1 = src)
                for dst in sinks:
                    if not self._dijkstra(sig, tree, dst, pres_fac):
                        raise MappingError(f"no path {sig} -> {idx.res_of[dst]} "
                                           f"(disconnected or terminal blocked)")
                trees[sig] = tree
            n_over = 0
            for rid, users in enumerate(usage):
                if users is not None and len(users) > 1:
                    self.hist[rid] += len(users) - 1
                    n_over += 1
            if not n_over:
                routes: Dict[Signal, Route] = {}
                for sig, src, _ in dem:
                    parent = {idx.res_of[rid]: (None if pid < 0
                                                else idx.res_of[pid])
                              for rid, pid in trees[sig].items()}
                    routes[sig] = Route(idx.res_of[src], parent)
                return routes
            pres_fac *= 1.7
        raise MappingError(f"congestion unresolved after {max_iters} iterations "
                           f"({n_over} oversubscribed ports)")

    def _claim(self, rid: int, sig) -> None:
        s = self._usage[rid]
        if s is None:
            self._usage[rid] = {sig}
        else:
            s.add(sig)

    def _dijkstra(self, sig, tree: Dict[int, int], dst: int,
                  pres_fac) -> bool:
        if dst in tree:
            self._claim(dst, sig)
            return True
        idx = self.idx
        fan = idx.fanout_ids
        hist = self.hist
        is_terminal = idx.is_terminal
        rnd = self.rng.random
        usage = self._usage
        self._epoch += 1
        epoch = self._epoch
        dist, parent = self._dist, self._parent
        seen, done = self._seen, self._done
        heap = []
        for rid in tree:
            dist[rid] = 0.0
            seen[rid] = epoch
            heap.append((0.0, rnd(), rid))
        heapq.heapify(heap)
        while heap:
            d, _, cur = heapq.heappop(heap)
            if done[cur] == epoch:
                continue
            done[cur] = epoch
            if cur == dst:
                chain: List[int] = []
                node = cur
                while node not in tree:
                    chain.append(node)
                    node = parent[node]
                for rid in reversed(chain):
                    tree[rid] = parent[rid]
                    self._claim(rid, sig)
                return True
            for nxt in fan[cur]:
                if is_terminal[nxt] and nxt != dst:
                    continue                      # FU inputs / OMNs: sinks only
                users = usage[nxt]
                if users:
                    nd = d + (1.0 + hist[nxt]) * \
                        (1.0 + (len(users) - (sig in users)) * pres_fac)
                else:
                    nd = d + 1.0 + hist[nxt]
                if seen[nxt] != epoch or nd < dist[nxt]:
                    dist[nxt] = nd
                    seen[nxt] = epoch
                    parent[nxt] = cur
                    heapq.heappush(heap, (nd, rnd(), nxt))
        return False


# ---------------------------------------------------------------------------
# Placer + top-level map()
# ---------------------------------------------------------------------------

def _functional_nodes(g: D.DFG) -> List[str]:
    return [n for n in g.topo_order()
            if g.nodes[n].kind in (D.ALU, D.CMP, D.MUX, D.BRANCH, D.MERGE)]


def _depths(g: D.DFG) -> Dict[str, int]:
    depth: Dict[str, int] = {}
    for n in g.topo_order():
        preds = [depth.get(e.src, 0) for e in g.in_edges(n) if not e.back]
        base = max(preds) if preds else 0
        kind = g.nodes[n].kind
        depth[n] = base + (1 if kind not in (D.INPUT, D.CONST) else 0)
    return depth


def map_dfg(g: D.DFG, fabric: Optional[Fabric] = None,
            hints: Optional[Dict[str, Tuple[int, int]]] = None,
            imn_hint: Optional[Dict[str, int]] = None,
            omn_hint: Optional[Dict[str, int]] = None,
            seed: Optional[int] = None, restarts: int = 400,
            optimize: Optional[str] = None) -> Mapping:
    """Place & route ``g``; raises MappingError if no mapping is found.

    ``hints`` pins functional nodes to PEs and ``imn_hint``/``omn_hint`` pin
    the stream-to-memory-node binding — used to reproduce the paper's manual
    mappings (Fig. 7) deterministically.

    ``seed`` (default: ``STRELA_MAP_SEED``, else 0) seeds the single RNG
    driving restart jitter and route tie-breaking — the same seed always
    yields a bit-identical ``Mapping``. ``optimize`` selects the mapper
    (default: ``STRELA_MAPPER``, else greedy): ``"anneal"`` refines the
    greedy mapping with the cost-driven simulated annealer
    (``core.opt_mapper``), guaranteed never cycle-worse. Pinned mappings
    (any hint given) always stay greedy — they *are* the answer.
    """
    fabric = fabric or Fabric()
    seed = default_seed() if seed is None else seed
    optimize = default_mapper() if optimize is None else optimize
    if optimize not in MAPPERS:
        raise ValueError(f"optimize must be one of {MAPPERS}, "
                         f"got {optimize!r}")
    if len(g.inputs) > fabric.n_imns:
        raise MappingError(f"{g.name}: {len(g.inputs)} inputs > {fabric.n_imns} IMNs")
    if len(g.outputs) > fabric.n_omns:
        raise MappingError(f"{g.name}: {len(g.outputs)} outputs > {fabric.n_omns} OMNs")
    rng = random.Random(seed)
    last_err: Optional[str] = None
    greedy: Optional[Mapping] = None
    for attempt in range(restarts):
        temp = attempt / max(restarts - 1, 1)      # 0 → deterministic greedy,
        try:                                       # 1 → near-random search
            greedy = _try_map(g, fabric, hints, imn_hint, omn_hint, rng,
                              temp=temp)
            break
        except MappingError as e:
            last_err = str(e)
    if greedy is None:
        raise MappingError(f"{g.name}: no feasible mapping after {restarts} "
                           f"restarts (last: {last_err})")
    if optimize == "anneal" and not (hints or imn_hint or omn_hint):
        from repro_torch.core.opt_mapper import anneal_map
        return anneal_map(g, fabric, seed=seed, baseline=greedy)
    return greedy


def _try_map(g, fabric, hints, imn_hint, omn_hint, rng, temp: float) -> Mapping:
    depth = _depths(g)
    funcs = _functional_nodes(g)
    jitter = temp > 0
    # IMN/OMN binding is a software choice (stream configuration), so the
    # mapper searches permutations of it on jittered attempts.
    imn_cols = list(range(len(g.inputs)))
    omn_cols = list(range(len(g.outputs)))
    if jitter and rng.random() < min(1.0, temp * 2):
        rng.shuffle(imn_cols)
        rng.shuffle(omn_cols)
    imn_of = {name: imn_cols[i] for i, name in enumerate(g.inputs)}
    omn_of = {name: omn_cols[i] for i, name in enumerate(g.outputs)}
    if imn_hint:
        imn_of = dict(imn_hint)
    if omn_hint:
        omn_of = dict(omn_hint)

    # ---- placement ----
    place: Dict[str, Tuple[int, int]] = {}
    free = {(r, c) for r in range(fabric.rows) for c in range(fabric.cols)}
    for n in funcs:
        if hints and n in hints:
            pos = hints[n]
            if pos not in free:
                raise MappingError(f"hint collision at {pos}")
            place[n] = pos
            free.discard(pos)
            continue
        pref_row = min(depth[n] - 1, fabric.rows - 1)
        # anchor columns: predecessors' columns / IMN columns; successors' OMNs
        anchors: List[int] = []
        for e in g.in_edges(n):
            if e.back:
                continue
            if e.src in place:
                anchors.append(place[e.src][1])
            elif g.nodes[e.src].kind == D.INPUT:
                anchors.append(imn_of[e.src])
        for e in g.out_edges(n):
            if g.nodes[e.dst].kind == D.OUTPUT:
                anchors.append(omn_of[e.dst])
        best, best_cost = None, None
        options = sorted(free)
        if jitter:
            rng.shuffle(options)
        for (r, c) in options:
            cost = abs(r - pref_row) * 2
            for e in g.in_edges(n):
                if e.src in place and not e.back:
                    pr, pc = place[e.src]
                    cost += abs(r - pr) + abs(c - pc)
                    cost += 0 if pr < r else 2      # prefer northward producers
            for a in anchors:
                cost += abs(c - a)
            if jitter:
                cost += rng.random() * (0.5 + temp * 12)   # annealed noise
            if best_cost is None or cost < best_cost:
                best, best_cost = (r, c), cost
        if best is None:
            raise MappingError("fabric full")
        place[n] = best
        free.discard(best)

    # ---- routing (negotiated congestion over all signals at once) ----
    routes, edge_dest = route_signals(g, fabric, place, imn_of, omn_of, rng,
                                      depth=depth)
    return Mapping(g, fabric, place, imn_of, omn_of, routes, edge_dest)


def route_signals(g: D.DFG, fabric: Fabric,
                  place: Dict[str, Tuple[int, int]],
                  imn_of: Dict[str, int], omn_of: Dict[str, int],
                  rng: random.Random,
                  depth: Optional[Dict[str, int]] = None
                  ) -> Tuple[Dict[Signal, Route],
                             Dict[Tuple[str, str, str, str], Res]]:
    """Route every signal of ``g`` for a *fixed* placement + stream binding.

    This is the routing half of ``_try_map``, shared with the annealing
    mapper (``core.opt_mapper``), whose moves mutate the placement and then
    re-route. Demand order and RNG consumption are identical to the greedy
    path, so the same (placement, rng state) always reproduces the same
    routes. Raises MappingError when congestion cannot be resolved."""
    if depth is None:
        depth = _depths(g)

    def source_res(sig: Signal) -> Res:
        node, port = sig
        kind = g.nodes[node].kind
        if kind == D.INPUT:
            return fabric.imn_res(imn_of[node])
        if kind == D.CONST:
            raise MappingError("CONST nodes must be folded into PE constants")
        r, c = place[node]
        return Res(r, c, FU_OUT)

    edge_dest: Dict[Tuple[str, str, str, str], Res] = {}
    sinks_of: Dict[Signal, List[Res]] = {}
    order: List[Signal] = []
    for e in sorted((e for e in g.edges if g.nodes[e.src].kind != D.CONST),
                    key=lambda e: (depth.get(e.src, 0), e.src, e.dst)):
        sig: Signal = (e.src, e.src_port)
        if g.nodes[e.dst].kind == D.OUTPUT:
            dst = fabric.omn_res(omn_of[e.dst])
        else:
            dr, dc = place[e.dst]
            dst = Res(dr, dc, FU_PORT_OF[e.dst_port])
        if sig not in sinks_of:
            sinks_of[sig] = []
            order.append(sig)
        sinks_of[sig].append(dst)
        edge_dest[(e.src, e.src_port, e.dst, e.dst_port)] = dst

    demands = [(sig, source_res(sig), sinks_of[sig]) for sig in order]
    routes = _NegotiatedRouter(fabric, rng).route_all(demands)
    return routes, edge_dest


# ---------------------------------------------------------------------------
# Configuration-word generation
# ---------------------------------------------------------------------------

_ALU_KIND = {D.ALU: OutMux.ALU, D.CMP: OutMux.CMP, D.MUX: OutMux.MUX,
             D.BRANCH: OutMux.ALU, D.MERGE: OutMux.MUX}


def generate_configs(m: Mapping) -> List[PEConfig]:
    """Emit one 158-bit configuration word per active PE (Sec. V-B/V-C)."""
    fabric = m.fabric
    by_pe: Dict[Tuple[int, int], PEConfig] = {}

    def cfg(r: int, c: int) -> PEConfig:
        key = (r, c)
        if key not in by_pe:
            by_pe[key] = PEConfig(pe_id=fabric.pe_index(r, c))
        return by_pe[key]

    node_at = {pos: n for n, pos in m.place.items()}

    # functional configuration
    for n, (r, c) in m.place.items():
        node = m.dfg.nodes[n]
        pc = cfg(r, c)
        if node.kind == D.ALU:
            pc.alu_op = node.op
            pc.out_mux = OutMux.ALU
            pc.jm_mode = JoinMergeMode.JOIN
            if node.is_reduction():
                pc.alu_fb_imm = 1
                pc.data_reg_init = node.acc_init & 0xFFFFFFFF
                pc.valid_delay = min(node.emit_every, 63)
        elif node.kind == D.CMP:
            pc.cmp_op = node.op
            pc.out_mux = OutMux.CMP
            pc.jm_mode = JoinMergeMode.JOIN
        elif node.kind == D.MUX:
            pc.out_mux = OutMux.MUX
            pc.jm_mode = JoinMergeMode.JOIN_CTRL
        elif node.kind == D.BRANCH:
            pc.out_mux = OutMux.ALU
            pc.alu_op = AluOp.NOP
            pc.jm_mode = JoinMergeMode.JOIN_CTRL
        elif node.kind == D.MERGE:
            pc.out_mux = OutMux.MUX
            pc.jm_mode = JoinMergeMode.MERGE
        if node.value is not None:
            pc.const_val = node.value & 0xFFFFFFFF
            if node.kind == D.ALU and not node.is_reduction():
                pc.in_b_sel = OperandSel.CONST
            elif node.kind == D.MUX and m.dfg.operand(n, "b") is None:
                pc.in_b_sel = OperandSel.CONST

    # routing configuration: walk every claimed tree edge
    for sig, route in m.routes.items():
        for res, par in route.parent.items():
            if par is None:
                continue
            r, c = res.r, res.c
            if res.port == "OMN" or res.port == "IMN":
                continue
            pc = cfg(r, c) if 0 <= r < fabric.rows else None
            if pc is None:
                continue
            if res.port.startswith("OUT_"):
                d = res.port[4:]
                attr = f"out_sel_{d.lower()}"
                if par.port == FU_OUT:
                    setattr(pc, attr, OutSel.FU)
                elif par.port.startswith("IN_"):
                    setattr(pc, attr, OutSel[f"IN_{par.port[3:]}"])
            elif res.port.startswith("IN_"):
                # fork mask of the upstream producer's input port is set when
                # we see its fanout legs; gating: mark this EB active
                side = {"N": 0, "E": 1, "S": 2, "W": 3}[res.port[3:]]
                pc.gate_mask |= (1 << side)
            elif res.port in FU_INS:
                sel_attr = {"FU_A": "in_a_sel", "FU_B": "in_b_sel",
                            "FU_C": "ctrl_sel"}[res.port]
                if par.port.startswith("IN_"):
                    side = par.port[3:]
                    sel = (OperandSel[f"PORT_{side}"] if res.port != "FU_C"
                           else CtrlSel[f"PORT_{side}"])
                    setattr(pc, sel_attr, sel)
                elif par.port == FU_OUT:     # non-immediate feedback loop
                    setattr(pc, sel_attr, OperandSel.FEEDBACK)
    return [by_pe[k] for k in sorted(by_pe)]
