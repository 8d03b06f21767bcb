"""Data-Flow Graph IR for STRELA kernels.

A DFG is the unit the paper offloads to the fabric (Sec. IV, Fig. 5): a graph
of arithmetic nodes (ALU), comparators, and elastic control nodes (Branch /
Merge / if-else Mux), with INPUT nodes fed by Input Memory Nodes and OUTPUT
nodes drained by Output Memory Nodes. Reductions use a feedback accumulator
inside the ALU (``acc_init`` + ``emit_every``), matching the immediate
feedback loop + delayed-valid mechanism of the microarchitecture.

Token semantics (static dataflow):
  * INPUT produces one token per stream element.
  * elementwise nodes (ALU/CMP/MUX) fire once per joined input token set.
  * ALU with ``acc_init is not None`` accumulates; with ``emit_every=k`` it
    emits one token every k firings (dot products / reductions) — k=0 means
    "emit only the final value".
  * BRANCH forwards its data token to port ``t`` when ctrl!=0 else ``f``.
  * MERGE forwards whichever input holds a token (producers alternate under
    complementary predicates, the only pattern the fabric supports).
  * SCAN nodes capture loop-carried recurrences (dither error, find2min
    running minima): ``y_t, s_t = f(x_t, s_{t-1})`` expressed with the same
    ALU/CMP/MUX vocabulary in an inner sub-graph.

The IR deliberately stays at the granularity a PE can implement: each node
maps to exactly one PE (comparisons must sit in their own PE — Sec. IV-A).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.isa import AluOp, CmpOp

# Node kinds
INPUT = "input"
OUTPUT = "output"
CONST = "const"
ALU = "alu"
CMP = "cmp"
MUX = "mux"           # if/else datapath multiplexer (JOIN_CTRL + OutMux.MUX)
BRANCH = "branch"     # valid-signal demux (JOIN_CTRL + branch valids)
MERGE = "merge"       # confluence of two complementary paths

KINDS = (INPUT, OUTPUT, CONST, ALU, CMP, MUX, BRANCH, MERGE)


@dataclasses.dataclass
class Node:
    name: str
    kind: str
    op: Optional[AluOp | CmpOp] = None
    value: Optional[int] = None          # CONST: the constant
    acc_init: Optional[int] = None       # ALU: immediate-feedback accumulator
    emit_every: int = 1                  # ALU reduction: tokens per emission
                                         #   (0 = emit once at end of stream)
    # port names for readability; data ports are positional ("a","b","ctrl")

    def is_reduction(self) -> bool:
        return self.kind == ALU and self.acc_init is not None


@dataclasses.dataclass(frozen=True)
class Edge:
    src: str                 # node name
    src_port: str            # "out" | "t" | "f"  (branch has two outs)
    dst: str
    dst_port: str            # "a" | "b" | "ctrl"
    back: bool = False       # loop-carried (non-immediate feedback loop):
                             #   consumer sees the producer's *previous* token
    init: Optional[int] = 0  # initial token on a back edge (register init);
                             #   None = *recirculation* edge of a
                             #   data-dependent loop: no initial token, the
                             #   consumer waits for the first real one


@dataclasses.dataclass
class DFG:
    """A validated dataflow graph plus its I/O ordering."""

    name: str
    nodes: Dict[str, Node]
    edges: List[Edge]
    inputs: List[str]        # INPUT node names, in IMN order (north border)
    outputs: List[str]       # OUTPUT node names, in OMN order (south border)

    def __getstate__(self):
        # drop analysis memos (e.g. the executor's gated-loop plan) so
        # pickled artifacts stay lean and deterministic
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    # -- construction helpers ----------------------------------------------
    @classmethod
    def build(cls, name: str) -> "DFGBuilder":
        return DFGBuilder(name)

    # -- queries -------------------------------------------------------------
    def in_edges(self, node: str) -> List[Edge]:
        return [e for e in self.edges if e.dst == node]

    def out_edges(self, node: str) -> List[Edge]:
        return [e for e in self.edges if e.src == node]

    def operand(self, node: str, port: str) -> Optional[Edge]:
        for e in self.edges:
            if e.dst == node and e.dst_port == port:
                return e
        return None

    def n_ops(self) -> int:
        """Arithmetic-operation count per stream element (paper Sec. VII-B:
        'only arithmetic operations are considered'; for control-driven
        kernels 'all the enabled FUs are counted')."""
        arith = sum(1 for n in self.nodes.values() if n.kind == ALU)
        ctrl = sum(1 for n in self.nodes.values() if n.kind in (CMP, MUX, BRANCH, MERGE))
        return arith if arith and not ctrl else arith + ctrl

    def has_feedback(self) -> bool:
        """True if any loop-carried dependency (accumulator or back edge)."""
        return (any(n.is_reduction() for n in self.nodes.values())
                or any(e.back for e in self.edges))

    def back_edges(self) -> List[Edge]:
        return [e for e in self.edges if e.back]

    def is_static_rate(self) -> bool:
        """True when the token *schedule* is independent of input values:
        no Branch (value-steered leg selection) and no Merge (occupancy-
        steered confluence) anywhere. Elementwise chains, MUX conditionals,
        reductions, and loop-carried state cells all qualify — every node
        fires on a fixed count schedule — so one cycle-accurate simulation
        per (mapping, length, layout, bus) is valid for *all* input values
        (the ``TimingTrace`` cache). Recirculating graphs always
        contain a Merge, hence never qualify."""
        return not any(n.kind in (BRANCH, MERGE) for n in self.nodes.values())

    def has_recirculation(self) -> bool:
        """True if the graph contains a data-dependent loop: a back edge with
        no initial token (``init is None``), i.e. a token recirculates through
        Branch/Merge until its loop predicate releases it. Such graphs have
        data-dependent firing counts and need token-driven execution."""
        return any(e.back and e.init is None for e in self.edges)

    def recirculation_nodes(self) -> set:
        """Functional nodes inside any data-dependent loop body: everything
        on a forward path consumer ->* producer of a recirculation edge."""
        fwd: Dict[str, List[str]] = {n: [] for n in self.nodes}
        rev: Dict[str, List[str]] = {n: [] for n in self.nodes}
        for e in self.edges:
            if not e.back:
                fwd[e.src].append(e.dst)
                rev[e.dst].append(e.src)

        def _reach(start: str, adj: Dict[str, List[str]]) -> set:
            seen, stack = {start}, [start]
            while stack:
                for nxt in adj[stack.pop()]:
                    if nxt not in seen:
                        seen.add(nxt)
                        stack.append(nxt)
            return seen

        body: set = set()
        for e in self.edges:
            if e.back and e.init is None:
                members = _reach(e.dst, fwd) & _reach(e.src, rev)
                members.update((e.src, e.dst))
                body |= members
        return body

    def topo_order(self) -> List[str]:
        """Topological order ignoring back edges (loop-carried state) and
        ALU-internal feedback."""
        indeg = {n: 0 for n in self.nodes}
        for e in self.edges:
            if not e.back:
                indeg[e.dst] += 1
        ready = sorted([n for n, d in indeg.items() if d == 0])
        order: List[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for e in self.out_edges(n):
                if e.back:
                    continue
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    ready.append(e.dst)
            ready.sort()
        if len(order) != len(self.nodes):
            raise ValueError(f"DFG {self.name} has a combinational cycle "
                             f"(only ALU-internal feedback is allowed)")
        return order

    def validate(self) -> None:
        names = set(self.nodes)
        for e in self.edges:
            if e.src not in names or e.dst not in names:
                raise ValueError(f"edge {e} references unknown node")
        for n in self.nodes.values():
            if n.kind in KINDS:
                pass
            else:
                raise ValueError(f"unknown node kind {n.kind}")
            ins = {e.dst_port for e in self.in_edges(n.name)}
            if n.kind == ALU:
                if "a" not in ins:
                    raise ValueError(f"ALU {n.name} missing operand a")
                # operand b may be a const (node.value), an accumulator
                # (acc_init), or an edge (possibly a back edge)
            elif n.kind == CMP and "a" not in ins:
                raise ValueError(f"CMP {n.name} missing operand a")
            elif n.kind == MUX:
                if "a" not in ins or "ctrl" not in ins:
                    raise ValueError(f"MUX {n.name} needs a and ctrl (got {ins})")
                if "b" not in ins and n.value is None:
                    raise ValueError(f"MUX {n.name} needs operand b or a const")
            elif n.kind == BRANCH and ins != {"a", "ctrl"}:
                raise ValueError(f"BRANCH {n.name} needs a, ctrl (got {ins})")
            elif n.kind == MERGE and ins != {"a", "b"}:
                raise ValueError(f"MERGE {n.name} needs a, b (got {ins})")
            elif n.kind == OUTPUT and "a" not in ins:
                raise ValueError(f"OUTPUT {n.name} missing operand")
            elif n.kind in (INPUT, CONST) and ins:
                raise ValueError(f"{n.kind} {n.name} cannot have inputs")
        # comparisons must be isolated PEs: a CMP may not also drive control
        # logic in the same node — structurally guaranteed by one-node-one-PE.
        self.topo_order()  # raises on combinational cycles

    def n_pes_used(self) -> int:
        """PEs needed before routing (mapper may add route-through PEs)."""
        return sum(1 for n in self.nodes.values()
                   if n.kind in (ALU, CMP, MUX, BRANCH, MERGE))

    def canonical_signature(self, rounds: int = 4) -> Tuple[str, ...]:
        """Structural fingerprint invariant under node renaming.

        Weisfeiler-Lehman-style refinement: each node starts from its local
        descriptor (kind, op, folded constant, accumulator parameters) and
        repeatedly absorbs the sorted labels of its port-annotated neighbors.
        Two DFGs built independently (hand-written vs traced) compare equal
        iff they have the same node/edge structure — the frontend golden
        tests rely on this.
        """
        label: Dict[str, str] = {}
        for n in self.nodes.values():
            op = int(n.op) if n.op is not None else -1
            label[n.name] = (f"{n.kind}/{op}/{n.value}/{n.acc_init}/"
                             f"{n.emit_every}")
        for _ in range(rounds):
            nxt: Dict[str, str] = {}
            for name in self.nodes:
                # e.init discriminates: recirculation (None) vs register
                # init value — different machines, different fingerprints
                ins = sorted(f"i:{e.dst_port}<{e.src_port}:{int(e.back)}:"
                             f"{e.init if e.back else ''}:"
                             f"{label[e.src]}" for e in self.in_edges(name))
                outs = sorted(f"o:{e.src_port}>{e.dst_port}:{int(e.back)}:"
                              f"{e.init if e.back else ''}:"
                              f"{label[e.dst]}" for e in self.out_edges(name))
                nxt[name] = label[name] + "|" + ";".join(ins + outs)
            label = nxt
        import hashlib
        return tuple(sorted(hashlib.sha1(l.encode()).hexdigest()[:16]
                            for l in label.values()))


class DFGBuilder:
    """Tiny fluent builder so kernels_lib reads like the paper's figures."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: Dict[str, Node] = {}
        self.edges: List[Edge] = []
        self.inputs: List[str] = []
        self.outputs: List[str] = []

    def _add(self, node: Node) -> str:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node {node.name}")
        self.nodes[node.name] = node
        return node.name

    def inp(self, name: str) -> str:
        self.inputs.append(name)
        return self._add(Node(name, INPUT))

    def out(self, name: str, src: str, src_port: str = "out") -> str:
        self.outputs.append(name)
        self._add(Node(name, OUTPUT))
        self.edge(src, name, "a", src_port)
        return name

    def const(self, name: str, value: int) -> str:
        return self._add(Node(name, CONST, value=value))

    def alu(self, name: str, op: AluOp, a: Optional[str], b: Optional[str] = None,
            const_b: Optional[int] = None, acc_init: Optional[int] = None,
            emit_every: int = 1, a_port: str = "out", b_port: str = "out") -> str:
        self._add(Node(name, ALU, op=op, value=const_b,
                       acc_init=acc_init, emit_every=emit_every))
        if a is not None:
            self.edge(a, name, "a", a_port)
        if b is not None:
            self.edge(b, name, "b", b_port)
        return name

    def cmp(self, name: str, op: CmpOp, a: Optional[str], b: Optional[str] = None,
            const_b: Optional[int] = None, a_port: str = "out",
            b_port: str = "out") -> str:
        self._add(Node(name, CMP, op=op, value=const_b))
        if a is not None:
            self.edge(a, name, "a", a_port)
        if b is not None:
            self.edge(b, name, "b", b_port)
        return name

    def mux(self, name: str, a: Optional[str], b: Optional[str],
            ctrl: Optional[str], a_port: str = "out", b_port: str = "out",
            ctrl_port: str = "out") -> str:
        self._add(Node(name, MUX))
        if a is not None:
            self.edge(a, name, "a", a_port)
        if b is not None:
            self.edge(b, name, "b", b_port)
        if ctrl is not None:
            self.edge(ctrl, name, "ctrl", ctrl_port)
        return name

    def branch(self, name: str, a: Optional[str], ctrl: Optional[str],
               a_port: str = "out", ctrl_port: str = "out") -> str:
        self._add(Node(name, BRANCH))
        if a is not None:
            self.edge(a, name, "a", a_port)
        if ctrl is not None:
            self.edge(ctrl, name, "ctrl", ctrl_port)
        return name

    def merge(self, name: str, a: Optional[str], b: Optional[str],
              a_port: str = "out", b_port: str = "out") -> str:
        self._add(Node(name, MERGE))
        if a is not None:
            self.edge(a, name, "a", a_port)
        if b is not None:
            self.edge(b, name, "b", b_port)
        return name

    def edge(self, src: str, dst: str, dst_port: str, src_port: str = "out",
             back: bool = False, init: int = 0) -> None:
        self.edges.append(Edge(src, src_port, dst, dst_port, back, init))

    def back_edge(self, src: str, dst: str, dst_port: str,
                  init: Optional[int] = 0, src_port: str = "out") -> None:
        """Loop-carried edge: dst consumes src's previous-iteration token.
        ``init=None`` makes it a recirculation edge (no initial token)."""
        self.edges.append(Edge(src, src_port, dst, dst_port, True, init))

    def done(self) -> DFG:
        g = DFG(self.name, self.nodes, self.edges, self.inputs, self.outputs)
        g.validate()
        return g


def unroll(dfg: DFG, factor: int) -> DFG:
    """Replicate a DFG ``factor`` times (paper mapping strategy 2).

    Replicas are independent lanes; IMN/OMN streams are interleaved round-robin
    by the memory nodes, so replica i processes elements i, i+factor, ...
    """
    if factor <= 1:
        return dfg
    nodes: Dict[str, Node] = {}
    edges: List[Edge] = []
    inputs: List[str] = []
    outputs: List[str] = []
    for k in range(factor):
        sfx = f"@{k}"
        for n in dfg.nodes.values():
            nodes[n.name + sfx] = dataclasses.replace(n, name=n.name + sfx)
        for e in dfg.edges:
            edges.append(Edge(e.src + sfx, e.src_port, e.dst + sfx, e.dst_port,
                              e.back, e.init))
        inputs.extend(i + sfx for i in dfg.inputs)
        outputs.extend(o + sfx for o in dfg.outputs)
    g = DFG(f"{dfg.name}_x{factor}", nodes, edges, inputs, outputs)
    g.validate()
    return g


def unroll_chained(dfg: DFG, factor: int) -> DFG:
    """Unroll a loop-carried kernel with cross-lane state chaining.

    For stateful kernels (e.g. dither's error diffusion) replicas are *not*
    independent: lane k processes elements k, k+factor, ... and the carried
    state flows lane 0 -> 1 -> ... -> factor-1 -> (back to) 0. Every back
    edge of the original DFG becomes a forward edge between consecutive
    lanes, with only the last->first link remaining loop-carried. This is
    the software-pipelined unroll the paper applies to dither (x2).
    """
    if factor <= 1:
        return dfg
    if dfg.has_recirculation():
        # a recirculation edge is not per-element state: chaining it across
        # lanes would feed lane k's mid-iteration tokens into lane k+1's
        # entry merge. Gated loops unroll as independent lanes instead.
        raise ValueError(
            f"{dfg.name}: cross-lane state chaining is undefined for "
            f"data-dependent loops (recirculation back edges); use unroll()")
    backs = dfg.back_edges()
    nodes: Dict[str, Node] = {}
    edges: List[Edge] = []
    inputs: List[str] = []
    outputs: List[str] = []
    for k in range(factor):
        sfx = f"@{k}"
        for n in dfg.nodes.values():
            nodes[n.name + sfx] = dataclasses.replace(n, name=n.name + sfx)
        for e in dfg.edges:
            if e.back:
                continue
            edges.append(Edge(e.src + sfx, e.src_port, e.dst + sfx, e.dst_port))
        inputs.extend(i + sfx for i in dfg.inputs)
        outputs.extend(o + sfx for o in dfg.outputs)
    for e in backs:
        for k in range(factor):
            nk = (k + 1) % factor
            # producer in lane k feeds consumer in lane k+1; the wrap link
            # (last lane -> lane 0) is the only remaining loop carry.
            edges.append(Edge(e.src + f"@{k}", e.src_port,
                              e.dst + f"@{nk}", e.dst_port,
                              back=(nk == 0), init=e.init))
    g = DFG(f"{dfg.name}_c{factor}", nodes, edges, inputs, outputs)
    g.validate()
    return g
