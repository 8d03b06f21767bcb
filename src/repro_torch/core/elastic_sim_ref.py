"""Reference cycle-level simulator (the ``STRELA_SIM=reference`` oracle).

This is the original token-by-token implementation of the elastic-fabric
cycle model, kept verbatim as the differential-checking oracle for the
vectorized simulator in ``elastic_sim.py``: the fast core must
reproduce this module's cycle counts, arrival schedules, and outputs
bit-exactly, and the conformance suite asserts that it does. Do not
optimize this module — its value is that it stays simple and unchanged.

Timing model (Sec. III-C microarchitecture):
  * every PE input port and FU input holds a 2-slot Elastic Buffer with
    **fall-through** forwarding: 0-cycle latency when empty (data/valid
    bypass), full backpressure via the registered ready path. This is the
    only timing consistent with the paper's published IIs — dither's 4-FU
    feedback loop has II=4, i.e. exactly one cycle per FU stage and zero
    per routing hop;
  * PE output ports are combinational (the valid/ready FF was removed);
  * the FU datapath (ALU/comparator/mux) is registered — 1 cycle — into an
    output register + Fork Sender;
  * IMNs/OMNs have damping FIFOs and arbitrate for interleaved banks
    (one beat per bank per cycle, per-bank round-robin).

Each cycle: (A) bank grants fill IMN FIFOs / drain OMN FIFOs; (B) tokens
fall through EB chains to a combinational fixpoint; (C) FUs fire on the
settled state, registering results (visible next cycle).

The simulator executes the *mapped* netlist token-by-token, so measured
initiation intervals include real routing hops and bank conflicts — this is
what reproduces Table I's outputs/cycle (fft 1.95, dither II=4) rather than
assuming them.

Termination: kernels with static token counts finish when every OMN received
its expected stream. Data-dependent loops (Branch/Merge recirculation, back
edges with ``init=None``) have no static expectation — they finish by *token
exhaustion*: the IMN streams drain and the elastic network quiesces, the
condition on which the real hardware raises its end-of-kernel interrupt.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core import dfg as D
from repro_torch.core.executor import alu_eval, cmp_eval
from repro_torch.core.fabric import FU_INS, FU_OUT, Res
from repro_torch.core.isa import AluOp
from repro_torch.core.mapper import FU_PORT_OF, Mapping, Signal
from repro_torch.core.streams import BankArbiter, BusConfig, StreamSpec

EB_CAP = 2          # 2-slot elastic buffers
FIFO_CAP = 4        # IMN/OMN damping FIFOs
FUOUT_CAP = 2       # FU output register + delayed-valid slot


class _Station:
    __slots__ = ("sid", "kind", "cap", "q", "succs", "leg", "node", "port")

    def __init__(self, sid, kind, cap, leg="out", node=None, port=None):
        self.sid = sid
        self.kind = kind          # IMN | EB | FUOUT | OMN
        self.cap = cap
        self.q: deque = deque()
        self.succs: List[int] = []
        self.leg = leg            # which branch leg this chain belongs to
        self.node = node          # owning DFG node (FUOUT) / stream (IMN/OMN)
        self.port = port


def simulate_reference(m: Mapping, inputs: Dict[str, np.ndarray],
                       streams_in: Optional[Dict[str, StreamSpec]] = None,
                       streams_out: Optional[Dict[str, StreamSpec]] = None,
                       bus: Optional[BusConfig] = None,
                       max_cycles: int = 2_000_000) -> "SimResult":
    from repro_torch.core.elastic_sim import SimResult
    g = m.dfg
    bus = bus or BusConfig()
    arb = BankArbiter(bus)
    arrays = {k: np.asarray(v, dtype=np.int64) for k, v in inputs.items()}
    (length,) = {v.shape[0] for v in arrays.values()}
    if streams_in is None:
        streams_in = {name: StreamSpec(base=i % bus.n_banks, size=length,
                                       stride=bus.n_banks)
                      for i, name in enumerate(g.inputs)}
    if streams_out is None:
        streams_out = {name: StreamSpec(base=(len(g.inputs) + i) % bus.n_banks,
                                        size=length, stride=bus.n_banks)
                       for i, name in enumerate(g.outputs)}

    # ------------------------------------------------------------------
    # build the station graph from the mapping's route trees
    # ------------------------------------------------------------------
    stations: List[_Station] = []

    def new_station(kind, cap, leg="out", node=None, port=None) -> int:
        st = _Station(len(stations), kind, cap, leg, node, port)
        stations.append(st)
        return st.sid

    imn_station: Dict[str, int] = {}
    omn_station: Dict[str, int] = {}
    fuout_station: Dict[str, int] = {}
    fu_in_station: Dict[Tuple[str, str], int] = {}   # (node, FU port) -> sid

    for name in g.inputs:
        imn_station[name] = new_station("IMN", FIFO_CAP, node=name)
    for name in g.outputs:
        omn_station[name] = new_station("OMN", FIFO_CAP, node=name)
    for n in m.place:
        fuout_station[n] = new_station("FUOUT", FUOUT_CAP, node=n)

    def registered(res: Res) -> bool:
        return res.port.startswith("IN_") or res.port in FU_INS or \
            res.port in ("IMN", "OMN")

    res_station: Dict[Tuple[Signal, Res], int] = {}
    for sig, route in m.routes.items():
        src_node, src_port = sig
        for res, par in route.parent.items():
            if par is None or not registered(res):
                continue
            if res.port == "OMN":
                continue    # OMN stations pre-made; wired below
            if res.port in FU_INS:
                # FU input EB: find owning node
                owner = None
                for nn, pos in m.place.items():
                    if pos == (res.r, res.c):
                        owner = nn
                        break
                sid = new_station("EB", EB_CAP, leg=src_port, node=owner,
                                  port=res.port)
                fu_in_station[(owner, res.port)] = sid
            else:
                sid = new_station("EB", EB_CAP, leg=src_port)
            res_station[(sig, res)] = sid

    def station_of(sig: Signal, res: Res) -> int:
        """Station for a tree resource: nearest registered self-or-ancestor."""
        route = m.routes[sig]
        cur: Optional[Res] = res
        while cur is not None:
            if cur.port == "IMN":
                return imn_station[sig[0]]
            if cur.port == "OMN":
                # find which OUTPUT node this OMN belongs to
                for oname, col in m.omn_of.items():
                    if col == cur.c:
                        return omn_station[oname]
            if (sig, cur) in res_station:
                return res_station[(sig, cur)]
            if cur.port == FU_OUT and route.parent[cur] is None:
                return fuout_station[sig[0]]
            cur = route.parent[cur]
        raise AssertionError("unrooted resource")

    # wire successor lists
    for sig, route in m.routes.items():
        for res, par in route.parent.items():
            if par is None:
                continue
            if registered(res):
                child = (omn_station[_omn_owner(m, res.c)]
                         if res.port == "OMN" else res_station.get((sig, res)))
                parent_sid = station_of(sig, par)
                if child is not None and child not in stations[parent_sid].succs:
                    if stations[parent_sid].kind == "FUOUT":
                        # the Branch leg filter applies at the FU output
                        # register: a child fed *directly* by it (e.g. an
                        # OMN in the producer's own column) must carry the
                        # signal's leg, not the station-creation default
                        stations[child].leg = sig[1]
                    stations[parent_sid].succs.append(child)

    # FU semantics tables
    fu_nodes = {n: g.nodes[n] for n in m.place}
    fu_inputs: Dict[str, Dict[str, Optional[int]]] = {}
    back_keys = {(e.dst, e.dst_port) for e in g.back_edges()}
    for n in fu_nodes:
        fu_inputs[n] = {p: fu_in_station.get((n, fp))
                        for p, fp in (("a", "FU_A"), ("b", "FU_B"),
                                      ("ctrl", "FU_C"))}

    # initial tokens for loop-carried signals (register init values, Sec.
    # III-C). The init lives at the *consumer's* FU input (data_reg_init +
    # valid_reg_init of that PE), so it must not fork to the producer's
    # other consumers — e.g. a scan carry that is also a kernel output.
    # Recirculation edges (init=None) start empty: the first token to
    # circulate is a real stream element admitted by the loop's gate.
    for e in g.back_edges():
        if e.init is None:
            continue
        sid = fu_in_station[(e.dst, FU_PORT_OF[e.dst_port])]
        stations[sid].q.append((np.int64(e.init), frozenset(("out",))))

    # reduction accumulators
    accs = {n: np.int64(nd.acc_init) for n, nd in fu_nodes.items()
            if nd.is_reduction()}
    acc_count = {n: 0 for n in accs}

    # IMN/OMN progress
    imn_sent = {name: 0 for name in g.inputs}
    omn_recv: Dict[str, List[Tuple[int, int]]] = {name: [] for name in g.outputs}
    # Token-exhaustion termination (data-dependent loops): a recirculating
    # graph's output token counts depend on runtime predicates (an exit leg
    # may fire once per element, a discarded leg never), so no static
    # expectation exists. Completion is instead declared when the input
    # streams are exhausted AND the elastic network quiesces — exactly when
    # real hardware raises its end-of-kernel interrupt (Sec. V-B).
    data_dependent = g.has_recirculation()
    expected: Dict[str, int] = {}
    for name in g.outputs:
        producer = g.operand(name, "a").src
        nd = g.nodes[producer]
        if data_dependent or g.nodes[name].emit_every == 0:
            # last-value OMN: token count equals producer emissions (+ any
            # init token that reaches it); completion is tracked by IMN drain.
            expected[name] = -1
        elif nd.is_reduction() and nd.emit_every:
            expected[name] = length // nd.emit_every
        else:
            expected[name] = length
    fu_firings = {n: 0 for n in fu_nodes}
    bank_beats = 0

    def succs_ready(st: _Station, legs: frozenset) -> bool:
        # Leg selection (the Branch valid demux) applies at the FU output
        # register; mid-route EB chains forward to all their children.
        for s in st.succs:
            child = stations[s]
            if st.kind == "FUOUT" and child.leg not in legs:
                continue
            if len(child.q) >= child.cap:
                return False
        return True

    def push_succs(st: _Station, value, legs: frozenset):
        for s in st.succs:
            child = stations[s]
            if st.kind == "FUOUT" and child.leg not in legs:
                continue
            child.q.append((value, frozenset(("out",))))

    # ------------------------------------------------------------------
    # main loop — two-phase: plan on cycle-start state, then commit
    # ------------------------------------------------------------------
    cycle = 0
    while cycle < max_cycles:
        cycle += 1
        progress = False

        # --- phase A: bank arbitration (IMN fetches + OMN stores) ---
        reqs: List[int] = []
        for name in g.inputs:
            st = stations[imn_station[name]]
            want = imn_sent[name] < length and len(st.q) < st.cap
            reqs.append(streams_in[name].bank(imn_sent[name], bus.n_banks)
                        if want else -1)
        for name in g.outputs:
            st = stations[omn_station[name]]
            want = len(st.q) > 0
            reqs.append(streams_out[name].bank(len(omn_recv[name]), bus.n_banks)
                        if want else -1)
        grants = arb.grant(reqs)
        for i, name in enumerate(g.inputs):
            if grants[i]:
                st = stations[imn_station[name]]
                st.q.append((arrays[name][imn_sent[name]], frozenset(("out",))))
                imn_sent[name] += 1
                bank_beats += 1
                progress = True
        for j, name in enumerate(g.outputs):
            if grants[len(g.inputs) + j]:
                st = stations[omn_station[name]]
                value, _ = st.q.popleft()
                omn_recv[name].append((int(value), cycle))
                bank_beats += 1
                progress = True

        # --- phase B: combinational settle (fall-through EB chains) ---
        settled = False
        while not settled:
            settled = True
            for st in stations:
                if st.kind in ("EB", "IMN", "FUOUT") and st.q:
                    if not st.succs:
                        if st.kind == "FUOUT":
                            # empty Fork-Sender mask: the FU result is
                            # deliberately discarded (find2min drops its
                            # loser this way, Sec. VI-B) — never backpressure
                            st.q.popleft()
                            settled = False
                            progress = True
                        continue
                    value, legs = st.q[0]
                    if succs_ready(st, legs):
                        st.q.popleft()
                        push_succs(st, value, legs)
                        settled = False
                        progress = True

        # --- phase C: FU firings on the settled state (registered) ---
        fires: List[str] = []
        for n, nd in fu_nodes.items():
            ins = fu_inputs[n]
            a_sid, b_sid, c_sid = ins["a"], ins["b"], ins["ctrl"]
            have = lambda sid: sid is not None and len(stations[sid].q) > 0
            out_st = stations[fuout_station[n]]
            if nd.kind == D.MERGE:
                if not (have(a_sid) or have(b_sid)):
                    continue      # priority-a confluence (Sec. III-C Merge)
            else:
                if a_sid is not None and not have(a_sid):
                    continue
                if b_sid is not None and not have(b_sid):
                    continue
                if c_sid is not None and not have(c_sid):
                    continue
            if nd.is_reduction():
                # non-emitting firings don't need downstream space
                will_emit = _emits(nd, acc_count[n] + 1, length)
                if will_emit and len(out_st.q) >= out_st.cap:
                    continue
            elif len(out_st.q) >= out_st.cap:
                continue
            fires.append(n)

        for n in fires:
            nd = fu_nodes[n]
            ins = fu_inputs[n]
            out_st = stations[fuout_station[n]]
            aq = stations[ins["a"]].q if ins["a"] is not None else None
            bq = stations[ins["b"]].q if ins["b"] is not None else None
            cq = stations[ins["ctrl"]].q if ins["ctrl"] is not None else None
            fu_firings[n] += 1
            progress = True
            if nd.kind == D.MERGE:
                src = aq if aq and len(aq) else bq
                value, _ = src.popleft()
                out_st.q.append((value, frozenset(("out",))))
                continue
            a = aq.popleft()[0] if aq is not None else None
            b = bq.popleft()[0] if bq is not None else None
            c = cq.popleft()[0] if cq is not None else None
            if nd.kind == D.ALU:
                if nd.is_reduction():
                    x = np.int64(nd.value) if nd.value is not None else a
                    accs[n] = np.int64(alu_eval(nd.op, accs[n], x))
                    acc_count[n] += 1
                    if _emits(nd, acc_count[n], length):
                        out_st.q.append((accs[n], frozenset(("out",))))
                        if nd.emit_every > 1:
                            accs[n] = np.int64(nd.acc_init)
                else:
                    bb = b if b is not None else np.int64(nd.value)
                    out_st.q.append((np.int64(alu_eval(nd.op, a, bb)),
                                     frozenset(("out",))))
            elif nd.kind == D.CMP:
                av = a
                if b is not None:
                    av = np.int64(alu_eval(AluOp.SUB, a, b))
                elif nd.value is not None:
                    av = np.int64(alu_eval(AluOp.SUB, a, np.int64(nd.value)))
                out_st.q.append((np.int64(cmp_eval(nd.op, av)),
                                 frozenset(("out",))))
            elif nd.kind == D.MUX:
                bb = b if b is not None else np.int64(nd.value)
                out_st.q.append((a if c != 0 else bb, frozenset(("out",))))
            elif nd.kind == D.BRANCH:
                leg = "t" if c != 0 else "f"
                out_st.q.append((a, frozenset((leg,))))

        if not progress:
            # quiescent: either done (only loop-carried leftovers remain in
            # their EBs, as in real hardware) or a true deadlock.
            cycle -= 1
            drained = all(imn_sent[i] >= length for i in g.inputs)
            met = all(expected[name] < 0 or len(omn_recv[name]) >= expected[name]
                      for name in g.outputs)
            if drained and met:
                break
            raise RuntimeError(
                f"deadlock in kernel {g.name} at cycle {cycle}: "
                f"imn_sent={imn_sent}, received="
                f"{ {k: len(v) for k, v in omn_recv.items()} }, "
                f"expected={expected}")
    else:
        raise RuntimeError(f"simulation did not converge in {max_cycles} cycles "
                           f"(kernel {g.name}; likely routing deadlock)")

    outputs = {name: np.array([v for v, _ in omn_recv[name]], dtype=np.int32)
               for name in g.outputs}
    arrivals = {name: [cyc for _, cyc in omn_recv[name]] for name in g.outputs}
    # last-value OMNs (stride 0): every token overwrote one word
    for name in g.outputs:
        if g.nodes[name].emit_every == 0 and len(outputs[name]):
            outputs[name] = outputs[name][-1:]
    return SimResult(cycle, outputs, arrivals, fu_firings, bank_beats)


def _emits(nd: D.Node, count: int, length: int) -> bool:
    if nd.emit_every == 1:
        return True
    if nd.emit_every == 0:
        return count == length
    return count % nd.emit_every == 0


def _omn_owner(m: Mapping, col: int) -> str:
    for oname, c in m.omn_of.items():
        if c == col:
            return oname
    raise KeyError(col)
