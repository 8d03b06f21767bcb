"""Cycle-level simulation of a mapped kernel on the elastic fabric.

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

This module is the *fast* implementation: the station graph is
compiled once per mapping into flat structure-of-arrays form — integer
station ids, precomputed successor lists and reverse maps (no ``place``
scans or OMN column searches) — and the per-cycle loops run on plain
Python ints instead of NumPy scalars. The original token-by-token
implementation is preserved verbatim in ``elastic_sim_ref.py`` and
selected by ``STRELA_SIM=reference``; the conformance suite asserts both
produce bit-identical cycles, arrivals, and outputs.

Two further products of the same core:
  * ``simulate_lanes`` — lane-parallel mode: N independent same-mapping
    requests advance through one compiled station graph in a single
    per-cycle sweep (each lane is a suspended cycle-step coroutine), the
    shape ``Engine.flush`` config-class batches present.
  * ``TimingTrace`` — for static-rate DFGs (no Branch/Merge steering) the
    cycle schedule is independent of input *values*; a trace recorded once
    per (mapping, length, layout, bus) replays into a ``SimResult``
    without re-simulating (see ``core/multishot.py`` / ``engine``).

Termination: kernels with static token counts finish when every OMN received
its expected stream. Data-dependent loops (Branch/Merge recirculation, back
edges with ``init=None``) have no static expectation — they finish by *token
exhaustion*: the IMN streams drain and the elastic network quiesces, the
condition on which the real hardware raises its end-of-kernel interrupt.
"""
from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core import dfg as D
from repro_torch.core.executor import ALU_FN_I as _ALU_FN, wrap_i as _wrap_i
from repro_torch.core.fabric import FU_INS, FU_OUT, Res
from repro_torch.core.isa import CmpOp
from repro_torch.core.mapper import FU_PORT_OF, Mapping, Signal
from repro_torch.core.streams import BusConfig, StreamSpec

EB_CAP = 2          # 2-slot elastic buffers
FIFO_CAP = 4        # IMN/OMN damping FIFOs
FUOUT_CAP = 2       # FU output register + delayed-valid slot

# station kinds (ints — the SoA arrays index on them)
_IMN, _EB, _FUOUT, _OMN = 0, 1, 2, 3
# branch-leg codes
_LEG = {"out": 0, "t": 1, "f": 2}


@dataclasses.dataclass
class SimResult:
    cycles: int
    outputs: Dict[str, np.ndarray]        # per OUTPUT node, arrival order
    arrival_cycles: Dict[str, List[int]]
    fu_firings: Dict[str, int]
    bank_beats: int
    replayed: bool = False                # True: served from a TimingTrace

    def outputs_per_cycle(self) -> float:
        n = sum(len(v) for v in self.outputs.values())
        return n / self.cycles if self.cycles else 0.0

    def steady_ii(self) -> float:
        """Median inter-arrival gap at the busiest OMN (steady-state II).

        Non-positive gaps are ignored: when lane-parallel batching
        concatenates per-request arrival streams, the cycle counter resets
        at each request boundary and the spurious negative gap there must
        not enter the steady-state statistic.
        """
        gaps: List[int] = []
        for arr in self.arrival_cycles.values():
            if len(arr) > 1:
                d = np.diff(arr)
                gaps.extend(int(x) for x in d[d > 0])
        return float(np.median(gaps)) if gaps else float("inf")


@dataclasses.dataclass
class TimingTrace:
    """Value-independent cycle schedule of one static-rate execution.

    Valid for exactly one (mapping/config-class, stream length, stream
    layout, bank count); the DFG must be static-rate (``DFG.is_static_rate``
    — no Branch/Merge token steering), which makes every quantity below a
    pure function of structure, never of input values.
    """

    length: int
    layout: Tuple[int, ...]
    n_banks: int
    cycles: int
    arrival_cycles: Dict[str, List[int]]
    fu_firings: Dict[str, int]
    bank_beats: int

    @classmethod
    def from_sim(cls, sim: SimResult, length: int, layout: Tuple[int, ...],
                 n_banks: int) -> "TimingTrace":
        return cls(length=length, layout=tuple(layout), n_banks=n_banks,
                   cycles=sim.cycles,
                   arrival_cycles={k: list(v)
                                   for k, v in sim.arrival_cycles.items()},
                   fu_firings=dict(sim.fu_firings),
                   bank_beats=sim.bank_beats)

    def replay(self, outputs: Dict[str, np.ndarray]) -> SimResult:
        """Rebuild a ``SimResult`` from this trace plus executor outputs.

        ``outputs`` supplies the values (the functional executor's streams,
        already in OMN arrival order for static-rate graphs); the trace
        supplies every timing quantity. O(length) NumPy, no simulation.
        """
        outs = {k: np.asarray(v, dtype=np.int32) for k, v in outputs.items()}
        return SimResult(self.cycles, outs,
                         {k: list(v) for k, v in self.arrival_cycles.items()},
                         dict(self.fu_firings), self.bank_beats,
                         replayed=True)


# ---------------------------------------------------------------------------
# station-graph compilation (once per mapping)
# ---------------------------------------------------------------------------

class StationGraph:
    """The mapped netlist compiled to flat arrays for the cycle loops.

    Construction uses reverse maps built once from the ``Mapping`` —
    ``pos -> functional node`` and ``OMN column -> OUTPUT node`` — instead
    of the per-resource linear scans of the original implementation.
    Station ids index parallel lists (kind / cap / successor ids / leg
    codes); FU semantics are precompiled per functional node.
    """

    def __init__(self, m: Mapping):
        self.m = m
        g = m.dfg
        self.g = g

        # reverse maps (no O(n^2) scans)
        pos2node = {pos: n for n, pos in m.place.items()}
        col2out = {col: oname for oname, col in m.omn_of.items()}

        kinds: List[int] = []
        caps: List[int] = []
        legs: List[int] = []
        succs: List[List[int]] = []
        owner: List[Optional[str]] = []

        def new_station(kind: int, cap: int, leg: str = "out",
                        node: Optional[str] = None) -> int:
            kinds.append(kind)
            caps.append(cap)
            legs.append(_LEG[leg])
            succs.append([])
            owner.append(node)
            return len(kinds) - 1

        self.imn_station = {name: new_station(_IMN, FIFO_CAP, node=name)
                            for name in g.inputs}
        self.omn_station = {name: new_station(_OMN, FIFO_CAP, node=name)
                            for name in g.outputs}
        self.fuout_station = {n: new_station(_FUOUT, FUOUT_CAP, node=n)
                              for n in m.place}
        fu_in_station: Dict[Tuple[str, str], int] = {}

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
                    sid = new_station(_EB, EB_CAP, leg=src_port,
                                      node=pos2node[(res.r, res.c)])
                    fu_in_station[(pos2node[(res.r, res.c)], res.port)] = sid
                else:
                    sid = new_station(_EB, EB_CAP, leg=src_port)
                res_station[(sig, res)] = sid
        self.fu_in_station = fu_in_station

        def station_of(sig: Signal, res: Res) -> int:
            """Station for a tree resource: nearest registered
            self-or-ancestor."""
            route = m.routes[sig]
            cur: Optional[Res] = res
            while cur is not None:
                if cur.port == "IMN":
                    return self.imn_station[sig[0]]
                if cur.port == "OMN":
                    return self.omn_station[col2out[cur.c]]
                if (sig, cur) in res_station:
                    return res_station[(sig, cur)]
                if cur.port == FU_OUT and route.parent[cur] is None:
                    return self.fuout_station[sig[0]]
                cur = route.parent[cur]
            raise AssertionError("unrooted resource")

        # wire successor lists
        for sig, route in m.routes.items():
            for res, par in route.parent.items():
                if par is None or not registered(res):
                    continue
                child = (self.omn_station[col2out[res.c]]
                         if res.port == "OMN" else res_station.get((sig, res)))
                parent_sid = station_of(sig, par)
                if child is not None and child not in succs[parent_sid]:
                    if kinds[parent_sid] == _FUOUT:
                        # the Branch leg filter applies at the FU output
                        # register: a child fed *directly* by it (e.g. an
                        # OMN in the producer's own column) must carry the
                        # signal's leg, not the station-creation default
                        legs[child] = _LEG[sig[1]]
                    succs[parent_sid].append(child)

        self.kinds = kinds
        self.caps = caps
        self.legs = legs
        self.succs = succs
        self.owner = owner
        # phase-B scannable stations: those that can act in a settle pass —
        # anything with successors, plus succ-less FUOUTs (token drop). The
        # settle fixpoint is confluent (each station has one producer), so
        # relaxing only the currently-occupied subset of these, worklist-
        # driven, reaches exactly the reference fixpoint.
        self.scannable = [k in (_IMN, _EB, _FUOUT) and (bool(s) or k == _FUOUT)
                          for k, s in zip(kinds, succs)]
        # reverse edges: which scannable stations feed each station (used to
        # re-enable a backpressured producer when its consumer drains)
        self.feeders: List[List[int]] = [[] for _ in kinds]
        for sid, ss in enumerate(succs):
            if self.scannable[sid]:
                for child in ss:
                    self.feeders[child].append(sid)

        # FU semantics, precompiled per functional node: (name, kind code,
        # op fn, const, is_reduction, emit_every, acc_init, a/b/c/out sids)
        self.fu_list: List[Tuple] = []
        for n in m.place:
            nd = g.nodes[n]
            a = fu_in_station.get((n, "FU_A"), -1)
            b = fu_in_station.get((n, "FU_B"), -1)
            c = fu_in_station.get((n, "FU_C"), -1)
            fn = _ALU_FN.get(nd.op) if nd.kind == D.ALU else None
            self.fu_list.append(
                (n, nd.kind, fn, nd.value, nd.is_reduction(), nd.emit_every,
                 nd.acc_init, nd.op, a, b, c, self.fuout_station[n]))

        # initial tokens for loop-carried signals (register init values,
        # Sec. III-C), seeded at the *consumer's* FU input; recirculation
        # edges (init=None) start empty.
        self.init_tokens: List[Tuple[int, int]] = []
        for e in g.back_edges():
            if e.init is None:
                continue
            sid = fu_in_station[(e.dst, FU_PORT_OF[e.dst_port])]
            self.init_tokens.append((sid, _wrap_i(int(e.init))))

        self.data_dependent = g.has_recirculation()


def _expected_counts(g: D.DFG, length: int, data_dependent: bool
                     ) -> Dict[str, int]:
    expected: Dict[str, int] = {}
    for name in g.outputs:
        producer = g.operand(name, "a").src
        nd = g.nodes[producer]
        if data_dependent or g.nodes[name].emit_every == 0:
            expected[name] = -1
        elif nd.is_reduction() and nd.emit_every:
            expected[name] = length // nd.emit_every
        else:
            expected[name] = length
    return expected


# ---------------------------------------------------------------------------
# the cycle engine — one coroutine per request, yielding once per cycle
# ---------------------------------------------------------------------------

def _default_streams(g: D.DFG, length: int, n_banks: int):
    sin = {name: StreamSpec(base=i % n_banks, size=length, stride=n_banks)
           for i, name in enumerate(g.inputs)}
    sout = {name: StreamSpec(base=(len(g.inputs) + i) % n_banks,
                             size=length, stride=n_banks)
            for i, name in enumerate(g.outputs)}
    return sin, sout


def _run_lane(sg: StationGraph, inputs: Dict[str, np.ndarray],
              streams_in: Dict[str, StreamSpec],
              streams_out: Dict[str, StreamSpec],
              bus: BusConfig, max_cycles: int):
    """Generator advancing one request by one cycle per ``next()`` call;
    returns the ``SimResult`` via ``StopIteration.value``.

    The generator form is what makes lane parallelism free: every lane's
    full cycle state lives in this frame's locals, and ``simulate_lanes``
    sweeps ``next()`` across lanes to advance N requests in lockstep
    through one shared ``StationGraph``.
    """
    g = sg.g
    n_banks = bus.n_banks
    length, = {np.asarray(v).shape[0] for v in inputs.values()}

    caps, legs, kinds = sg.caps, sg.legs, sg.kinds
    qs: List[deque] = [deque() for _ in kinds]
    for sid, val in sg.init_tokens:
        qs[sid].append(val)

    # per-lane fanout tables: (child queue, cap, leg code, child sid if the
    # child can itself act in a settle pass, else -1) — queue objects are
    # resolved once so the settle loop does no indexing, and the sid lets a
    # push activate the child for fall-through cascading
    is_fuout = [k == _FUOUT for k in kinds]
    scannable = sg.scannable
    fan: List[List[Tuple[deque, int, int, int]]] = [
        [(qs[s], caps[s], legs[s], s if scannable[s] else -1) for s in ss]
        for ss in sg.succs]
    feeders = sg.feeders
    # occupied scannable stations (seeds each cycle's settle worklist)
    active: set = set()

    # per-run FU state; runtime tuples bind the queue objects directly
    fu_list = sg.fu_list
    accs = {n: _wrap_i(int(acc_init)) for
            (n, _, _, _, red, _, acc_init, *_r) in fu_list if red}
    acc_count = {n: 0 for n in accs}
    fu_firings = {fu[0]: 0 for fu in fu_list}
    for fu in fu_list:
        if fu[1] == D.CMP and fu[7] not in (CmpOp.EQZ, CmpOp.GTZ):
            raise ValueError(f"bad CMP op {fu[7]}")
    is_eqz = {fu[0]: fu[7] == CmpOp.EQZ for fu in fu_list
              if fu[1] == D.CMP}
    fu_rt = [(n, kind, fn, const, red, emit_every, acc_init,
              qs[a] if a >= 0 else None, qs[b] if b >= 0 else None,
              qs[c] if c >= 0 else None, qs[o], caps[o], o)
             for (n, kind, fn, const, red, emit_every, acc_init, _op,
                  a, b, c, o) in fu_list]

    # IMN/OMN progress + precomputed input bank sequences and data
    in_names = list(g.inputs)
    out_names = list(g.outputs)
    n_in = len(in_names)
    imn_sids = [sg.imn_station[n] for n in in_names]
    omn_sids = [sg.omn_station[n] for n in out_names]
    in_banks = [[streams_in[n].bank(k, n_banks) for k in range(length)]
                for n in in_names]
    data_in = [[int(x) for x in np.asarray(inputs[n])] for n in in_names]
    out_spec = [streams_out[n] for n in out_names]
    imn_sent = [0] * n_in
    omn_vals: List[List[int]] = [[] for _ in out_names]
    omn_cycs: List[List[int]] = [[] for _ in out_names]
    expected = _expected_counts(g, length, sg.data_dependent)
    bank_beats = 0
    n_io = n_in + len(out_names)
    pending_in = n_in * length

    # per-bank round-robin arbiter state (mirrors streams.BankArbiter)
    last_grant: Dict[int, int] = {}

    ALU, CMP, MUX, BRANCH, MERGE = D.ALU, D.CMP, D.MUX, D.BRANCH, D.MERGE

    cycle = 0
    while cycle < max_cycles:
        cycle += 1
        progress = False

        # --- phase A: bank arbitration (IMN fetches + OMN stores) ---
        reqs: List[int] = []
        any_req = False
        if pending_in:
            for i in range(n_in):
                sid = imn_sids[i]
                if imn_sent[i] < length and len(qs[sid]) < caps[sid]:
                    reqs.append(in_banks[i][imn_sent[i]])
                    any_req = True
                else:
                    reqs.append(-1)
        else:
            reqs.extend([-1] * n_in)
        for j, sid in enumerate(omn_sids):
            if qs[sid]:
                reqs.append(out_spec[j].bank(len(omn_vals[j]), n_banks))
                any_req = True
            else:
                reqs.append(-1)
        if any_req:
            by_bank: Dict[int, List[int]] = {}
            for i, bk in enumerate(reqs):
                if bk >= 0:
                    by_bank.setdefault(bk, []).append(i)
            for bk, nodes in by_bank.items():
                start = last_grant.get(bk, -1)
                pick = (nodes[0] if len(nodes) == 1 else
                        min(nodes, key=lambda i: ((i - start - 1) % n_io)))
                last_grant[bk] = pick
                bank_beats += 1
                progress = True
                if pick < n_in:
                    sid = imn_sids[pick]
                    qs[sid].append(data_in[pick][imn_sent[pick]])
                    imn_sent[pick] += 1
                    pending_in -= 1
                    if scannable[sid]:
                        active.add(sid)
                else:
                    j = pick - n_in
                    omn_vals[j].append(qs[omn_sids[j]].popleft())
                    omn_cycs[j].append(cycle)

        # --- phase B: combinational settle (fall-through EB chains) ---
        # worklist relaxation: the fixpoint is confluent (each station has
        # one producer), so event-driven scheduling lands on exactly the
        # reference scan's final state. A move re-enqueues the mover (more
        # tokens may fall through), its now-occupied children, and its
        # feeders (their backpressure just eased).
        if active:
            work = sorted(active)
            wset = set(work)
            qi = 0
            while qi < len(work):
                sid = work[qi]
                qi += 1
                wset.discard(sid)
                q = qs[sid]
                if not q:
                    active.discard(sid)
                    continue
                ff = fan[sid]
                if is_fuout[sid]:
                    if not ff:
                        # empty Fork-Sender mask: the FU result is
                        # deliberately discarded (find2min drops its loser
                        # this way, Sec. VI-B) — never backpressure
                        q.clear()
                        active.discard(sid)
                        progress = True
                        continue
                    value, leg = q[0]
                    ok = True
                    for cq, cap, cleg, _cs in ff:
                        if cleg == leg and len(cq) >= cap:
                            ok = False
                            break
                    if not ok:
                        continue
                    q.popleft()
                    for cq, cap, cleg, cs in ff:
                        if cleg == leg:
                            cq.append(value)
                            if cs >= 0:
                                active.add(cs)
                                if cs not in wset:
                                    work.append(cs)
                                    wset.add(cs)
                else:
                    ok = True
                    for cq, cap, _cl, _cs in ff:
                        if len(cq) >= cap:
                            ok = False
                            break
                    if not ok:
                        continue
                    value = q.popleft()
                    for cq, cap, _cl, cs in ff:
                        cq.append(value)
                        if cs >= 0:
                            active.add(cs)
                            if cs not in wset:
                                work.append(cs)
                                wset.add(cs)
                progress = True
                if q:
                    if sid not in wset:
                        work.append(sid)
                        wset.add(sid)
                else:
                    active.discard(sid)
                for p in feeders[sid]:
                    if p not in wset and qs[p]:
                        work.append(p)
                        wset.add(p)

        # --- phase C: FU firings on the settled state (registered) ---
        fires: List[Tuple] = []
        for fu in fu_rt:
            kind = fu[1]
            aq, bq, cq, oq = fu[7], fu[8], fu[9], fu[10]
            if kind == MERGE:
                if not (aq or bq):
                    continue      # priority-a confluence (Sec. III-C Merge)
            else:
                if aq is not None and not aq:
                    continue
                if bq is not None and not bq:
                    continue
                if cq is not None and not cq:
                    continue
            if fu[4]:
                # reduction: non-emitting firings don't need downstream space
                count = acc_count[fu[0]] + 1
                emit_every = fu[5]
                will_emit = (emit_every == 1 or
                             (emit_every == 0 and count == length) or
                             (emit_every > 1 and count % emit_every == 0))
                if will_emit and len(oq) >= fu[11]:
                    continue
            elif len(oq) >= fu[11]:
                continue
            fires.append(fu)

        for (n, kind, fn, const, red, emit_every, acc_init,
             aq, bq, cq, out_q, _ocap, out_sid) in fires:
            fu_firings[n] += 1
            progress = True
            active.add(out_sid)      # FUOUTs are always settle-scannable
            if kind == MERGE:
                src = aq if aq else bq
                out_q.append((src.popleft(), 0))
                continue
            a = aq.popleft() if aq is not None else None
            b = bq.popleft() if bq is not None else None
            c = cq.popleft() if cq is not None else None
            if kind == ALU:
                if red:
                    x = const if const is not None else a
                    acc = fn(accs[n], x)
                    count = acc_count[n] = acc_count[n] + 1
                    if emit_every == 1 or \
                            (emit_every == 0 and count == length) or \
                            (emit_every > 1 and count % emit_every == 0):
                        out_q.append((acc, 0))
                        if emit_every > 1:
                            acc = _wrap_i(int(acc_init))
                    accs[n] = acc
                else:
                    out_q.append((fn(a, b if b is not None else const), 0))
            elif kind == CMP:
                av = a
                if b is not None:
                    av = _wrap_i(a - b)
                elif const is not None:
                    av = _wrap_i(a - const)
                hit = (av == 0) if is_eqz[n] else (av > 0)
                out_q.append((1 if hit else 0, 0))
            elif kind == MUX:
                bb = b if b is not None else const
                out_q.append((a if c != 0 else bb, 0))
            elif kind == BRANCH:
                out_q.append((a, 1 if c != 0 else 2))

        if not progress:
            # quiescent: either done (only loop-carried leftovers remain in
            # their EBs, as in real hardware) or a true deadlock.
            cycle -= 1
            drained = all(s >= length for s in imn_sent)
            met = all(expected[name] < 0 or len(omn_vals[j]) >= expected[name]
                      for j, name in enumerate(out_names))
            if drained and met:
                break
            raise RuntimeError(
                f"deadlock in kernel {g.name} at cycle {cycle}: "
                f"imn_sent={dict(zip(in_names, imn_sent))}, received="
                f"{ {k: len(v) for k, v in zip(out_names, omn_vals)} }, "
                f"expected={expected}")
        yield cycle
    else:
        raise RuntimeError(f"simulation did not converge in {max_cycles} "
                           f"cycles (kernel {g.name}; likely routing "
                           f"deadlock)")

    outputs = {name: np.array(omn_vals[j], dtype=np.int32)
               for j, name in enumerate(out_names)}
    arrivals = {name: omn_cycs[j] for j, name in enumerate(out_names)}
    # last-value OMNs (stride 0): every token overwrote one word
    for name in out_names:
        if g.nodes[name].emit_every == 0 and len(outputs[name]):
            outputs[name] = outputs[name][-1:]
    return SimResult(cycle, outputs, arrivals, fu_firings, bank_beats)


def _drive(gen) -> SimResult:
    try:
        while True:
            next(gen)
    except StopIteration as stop:
        return stop.value


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def simulate(m: Mapping, inputs: Dict[str, np.ndarray],
             streams_in: Optional[Dict[str, StreamSpec]] = None,
             streams_out: Optional[Dict[str, StreamSpec]] = None,
             bus: Optional[BusConfig] = None,
             max_cycles: int = 2_000_000) -> SimResult:
    """Cycle-accurate simulation of one request on the mapped netlist.

    ``STRELA_SIM=reference`` in the environment selects the original
    token-by-token implementation (``elastic_sim_ref``) for differential
    checking; the default fast core is bit-identical to it.
    """
    if os.environ.get("STRELA_SIM", "") == "reference":
        from repro_torch.core import elastic_sim_ref
        return elastic_sim_ref.simulate_reference(
            m, inputs, streams_in=streams_in, streams_out=streams_out,
            bus=bus, max_cycles=max_cycles)
    bus = bus or BusConfig()
    if streams_in is None or streams_out is None:
        length, = {np.asarray(v).shape[0] for v in inputs.values()}
        din, dout = _default_streams(m.dfg, length, bus.n_banks)
        streams_in = streams_in or din
        streams_out = streams_out or dout
    with obs.span("sim.cycle_sim", kernel=m.dfg.name) as sp:
        res = _drive(_run_lane(_station_graph(m), inputs, streams_in,
                               streams_out, bus, max_cycles))
        sp.set(cycles=res.cycles)
        return res


def _station_graph(m: Mapping) -> StationGraph:
    """Per-mapping memo: routes are immutable once mapped, so the compiled
    station structure (not the per-run queues) is computed once."""
    sg = m.__dict__.get("_station_graph")
    if sg is None:
        sg = StationGraph(m)
        m.__dict__["_station_graph"] = sg
    return sg


def simulate_lanes(m: Mapping, inputs_list: List[Dict[str, np.ndarray]],
                   streams_in: Optional[Dict[str, StreamSpec]] = None,
                   streams_out: Optional[Dict[str, StreamSpec]] = None,
                   bus: Optional[BusConfig] = None,
                   max_cycles: int = 2_000_000) -> List[SimResult]:
    """Lane-parallel simulation: N independent same-mapping requests.

    The station graph is compiled once and every request becomes a lane —
    a suspended cycle-step coroutine over the shared structure. One sweep
    of the outer loop advances all live lanes by one cycle; lanes retire
    individually as they quiesce. Results are bit-identical to N separate
    ``simulate`` calls (asserted by tests/test_timing_trace.py).
    """
    bus = bus or BusConfig()
    obs.inc("sim.lane_sweeps")
    sg = _station_graph(m)
    lanes = []
    for inputs in inputs_list:
        sin, sout = streams_in, streams_out
        if sin is None or sout is None:
            length, = {np.asarray(v).shape[0] for v in inputs.values()}
            din, dout = _default_streams(m.dfg, length, bus.n_banks)
            sin = sin or din
            sout = sout or dout
        lanes.append(_run_lane(sg, inputs, sin, sout, bus, max_cycles))
    results: List[Optional[SimResult]] = [None] * len(lanes)
    live = list(range(len(lanes)))
    while live:
        nxt = []
        for i in live:
            try:
                next(lanes[i])
                nxt.append(i)
            except StopIteration as stop:
                results[i] = stop.value
        live = nxt
    return results
