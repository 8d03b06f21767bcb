"""Functional (un-timed) execution of STRELA DFGs — the semantic oracle.

Three paths:
  * **vectorized** — acyclic graphs (optionally with reductions that feed only
    OUTPUT nodes): NumPy evaluation over the whole stream at once.
  * **loop** — graphs with loop-carried back edges (dither, find2min) or
    reductions consumed by interior nodes: per-token interpretation, exactly
    mirroring the elastic token semantics. Every node fires exactly once per
    stream element.
  * **token** — graphs with *recirculation* (a back edge with ``init=None``,
    the data-dependent-loop schema the frontend emits for ``lax.while_loop``):
    a token-driven interpreter with per-edge FIFOs. Nodes fire whenever their
    joined inputs hold tokens, so an element can circulate through a
    Branch/Merge loop a data-dependent number of times before its exit token
    is released. Execution terminates by *token exhaustion*: the network is
    run to quiescence after the input streams drain.

All use a wrapping 32-bit integer datapath (the fabric's ALU width).
The cycle-accurate timing lives in ``elastic_sim``; this module defines *what*
a mapped kernel computes, and is the reference for the Pallas kernels and the
fidelity checks of the elastic simulator itself.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import dfg as D
from repro_torch.core.isa import AluOp, CmpOp

I32 = np.int32


def wrap32(x) -> np.ndarray:
    """Wrap to the fabric's 32-bit two's-complement datapath."""
    return np.asarray(x, dtype=np.int64).astype(np.uint64).astype(np.uint32).astype(I32)


def alu_eval(op: AluOp, a, b):
    a64 = np.asarray(a, dtype=np.int64)
    b64 = np.asarray(b, dtype=np.int64)
    if op == AluOp.ADD:
        r = a64 + b64
    elif op == AluOp.SUB:
        r = a64 - b64
    elif op == AluOp.MUL:
        r = a64 * b64
    elif op == AluOp.SHL:
        r = a64 << (b64 & 31)
    elif op == AluOp.SHR:
        r = a64 >> (b64 & 31)
    elif op == AluOp.AND:
        r = a64 & b64
    elif op == AluOp.OR:
        r = a64 | b64
    elif op == AluOp.XOR:
        r = a64 ^ b64
    elif op == AluOp.NOP:
        r = a64
    else:  # pragma: no cover
        raise ValueError(f"bad ALU op {op}")
    return wrap32(r)


def cmp_eval(op: CmpOp, a):
    a = np.asarray(a)
    if op == CmpOp.EQZ:
        return (a == 0).astype(I32)
    if op == CmpOp.GTZ:
        return (a > 0).astype(I32)
    raise ValueError(f"bad CMP op {op}")


# ---------------------------------------------------------------------------
# scalar fast path: 32-bit ALU semantics on plain Python ints
# ---------------------------------------------------------------------------
# The per-token interpreters below (and the fast elastic simulator) spend
# their time on single-token arithmetic, where a NumPy scalar op costs
# microseconds. These are the same operations on Python ints with an
# explicit two's-complement wrap — bit-identical to ``alu_eval``/``wrap32``
# for int32-range operands, which is all the datapath ever carries.

def wrap_i(v: int) -> int:
    """32-bit two's-complement wrap of a Python int (matches ``wrap32``)."""
    v &= 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


_M, _H, _W = 0xFFFFFFFF, 0x80000000, 0x100000000

ALU_FN_I = {
    AluOp.ADD: lambda a, b: v - _W if (v := (a + b) & _M) >= _H else v,
    AluOp.SUB: lambda a, b: v - _W if (v := (a - b) & _M) >= _H else v,
    AluOp.MUL: lambda a, b: v - _W if (v := (a * b) & _M) >= _H else v,
    AluOp.SHL: lambda a, b: v - _W if (v := (a << (b & 31)) & _M) >= _H else v,
    AluOp.SHR: lambda a, b: v - _W if (v := (a >> (b & 31)) & _M) >= _H else v,
    AluOp.AND: lambda a, b: v - _W if (v := (a & b) & _M) >= _H else v,
    AluOp.OR: lambda a, b: v - _W if (v := (a | b) & _M) >= _H else v,
    AluOp.XOR: lambda a, b: v - _W if (v := (a ^ b) & _M) >= _H else v,
    AluOp.NOP: lambda a, b: v - _W if (v := a & _M) >= _H else v,
}


def _needs_loop(g: D.DFG) -> bool:
    if g.back_edges():
        return True
    for n in g.nodes.values():
        if n.is_reduction():
            for e in g.out_edges(n.name):
                if g.nodes[e.dst].kind != D.OUTPUT:
                    return True
    return False


def execute(g: D.DFG, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Run a DFG over input streams; returns OMN output streams (compacted)."""
    if set(inputs) != set(g.inputs):
        raise ValueError(f"inputs {sorted(inputs)} != DFG inputs {sorted(g.inputs)}")
    arrays = {k: np.asarray(v, dtype=I32) for k, v in inputs.items()}
    lengths = {v.shape[0] for v in arrays.values()}
    if len(lengths) != 1:
        raise ValueError(f"all input streams must share a length, got {lengths}")
    (length,) = lengths
    if g.has_recirculation():
        return _execute_tokens(g, arrays, length)
    if _needs_loop(g):
        return _execute_loop(g, arrays, length)
    return _execute_vectorized(g, arrays, length)


# ---------------------------------------------------------------------------
# vectorized path
# ---------------------------------------------------------------------------

def _operand(g: D.DFG, vals, masks, node: D.Node, port: str):
    e = g.operand(node.name, port)
    if e is None:
        return None, None
    key = (e.src, e.src_port)
    return vals[key], masks[key]


def _execute_vectorized(g, arrays, length):
    vals: Dict[Tuple[str, str], np.ndarray] = {}
    masks: Dict[Tuple[str, str], np.ndarray] = {}
    outputs: Dict[str, np.ndarray] = {}
    full = np.ones(length, dtype=bool)
    for name in g.topo_order():
        n = g.nodes[name]
        if n.kind == D.INPUT:
            vals[(name, "out")], masks[(name, "out")] = arrays[name], full
        elif n.kind == D.CONST:
            vals[(name, "out")] = np.full(length, n.value, dtype=I32)
            masks[(name, "out")] = full
        elif n.kind == D.ALU:
            a, ma = _operand(g, vals, masks, n, "a")
            b, mb = _operand(g, vals, masks, n, "b")
            if n.is_reduction():
                vals[(name, "out")], masks[(name, "out")] = _reduce_vec(n, a, ma, length)
                continue
            if b is None:
                b, mb = np.full(length, n.value, dtype=I32), full
            m = ma & mb
            vals[(name, "out")] = alu_eval(n.op, a, b)
            masks[(name, "out")] = m
        elif n.kind == D.CMP:
            a, ma = _operand(g, vals, masks, n, "a")
            b, mb = _operand(g, vals, masks, n, "b")
            if b is not None:
                a, ma = alu_eval(AluOp.SUB, a, b), ma & mb
            elif n.value is not None:
                a = alu_eval(AluOp.SUB, a, np.full(length, n.value, dtype=I32))
            vals[(name, "out")] = cmp_eval(n.op, a)
            masks[(name, "out")] = ma
        elif n.kind == D.MUX:
            a, ma = _operand(g, vals, masks, n, "a")
            b, mb = _operand(g, vals, masks, n, "b")
            c, mc = _operand(g, vals, masks, n, "ctrl")
            if b is None:
                b, mb = np.full(length, n.value, dtype=I32), full
            vals[(name, "out")] = np.where(c != 0, a, b).astype(I32)
            masks[(name, "out")] = ma & mb & mc
        elif n.kind == D.BRANCH:
            a, ma = _operand(g, vals, masks, n, "a")
            c, mc = _operand(g, vals, masks, n, "ctrl")
            m = ma & mc
            vals[(name, "t")] = a
            masks[(name, "t")] = m & (c != 0)
            vals[(name, "f")] = a
            masks[(name, "f")] = m & (c == 0)
        elif n.kind == D.MERGE:
            a, ma = _operand(g, vals, masks, n, "a")
            b, mb = _operand(g, vals, masks, n, "b")
            if np.any(ma & mb):
                raise ValueError(f"MERGE {name}: non-complementary token masks")
            vals[(name, "out")] = np.where(ma, a, b).astype(I32)
            masks[(name, "out")] = ma | mb
        elif n.kind == D.OUTPUT:
            a, ma = _operand(g, vals, masks, n, "a")
            out = a[ma]
            if n.emit_every == 0 and out.size:   # OMN 'last value' mode
                out = out[-1:]
            outputs[name] = out.astype(I32)
    return outputs


def _reduce_vec(n: D.Node, a: np.ndarray, ma: np.ndarray, length: int):
    """Segmented accumulate: acc = op(acc, x); emit & reset every k tokens
    (k=0: emit once at end). Vectorized-path reductions feed only OUTPUTs,
    so we return the emission stream directly."""
    if not np.all(ma):
        raise ValueError("reductions under branch masks need the loop path")
    if n.value is not None:  # paced counter: acc' = op(acc, const)
        x = np.full(length, n.value, dtype=I32)
    else:
        x = a
    k = n.emit_every if n.emit_every else length
    if length % k != 0:
        raise ValueError(f"stream length {length} not divisible by segment {k}")
    seg = np.asarray(x, dtype=np.int64).reshape(length // k, k)
    init = np.int64(n.acc_init)
    if n.op == AluOp.ADD:
        res = init + seg.sum(axis=1)
    elif n.op == AluOp.SUB:
        res = init - seg.sum(axis=1)
    elif n.op == AluOp.MUL:
        res = init * np.prod(seg, axis=1)
    elif n.op in (AluOp.AND, AluOp.OR, AluOp.XOR):
        ufunc = {AluOp.AND: np.bitwise_and, AluOp.OR: np.bitwise_or,
                 AluOp.XOR: np.bitwise_xor}[n.op]
        res = ufunc(init, ufunc.reduce(seg, axis=1))
    else:
        raise ValueError(f"unsupported reduction op {n.op}")
    emit = wrap32(res)
    mask = np.ones(emit.shape[0], dtype=bool)
    return emit, mask


# ---------------------------------------------------------------------------
# loop path (token-by-token)
# ---------------------------------------------------------------------------

def _execute_loop(g, arrays, length):
    """Per-token interpretation of loop-carried graphs, compiled to a flat
    wire-slot program evaluated on plain Python ints (the NumPy-scalar
    version of this interpreter dominated repeat-dispatch wall time)."""
    order = g.topo_order()
    back = {(e.dst, e.dst_port): e for e in g.back_edges()}

    # wire slots: one (value, valid) pair per produced (node, port)
    slot_of: Dict[Tuple[str, str], int] = {}

    def slot(key: Tuple[str, str]) -> int:
        if key not in slot_of:
            slot_of[key] = len(slot_of)
        return slot_of[key]

    for name in order:
        n = g.nodes[name]
        if n.kind == D.BRANCH:
            slot((name, "t"))
            slot((name, "f"))
        elif n.kind != D.OUTPUT:
            slot((name, "out"))

    carries: List[int] = []
    carry_slot: Dict[Tuple[str, str], int] = {}   # (dst, port) -> carry idx
    latches: List[Tuple[int, int]] = []           # (src slot, carry idx)
    for key, e in back.items():
        idx = len(carries)
        carries.append(int(e.init))
        carry_slot[key] = idx
        latches.append((slot_of[(e.src, e.src_port)], idx))

    # operand descriptor: ('s', slot) | ('k', carry idx) | None
    def operand(name: str, port: str):
        if (name, port) in carry_slot:
            return ("k", carry_slot[(name, port)])
        e = g.operand(name, port)
        if e is None:
            return None
        return ("s", slot_of[(e.src, e.src_port)])

    accs = {n.name: int(n.acc_init) for n in g.nodes.values()
            if n.is_reduction()}
    out_streams: Dict[str, List[int]] = {o: [] for o in g.outputs}
    last_vals: Dict[str, Optional[int]] = {o: None for o in g.outputs}
    in_cols = {name: [int(x) for x in arrays[name]] for name in g.inputs}

    prog: List[Tuple] = []
    for name in order:
        n = g.nodes[name]
        if n.kind == D.INPUT:
            prog.append(("in", in_cols[name], slot_of[(name, "out")]))
        elif n.kind == D.CONST:
            prog.append(("const", int(n.value), slot_of[(name, "out")]))
        elif n.kind == D.ALU and n.is_reduction():
            prog.append(("red", name, ALU_FN_I[n.op], n.value, n.emit_every,
                         int(n.acc_init), operand(name, "a"),
                         slot_of[(name, "out")]))
        elif n.kind == D.ALU:
            prog.append(("alu", ALU_FN_I[n.op], n.value, operand(name, "a"),
                         operand(name, "b"), slot_of[(name, "out")]))
        elif n.kind == D.CMP:
            if n.op not in (CmpOp.EQZ, CmpOp.GTZ):
                raise ValueError(f"bad CMP op {n.op}")
            prog.append(("cmp", n.op == CmpOp.EQZ, n.value,
                         operand(name, "a"), operand(name, "b"),
                         slot_of[(name, "out")]))
        elif n.kind == D.MUX:
            prog.append(("mux", n.value, operand(name, "a"),
                         operand(name, "b"), operand(name, "ctrl"),
                         slot_of[(name, "out")]))
        elif n.kind == D.BRANCH:
            prog.append(("br", operand(name, "a"), operand(name, "ctrl"),
                         slot_of[(name, "t")], slot_of[(name, "f")]))
        elif n.kind == D.MERGE:
            prog.append(("mg", name, operand(name, "a"), operand(name, "b"),
                         slot_of[(name, "out")]))
        elif n.kind == D.OUTPUT:
            prog.append(("out", name, n.emit_every, operand(name, "a")))

    n_slots = len(slot_of)
    vals = [0] * n_slots
    valid = [False] * n_slots

    def read(opd):
        if opd is None:
            return None, None
        if opd[0] == "s":
            return vals[opd[1]], valid[opd[1]]
        return carries[opd[1]], True

    for t in range(length):
        for i in range(n_slots):
            valid[i] = False
        for rec in prog:
            op = rec[0]
            if op == "in":
                vals[rec[2]] = rec[1][t]
                valid[rec[2]] = True
            elif op == "const":
                vals[rec[2]] = rec[1]
                valid[rec[2]] = True
            elif op == "alu":
                _, fn, const, oa, ob, dst = rec
                a, va = read(oa)
                b, vb = read(ob)
                if b is None:
                    b, vb = const, True
                ok = bool(va and vb)
                vals[dst] = fn(a, b) if ok else 0
                valid[dst] = ok
            elif op == "red":
                _, name, fn, const, k, acc_init, oa, dst = rec
                a, va = read(oa)
                if not va:
                    valid[dst] = False
                    continue
                x = const if const is not None else a
                acc = fn(accs[name], x)
                emit = (k == 1) or (k > 1 and (t + 1) % k == 0) or \
                       (k == 0 and t == length - 1)
                vals[dst] = acc
                valid[dst] = emit
                if k > 1 and (t + 1) % k == 0:
                    acc = acc_init
                accs[name] = acc
            elif op == "cmp":
                _, eqz, const, oa, ob, dst = rec
                a, va = read(oa)
                b, vb = read(ob)
                if b is not None:
                    a, va = wrap_i(a - b), bool(va and vb)
                elif const is not None and va:
                    a = wrap_i(a - const)
                vals[dst] = (1 if ((a == 0) if eqz else (a > 0)) else 0) \
                    if va else 0
                valid[dst] = bool(va)
            elif op == "mux":
                _, const, oa, ob, oc, dst = rec
                a, va = read(oa)
                b, vb = read(ob)
                c, vc = read(oc)
                if b is None:
                    b, vb = const, True
                ok = bool(va and vb and vc)
                vals[dst] = (a if c != 0 else b) if ok else 0
                valid[dst] = ok
            elif op == "br":
                _, oa, oc, dt, df = rec
                a, va = read(oa)
                c, vc = read(oc)
                ok = bool(va and vc)
                v = a if ok else 0
                vals[dt] = v
                valid[dt] = ok and c != 0
                vals[df] = v
                valid[df] = ok and c == 0
            elif op == "mg":
                _, name, oa, ob, dst = rec
                a, va = read(oa)
                b, vb = read(ob)
                if va and vb:
                    raise ValueError(f"MERGE {name}: both inputs valid "
                                     f"at t={t}")
                vals[dst] = a if va else (b if vb else 0)
                valid[dst] = bool(va or vb)
            else:   # "out"
                _, name, k, oa = rec
                a, va = read(oa)
                if va:
                    if k == 0:
                        last_vals[name] = a
                    else:
                        out_streams[name].append(a)
        # latch back-edge carries from this token's emissions
        for src_slot, idx in latches:
            if valid[src_slot]:
                carries[idx] = vals[src_slot]

    outputs = {}
    for o in g.outputs:
        if g.nodes[o].emit_every == 0:
            outputs[o] = np.array([last_vals[o]] if last_vals[o] is not None else [],
                                  dtype=I32)
        else:
            outputs[o] = np.array(out_streams[o], dtype=I32)
    return outputs


# ---------------------------------------------------------------------------
# token path (data-dependent loops: Branch/Merge recirculation)
# ---------------------------------------------------------------------------
# element-parallel fast path for canonical demand-gated loops
# ---------------------------------------------------------------------------

def _gated_plan(g: D.DFG):
    """Structural eligibility of the element-parallel gated-loop path.

    The demand-token gate of the canonical while-loop schema admits one
    stream element at a time, so elements are mutually independent and
    exit in element order; the loop body can then be evaluated as masked
    *vector* iteration — O(max trip count x body nodes) NumPy ops instead
    of O(elements x trips x nodes) Python token firings. Returns the body
    component list, or None when any condition fails (the general token
    interpreter remains the fallback):

      * every MERGE is a recirculation entry merge, and every
        recirculation edge targets a MERGE;
      * every BRANCH is inside a loop body; bodies contain no reductions;
      * non-body wires enter a body only through entry-merge ports;
      * every loop-carried (``init`` not None) back edge is a demand edge:
        init 0 and a provably-zero source (ALU MUL/AND with constant 0) —
        state cells fall back to token execution;
      * each body component is serialized by a demand edge: the edge's
        source is reachable from the component and its destination feeds
        the component's entries (this is what makes exits element-ordered);
      * stream OUTPUTs consume body wires only via branch exit legs.
    """
    cached = g.__dict__.get("_gated_plan_cache", False)
    if cached is not False:
        return cached

    def compute():
        if not g.has_recirculation():
            return None
        body = g.recirculation_nodes()
        recirc_targets = set()
        for e in g.edges:
            if e.back and e.init is None:
                if g.nodes[e.dst].kind != D.MERGE:
                    return None
                recirc_targets.add(e.dst)
        for n in g.nodes.values():
            if n.kind == D.MERGE and n.name not in recirc_targets:
                return None
            if n.kind == D.BRANCH and n.name not in body:
                return None
            if n.is_reduction() and n.name in body:
                return None
        for name in body:
            n = g.nodes[name]
            for e in g.in_edges(name):
                if e.back or e.src in body:
                    continue
                if n.kind != D.MERGE:
                    return None
        # loop-carried init edges must be zero-valued demand edges
        demand_edges = []
        for e in g.back_edges():
            if e.init is None:
                continue
            src = g.nodes[e.src]
            if e.init != 0 or src.kind != D.ALU or \
                    src.op not in (AluOp.MUL, AluOp.AND) or src.value != 0:
                return None
            demand_edges.append(e)
        # split the body into connected components
        adj: Dict[str, set] = {n: set() for n in body}
        for e in g.edges:
            if e.src in body and e.dst in body:
                adj[e.src].add(e.dst)
                adj[e.dst].add(e.src)
        comps: List[set] = []
        seen: set = set()
        for n in body:
            if n in seen:
                continue
            comp, stack = {n}, [n]
            while stack:
                for m in adj[stack.pop()]:
                    if m not in comp:
                        comp.add(m)
                        stack.append(m)
            seen |= comp
            comps.append(comp)
        # every component must be serialized by a demand edge
        fwd: Dict[str, List[str]] = {n: [] for n in g.nodes}
        for e in g.edges:
            if not e.back:
                fwd[e.src].append(e.dst)

        def reach(start: set) -> set:
            out, stack = set(start), list(start)
            while stack:
                for m in fwd[stack.pop()]:
                    if m not in out:
                        out.add(m)
                        stack.append(m)
            return out

        for comp in comps:
            downstream = reach(comp)
            ok = False
            for e in demand_edges:
                if e.src in downstream and comp & reach({e.dst}):
                    ok = True
                    break
            if not ok:
                return None
        # wires leaving a body must be branch exit legs with no consumer
        # inside the body (they fire exactly once per element); anything
        # else (e.g. a per-round body wire feeding an OMN) falls back
        for comp in comps:
            inner = {(e.src, e.src_port) for e in g.edges
                     if not e.back and e.src in comp and e.dst in comp}
            for e in g.edges:
                if e.back or e.src not in comp or e.dst in comp:
                    continue
                if g.nodes[e.src].kind != D.BRANCH or \
                        (e.src, e.src_port) in inner:
                    return None
        return comps

    plan = compute()
    g.__dict__["_gated_plan_cache"] = plan
    return plan


def _execute_gated_vec(g: D.DFG, arrays, length: int, comps,
                       max_rounds: int = 100_000):
    """Element-parallel evaluation of an eligible gated-loop graph.

    Non-body nodes evaluate exactly like ``_execute_vectorized`` (full
    streams + validity masks); each body component runs as masked vector
    iteration — one pass over the body per loop round, elements retiring
    from the ``active`` mask as their predicate releases them. Exit wires
    come out indexed by element, which is the arrival order the demand
    gate enforces in the token model.
    """
    body_of: Dict[str, set] = {}
    for comp in comps:
        for n in comp:
            body_of[n] = comp
    recirc = [e for e in g.back_edges() if e.init is None]

    vals: Dict[Tuple[str, str], np.ndarray] = {}
    masks: Dict[Tuple[str, str], np.ndarray] = {}
    outputs: Dict[str, np.ndarray] = {}
    full = np.ones(length, dtype=bool)

    def node_vec(n: D.Node, read):
        """One vectorized node evaluation; ``read(port)`` -> (vals, mask)."""
        name = n.name
        if n.kind == D.ALU:
            a, ma = read("a")
            if n.is_reduction():
                return {("out",): _reduce_vec(n, a, ma, length)}
            b, mb = read("b")
            if b is None:
                b, mb = np.full(length, n.value, dtype=I32), full
            return {("out",): (alu_eval(n.op, a, b), ma & mb)}
        if n.kind == D.CMP:
            a, ma = read("a")
            b, mb = read("b")
            if b is not None:
                a, ma = alu_eval(AluOp.SUB, a, b), ma & mb
            elif n.value is not None:
                a = alu_eval(AluOp.SUB, a, np.full(length, n.value, dtype=I32))
            return {("out",): (cmp_eval(n.op, a), ma)}
        if n.kind == D.MUX:
            a, ma = read("a")
            b, mb = read("b")
            c, mc = read("ctrl")
            if b is None:
                b, mb = np.full(length, n.value, dtype=I32), full
            return {("out",): (np.where(c != 0, a, b).astype(I32),
                               ma & mb & mc)}
        if n.kind == D.BRANCH:
            a, ma = read("a")
            c, mc = read("ctrl")
            m = ma & mc
            return {("t",): (a, m & (c != 0)), ("f",): (a, m & (c == 0))}
        raise AssertionError(n.kind)      # pragma: no cover

    def run_component(comp: set):
        order = [n for n in g.topo_order() if n in comp]
        carries = {(e.dst, e.dst_port): e for e in recirc if e.dst in comp}
        carry_val = {k: np.zeros(length, dtype=I32) for k in carries}
        carry_ok = {k: np.zeros(length, dtype=bool) for k in carries}
        none_val = np.zeros(length, dtype=I32)
        none_ok = np.zeros(length, dtype=bool)
        bvals: Dict[Tuple[str, str], np.ndarray] = {}
        bmask: Dict[Tuple[str, str], np.ndarray] = {}
        exit_val: Dict[Tuple[str, str], np.ndarray] = {}
        exit_ok: Dict[Tuple[str, str], np.ndarray] = {}
        # wires leaving the body (consumed outside, incl. OUTPUT nodes)
        leaving = {(e.src, e.src_port) for e in g.edges
                   if e.src in comp and e.dst not in comp and not e.back}

        def merge_port(name: str, port: str, rounds: int):
            """Entry-merge operand: a recirculation carry, or the entry
            wire — consumable exactly once, in round 1."""
            key = (name, port)
            if key in carries:
                return carry_val[key], carry_ok[key]
            e = g.operand(name, port)
            if e is None or rounds != 1:
                return none_val, none_ok
            return vals[(e.src, e.src_port)], masks[(e.src, e.src_port)]

        rounds = 0
        while True:
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError(
                    f"{g.name}: token execution exceeded the loop budget; "
                    f"a data-dependent loop predicate never released its "
                    f"token (non-terminating loop)")
            for name in order:
                n = g.nodes[name]
                if n.kind == D.MERGE:
                    av, am = merge_port(name, "a", rounds)
                    bv, bm = merge_port(name, "b", rounds)
                    if np.any(am & bm):
                        raise ValueError(f"MERGE {name}: non-complementary "
                                         f"token masks")
                    outs = {("out",): (np.where(am, av, bv).astype(I32),
                                       am | bm)}
                else:
                    def read(port, _n=n):
                        e = g.operand(_n.name, port)
                        if e is None:
                            return None, None
                        key = (e.src, e.src_port)
                        return bvals.get(key, none_val), \
                            bmask.get(key, none_ok)
                    outs = node_vec(n, read)
                for (port,), (v, m) in outs.items():
                    bvals[(name, port)] = v
                    bmask[(name, port)] = m
            # latch recirculation carries and harvest exits
            for key, e in carries.items():
                src = (e.src, e.src_port)
                carry_val[key] = bvals.get(src, none_val)
                carry_ok[key] = bmask.get(src, none_ok)
            for w in leaving:
                if w not in bmask:
                    continue
                m = bmask[w]
                if w not in exit_ok:
                    exit_val[w] = np.zeros(length, dtype=I32)
                    exit_ok[w] = np.zeros(length, dtype=bool)
                new = m & ~exit_ok[w]
                if np.any(new):
                    exit_val[w] = np.where(new, bvals[w],
                                           exit_val[w]).astype(I32)
                    exit_ok[w] |= new
            if not any(np.any(m) for m in carry_ok.values()):
                break
        for w in leaving:
            if w in exit_ok:
                vals[w] = exit_val[w]
                masks[w] = exit_ok[w]
            else:
                vals[w] = np.zeros(length, dtype=I32)
                masks[w] = np.zeros(length, dtype=bool)

    def eval_node(name: str) -> None:
        n = g.nodes[name]
        if n.kind == D.INPUT:
            vals[(name, "out")], masks[(name, "out")] = arrays[name], full
        elif n.kind == D.CONST:
            vals[(name, "out")] = np.full(length, n.value, dtype=I32)
            masks[(name, "out")] = full
        elif n.kind == D.OUTPUT:
            e = g.operand(name, "a")
            a, ma = vals[(e.src, e.src_port)], masks[(e.src, e.src_port)]
            out = a[ma]
            if n.emit_every == 0 and out.size:
                out = out[-1:]
            outputs[name] = out.astype(I32)
        else:
            def read(port, _n=n):
                e = g.operand(_n.name, port)
                if e is None:
                    return None, None
                if e.back and e.init is not None:
                    # demand edge: provably zero-valued (plan condition)
                    return np.zeros(length, dtype=I32), full
                return vals[(e.src, e.src_port)], masks[(e.src, e.src_port)]
            for (port,), (v, m) in node_vec(n, read).items():
                vals[(name, port)] = v
                masks[(name, port)] = m

    def deps_ready(name: str) -> bool:
        for e in g.in_edges(name):
            if not e.back and (e.src, e.src_port) not in vals:
                return False
        return True

    # relaxation schedule: topo order ignores back edges, so a loop body's
    # exit consumers can precede the body's own trigger point — defer any
    # node whose operands aren't produced yet and re-sweep until done
    entries_of = {frozenset(c): {(e.src, e.src_port) for e in g.edges
                                 if not e.back and e.dst in c
                                 and e.src not in c}
                  for c in comps}
    done_comps: set = set()
    pending = g.topo_order()
    while pending:
        progress = False
        rest: List[str] = []
        for name in pending:
            if name in body_of:
                comp = frozenset(body_of[name])
                if comp in done_comps:
                    progress = True
                    continue
                if all(w in vals for w in entries_of[comp]):
                    done_comps.add(comp)
                    run_component(body_of[name])
                    progress = True
                else:
                    rest.append(name)
            elif deps_ready(name):
                eval_node(name)
                progress = True
            else:
                rest.append(name)
        if not progress:
            raise ValueError(f"{g.name}: gated-loop schedule stuck; "
                             f"falling back to token execution")
        pending = rest
    return outputs


def _execute_tokens(g: D.DFG, arrays, length: int,
                    max_firings: Optional[int] = None):
    """Un-timed token-driven interpretation with per-edge FIFO queues.

    Mirrors the elastic fabric's firing rules without the timing: a node
    fires when every connected input port holds a token (MERGE: either
    port, priority a), consuming one token per port and forking its result
    to every consumer edge. Back edges with an ``init`` value seed one
    initial token; recirculation edges (``init=None``) start empty. The
    run terminates when the network quiesces with all input tokens
    injected — the token-exhaustion rule; a firing budget guards against
    a loop whose predicate never releases its token.

    Scheduling: every node is a deterministic stream function of its input
    FIFOs (a Kahn network), so outputs are schedule-independent — except at
    MERGE, which commits tokens in *arrival* order. When every MERGE is a
    recirculation entry merge (one port fed by an ``init=None`` back edge),
    the demand-token gate serializes arrivals and an event-driven worklist
    is safe and fast. Any other MERGE (e.g. a Branch/Merge conditional
    inside a recirculating graph) forces the conservative round-robin
    sweep — one token per node per pass — which preserves the pipeline's
    arrival interleaving exactly.
    """
    from collections import deque

    if max_firings is None:
        max_firings = 10_000 * (length + 1) * max(len(g.nodes), 1)

    # canonical demand-gated loops: element-parallel masked vector
    # iteration (orders of magnitude fewer Python steps); any structural
    # or runtime ineligibility falls back to token interpretation
    if length:
        comps = _gated_plan(g)
        if comps is not None:
            try:
                return _execute_gated_vec(g, arrays, length, comps)
            except ValueError:
                pass
    # one FIFO per consumer port, keyed (dst, dst_port); producers fork
    # to every edge leaving (src, src_port)
    in_q: Dict[Tuple[str, str], deque] = {}
    consumers: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
    for e in g.edges:
        in_q[(e.dst, e.dst_port)] = deque()
        consumers.setdefault((e.src, e.src_port), []).append(
            (e.dst, e.dst_port))
    for e in g.back_edges():
        if e.init is not None:
            in_q[(e.dst, e.dst_port)].append(wrap_i(int(e.init)))

    for n in g.nodes.values():
        if n.kind == D.CONST and n.name in g.recirculation_nodes():
            # CONST paces one token per stream element (as in the loop
            # path); a const *inside* a recirculation body would need one
            # token per iteration instead, which no stream can provide
            raise ValueError(
                f"{g.name}: CONST node {n.name} inside a recirculation "
                f"loop body; fold it into a PE constant")

    # --- compile the graph to a flat node program ---
    order = [n for n in g.topo_order()
             if g.nodes[n].kind not in (D.INPUT, D.CONST)]
    node_idx = {name: i for i, name in enumerate(order)}
    accs = {n.name: wrap_i(int(n.acc_init)) for n in g.nodes.values()
            if n.is_reduction()}
    acc_count = {n: 0 for n in accs}
    out_streams: Dict[str, List[int]] = {o: [] for o in g.outputs}
    last_vals: Dict[str, Optional[int]] = {o: None for o in g.outputs}

    def sinks(name: str, port: str) -> List[Tuple[deque, int]]:
        """(consumer queue, consumer program index) fanout of one wire."""
        return [(in_q[key], node_idx.get(key[0], -1))
                for key in consumers.get((name, port), ())]

    recirc_targets = {e.dst for e in g.edges if e.back and e.init is None}
    worklist_safe = all(n.name in recirc_targets
                        for n in g.nodes.values() if n.kind == D.MERGE)

    # per-node closures: ``fire`` processes at most ONE token per call and
    # returns the woken consumer-index tuple (None = not ready); ``drain``
    # processes every available token in one call and returns
    # (count fired, wake tuple) or None. Queues and fanout are bound into
    # the closures; the 32-bit wrap is inlined in ALU_FN_I.
    fires: List = []
    drains: List = []
    for name in order:
        n = g.nodes[name]
        aq = in_q.get((name, "a"))
        bq = in_q.get((name, "b"))
        cq = in_q.get((name, "ctrl"))
        out_s = sinks(name, "out")
        out_qs = tuple(dq for dq, _ in out_s)
        wake = tuple(sorted({j for _, j in out_s if j >= 0}))
        fire, drain = _compile_token_node(
            n, length, aq, bq, cq, out_qs, wake,
            tuple(dq for dq, _ in sinks(name, "t")),
            tuple(sorted({j for _, j in sinks(name, "t") if j >= 0})),
            tuple(dq for dq, _ in sinks(name, "f")),
            tuple(sorted({j for _, j in sinks(name, "f") if j >= 0})),
            accs, acc_count, out_streams, last_vals)
        fires.append(fire)
        drains.append(drain)

    # seed stream tokens: inputs and (length-paced) consts
    for name in g.inputs:
        vals = [int(x) for x in arrays[name]]
        for dq, _ in sinks(name, "out"):
            dq.extend(vals)
    for n in g.nodes.values():
        if n.kind == D.CONST:
            for dq, _ in sinks(n.name, "out"):
                dq.extend([int(n.value)] * length)

    firings = 0
    overflow = RuntimeError(
        f"{g.name}: token execution exceeded {max_firings} firings; a "
        f"data-dependent loop predicate never released its token "
        f"(non-terminating loop)")

    if worklist_safe:
        # event-driven: drain each node, then revisit only nodes whose
        # input queues gained tokens
        pending = deque(range(len(drains)))
        queued = bytearray(len(drains))
        for i in pending:
            queued[i] = 1
        while pending:
            i = pending.popleft()
            queued[i] = 0
            res = drains[i]()
            if res is not None:
                count, w = res
                firings += count
                if firings > max_firings:
                    raise overflow
                for j in w:
                    if not queued[j]:
                        queued[j] = 1
                        pending.append(j)
    else:
        # conservative sweep: one token per node per pass, topo order —
        # preserves the pipeline interleaving that orders arrivals at
        # non-loop MERGEs
        progress = True
        while progress:
            progress = False
            for f in fires:
                if f() is not None:
                    progress = True
                    firings += 1
                    if firings > max_firings:
                        raise overflow

    outputs = {}
    for o in g.outputs:
        if g.nodes[o].emit_every == 0:
            outputs[o] = np.array(
                [last_vals[o]] if last_vals[o] is not None else [], dtype=I32)
        else:
            outputs[o] = np.array(out_streams[o], dtype=I32)
    return outputs


def _compile_token_node(n: D.Node, length: int, aq, bq, cq,
                        out_qs, wake, t_qs, t_wake, f_qs, f_wake,
                        accs, acc_count, out_streams, last_vals):
    """Compile one DFG node into a pair of closures for the token
    interpreter.

    ``fire()`` processes at most one token, returning the tuple of
    consumer indices to wake (empty tuple = fired without emitting) or
    ``None`` when not ready — the conservative sweep's unit step.
    ``drain()`` processes every available token in one call, returning
    ``(count, wake tuple)`` or ``None`` — the event-driven worklist's unit
    step, amortizing call overhead over token bursts. Queues, fanout, and
    constants are bound into the closures so the hot loops do no dict
    lookups or kind dispatch.
    """
    kind = n.kind
    name = n.name

    if kind == D.OUTPUT:
        if n.emit_every == 0:
            def fire():
                if not aq:
                    return None
                v = aq.popleft() & _M
                last_vals[name] = v - _W if v >= _H else v
                return wake

            def drain():
                if not aq:
                    return None
                c = len(aq)
                v = aq[-1] & _M
                last_vals[name] = v - _W if v >= _H else v
                aq.clear()
                return c, wake
        else:
            app = out_streams[name].append

            def fire():
                if not aq:
                    return None
                v = aq.popleft() & _M
                app(v - _W if v >= _H else v)
                return wake

            def drain():
                if not aq:
                    return None
                c = len(aq)
                while aq:
                    v = aq.popleft() & _M
                    app(v - _W if v >= _H else v)
                return c, wake
        return fire, drain

    if kind == D.MERGE:
        def fire():
            if aq:
                v = aq.popleft()
            elif bq:
                v = bq.popleft()
            else:
                return None
            for dq in out_qs:
                dq.append(v)
            return wake

        def drain():
            c = 0
            while True:
                if aq:
                    v = aq.popleft()
                elif bq:
                    v = bq.popleft()
                else:
                    break
                for dq in out_qs:
                    dq.append(v)
                c += 1
            return (c, wake) if c else None
        return fire, drain

    if kind == D.BRANCH:
        def fire():
            if not aq or not cq:
                return None
            c = cq.popleft()
            a = aq.popleft()
            if c != 0:
                for dq in t_qs:
                    dq.append(a)
                return t_wake
            for dq in f_qs:
                dq.append(a)
            return f_wake

        tf_wake = tuple(sorted(set(t_wake) | set(f_wake)))

        def drain():
            c = 0
            legs = 0
            while aq and cq:
                ctl = cq.popleft()
                a = aq.popleft()
                if ctl != 0:
                    for dq in t_qs:
                        dq.append(a)
                    legs |= 1
                else:
                    for dq in f_qs:
                        dq.append(a)
                    legs |= 2
                c += 1
            if not c:
                return None
            return c, (t_wake if legs == 1 else
                       f_wake if legs == 2 else tf_wake)
        return fire, drain

    if kind == D.CMP:
        if n.op not in (CmpOp.EQZ, CmpOp.GTZ):
            raise ValueError(f"bad CMP op {n.op}")
        eqz = n.op == CmpOp.EQZ
        const = n.value
        if bq is not None:
            def step():
                av = (aq.popleft() - bq.popleft()) & _M
                if av >= _H:
                    av -= _W
                v = 1 if ((av == 0) if eqz else (av > 0)) else 0
                for dq in out_qs:
                    dq.append(v)

            def fire():
                if not aq or not bq:
                    return None
                step()
                return wake

            def drain():
                c = 0
                while aq and bq:
                    step()
                    c += 1
                return (c, wake) if c else None
        else:
            def step():
                if const is not None:
                    av = (aq.popleft() - const) & _M
                    if av >= _H:
                        av -= _W
                else:
                    av = aq.popleft()
                v = 1 if ((av == 0) if eqz else (av > 0)) else 0
                for dq in out_qs:
                    dq.append(v)

            def fire():
                if not aq:
                    return None
                step()
                return wake

            def drain():
                c = len(aq)
                if not c:
                    return None
                while aq:
                    step()
                return c, wake
        return fire, drain

    if kind == D.MUX:
        const = n.value

        def step():
            ctl = cq.popleft()
            a = aq.popleft()
            b = bq.popleft() if bq is not None else const
            v = a if ctl != 0 else b
            for dq in out_qs:
                dq.append(v)

        def fire():
            if not aq or not cq or (bq is not None and not bq):
                return None
            step()
            return wake

        def drain():
            c = 0
            while aq and cq and (bq is None or bq):
                step()
                c += 1
            return (c, wake) if c else None
        return fire, drain

    # ALU
    fn = ALU_FN_I[n.op]
    const = n.value
    if n.is_reduction():
        k = n.emit_every
        acc_init = wrap_i(int(n.acc_init))
        extras = tuple(q for q in (bq, cq) if q is not None)

        def fire():
            if not aq:
                return None
            for q in extras:
                if not q:
                    return None
            a = aq.popleft()
            for q in extras:
                q.popleft()               # joined but unused (token pacing)
            x = const if const is not None else a
            acc = fn(accs[name], x)
            count = acc_count[name] = acc_count[name] + 1
            ret = ()
            if k == 1 or (k > 1 and count % k == 0) or \
                    (k == 0 and count == length):
                for dq in out_qs:
                    dq.append(acc)
                ret = wake
                if k > 1:
                    acc = acc_init
            accs[name] = acc
            return ret

        def drain():
            c = 0
            emitted = False
            while True:
                r = fire()
                if r is None:
                    break
                c += 1
                emitted = emitted or r is wake
            if not c:
                return None
            return c, (wake if emitted else ())
        return fire, drain

    if bq is None:
        if len(out_qs) == 1:
            app = out_qs[0].append

            def fire():
                if not aq:
                    return None
                app(fn(aq.popleft(), const))
                return wake

            def drain():
                c = len(aq)
                if not c:
                    return None
                while aq:
                    app(fn(aq.popleft(), const))
                return c, wake
        else:
            def fire():
                if not aq:
                    return None
                v = fn(aq.popleft(), const)
                for dq in out_qs:
                    dq.append(v)
                return wake

            def drain():
                c = len(aq)
                if not c:
                    return None
                while aq:
                    v = fn(aq.popleft(), const)
                    for dq in out_qs:
                        dq.append(v)
                return c, wake
        return fire, drain

    if len(out_qs) == 1:
        app = out_qs[0].append

        def fire():
            if not aq or not bq:
                return None
            app(fn(aq.popleft(), bq.popleft()))
            return wake

        def drain():
            c = 0
            while aq and bq:
                app(fn(aq.popleft(), bq.popleft()))
                c += 1
            return (c, wake) if c else None
    else:
        def fire():
            if not aq or not bq:
                return None
            v = fn(aq.popleft(), bq.popleft())
            for dq in out_qs:
                dq.append(v)
            return wake

        def drain():
            c = 0
            while aq and bq:
                v = fn(aq.popleft(), bq.popleft())
                for dq in out_qs:
                    dq.append(v)
                c += 1
            return (c, wake) if c else None
    return fire, drain
