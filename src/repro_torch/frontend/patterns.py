"""Control/reduction idiom recognition for the torch frontend (paper Sec.
III-C; counterpart of ``repro.frontend.patterns``).

The fabric supports the control patterns of the elastic Branch/Merge
microarchitecture beyond elementwise data flow, and this module lowers the
aten graph idioms that express them:

  * **reductions** — ``sum`` / ``prod`` over a whole stream and 1-D
    ``dot``: lower to the ALU's immediate feedback accumulator
    (``acc_init`` + ``emit_every`` = stream length), the hardware mechanism
    behind mac1/mac3 (Fig. 7c). torch widens an int32 sum or product to
    int64; the accumulator wraps mod 2^32, which is that int64 value
    wrapped to int32. aten has no integer OR/AND/XOR reduction, so those
    accumulators come only from hand-built DFGs;
  * **two-way ``torch.cond``** — lowers to BRANCH/MERGE pairs: every stream
    operand is steered by a BRANCH node driven by the predicate, each branch
    subgraph is lowered on its leg (so only the taken side fires, unlike a
    mux that evaluates both), and each result is re-joined by a MERGE of the
    complementary legs. A constant branch result (``full_like``) is paced
    by its leg. ``torch.cond`` needs a single-element predicate, so it is
    only reachable in element-mode traces (the tracer falls back
    automatically);
  * **``while_loop`` (irregular, data-dependent loops)** — lowers to the
    gated loop schema of the paper's Fig. 4 elastic feedback: a demand-token
    *gate* admits one stream element into the loop at a time (preserving OMN
    output order), an entry MERGE joins the admitted value with the
    recirculating one, the loop predicate is evaluated on the merged carry
    and steers one BRANCH per loop variable — the taken leg recirculates
    through the body over a *recirculation back edge* (``init=None``, no
    initial token), the not-taken leg exits. The exit event mints the next
    demand token. Values the functions close over arrive as the loop's
    additional inputs (invariants, recirculated unchanged);
  * **``scan`` over the stream** — the loop-carried recurrence pattern
    (dither's error diffusion): carries become back edges with their initial
    value as the register init, the body fires once per element. A scan
    whose ``xs`` are compile-time constants (``torch.arange(n)``, the torch
    spelling of a static-trip ``fori_loop``) is unrolled in place.

Handlers follow the tracer's calling convention:
``handler(lowerer, node, in_values, kwargs) -> value``.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from repro_torch.core import dfg as D
from repro_torch.core.isa import AluOp
from repro_torch.frontend.tracer import (ConstArr, ConstVal, FinalWire,
                                         Lowerer, Value, Wire, _fold,
                                         _shape)

# static-trip loops (a scan over constant xs) are unrolled in place up to
# this many iterations; beyond that the graph would not place anyway
MAX_STATIC_UNROLL = 64

# reduction op -> (ALU op, accumulator init)
_REDUCE_OPS = {
    "sum": (AluOp.ADD, 0),
    "prod": (AluOp.MUL, 1),
}


def _h_reduce(lw: Lowerer, node, ins: List[Value], kw) -> Value:
    op, init = _REDUCE_OPS[node.target.overloadpacket.__name__]
    in_shape = _shape(node.args[0])
    v = ins[0]
    dims = ins[1] if len(ins) > 1 else kw.get("dim")
    if isinstance(dims, ConstVal):
        dims = [dims]
    dims = sorted({d.value % max(len(in_shape), 1) for d in dims or ()})
    if not in_shape:
        return v                          # element-mode no-op reduction
    if len(in_shape) != 1 or dims not in ([], [0]):
        raise lw.unsupported(
            node, f"partial/multi-axis reduction over shape {in_shape}; "
                  f"only whole-stream 1-D reductions map to the ALU "
                  f"accumulator")
    if isinstance(v, ConstVal):
        acc = np.int64(init)
        from repro_torch.core.executor import alu_eval
        for _ in range(lw.length):
            acc = np.int64(alu_eval(op, acc, v.value))
        return ConstVal(_fold(acc))
    return lw.emit_alu(op, v, stem="acc", acc_init=init,
                       emit_every=lw.length)


def _h_dot(lw: Lowerer, node, ins: List[Value], kw) -> Value:
    shapes = [_shape(a) for a in node.args[:2]]
    if any(len(s) != 1 for s in shapes):
        raise lw.unsupported(
            node, f"dot over shapes {shapes}; only 1-D dot products (a "
                  f"single mac lane) lower to the fabric")
    a, b = ins[:2]
    prod = lw.alu(AluOp.MUL, a, b)
    if isinstance(prod, ConstVal):
        return ConstVal(_fold(np.int64(prod.value) * lw.length))
    return lw.emit_alu(AluOp.ADD, prod, stem="acc", acc_init=0,
                       emit_every=lw.length)


def _h_cond(lw: Lowerer, node, ins: List[Value], kw) -> List[Value]:
    index, true_gm, false_gm, operands = ins[:4]
    operands = list(operands)
    if isinstance(index, ConstVal):
        # statically-taken branch: inline it directly
        return lw.lower_graph(true_gm if index.value else false_gm,
                              operands)

    true_env: List[Value] = []
    false_env: List[Value] = []
    true_leg: Wire = None
    false_leg: Wire = None
    for v in operands:
        if not isinstance(v, Wire):
            true_env.append(v)
            false_env.append(v)
            continue
        name = lw.fresh("br")
        lw.b.branch(name, v.node, index.node,
                    a_port=v.port, ctrl_port=index.port)
        t, f = Wire(name, "t"), Wire(name, "f")
        true_env.append(t)
        false_env.append(f)
        if true_leg is None:
            true_leg, false_leg = t, f
    if true_leg is None:
        raise lw.unsupported(
            node, "cond consumes no stream operands; nothing paces the "
                  "branch legs")

    t_outs = lw.lower_graph(true_gm, true_env)
    f_outs = lw.lower_graph(false_gm, false_env)

    outs: List[Value] = []
    for t, f in zip(t_outs, f_outs):
        if isinstance(t, ConstVal):
            t = lw.paced_const(true_leg, t.value)
        if isinstance(f, ConstVal):
            f = lw.paced_const(false_leg, f.value)
        name = lw.fresh("mg")
        lw.b.merge(name, t.node, f.node, a_port=t.port, b_port=f.port)
        outs.append(Wire(name))
    return outs


# ---------------------------------------------------------------------------
# irregular loops: while_loop -> gated Branch/Merge recirculation
# ---------------------------------------------------------------------------

def _h_while(lw: Lowerer, node, ins: List[Value], kw) -> List[Value]:
    """Lower ``while_loop`` onto the elastic loop schema (see module
    docstring). Loop variables are the additional inputs (invariants the
    cond/body close over, recirculated unchanged) followed by the carry;
    both subgraphs take ``(*carry, *invariants)``."""
    cond_gm, body_gm, carried, additional = ins[:4]
    ni = len(additional)
    entries = list(additional) + list(carried)
    n_carry = len(carried)

    wire_idx = [i for i, v in enumerate(entries) if isinstance(v, Wire)]
    if not wire_idx:
        raise lw.unsupported(
            node, "while loop consumes no stream operands; nothing paces "
                  "elements into the loop")

    # 1. demand gates: one per stream-derived loop input. A gate joins the
    # fresh element with a demand token minted by the previous element's
    # exit, so at most one element circulates at a time (output order).
    gates: Dict[int, Wire] = {}
    gate_nodes: List[str] = []
    for i in wire_idx:
        v = entries[i]
        if isinstance(v, FinalWire) or lw._rate.get(v.node, 1) != 1:
            raise lw.unsupported(
                node, f"loop operand {i} is a reduction output (a single "
                      f"emitted token); the loop gate needs one token per "
                      f"stream element")
        gname = lw.fresh("lgate")
        lw.b.alu(gname, AluOp.ADD, v.node, None, a_port=v.port)
        lw._rate[gname] = 1
        gates[i] = Wire(gname)
        gate_nodes.append(gname)
    pace = gates[wire_idx[0]]

    # Loop variables that circulate: stream-derived invariants (their token
    # must be re-presented each iteration) and every carry. Compile-time
    # constant invariants fold into PE constants inside cond/body instead.
    looped = [i for i, v in enumerate(entries)
              if isinstance(v, Wire) or i >= ni]

    # 2. constant carry inits become paced constants off the admitted element
    entry_vals: Dict[int, Wire] = {}
    for i in looped:
        v = entries[i]
        entry_vals[i] = gates[i] if i in gates \
            else lw.paced_const(pace, v.value)

    # 3. entry merges: recirculating value (port a, attached below via a
    # recirculation back edge) has priority over the next fresh element
    merges: Dict[int, Wire] = {}
    for i in looped:
        ev = entry_vals[i]
        mname = lw.fresh("lmg")
        lw.b.merge(mname, None, ev.node, b_port=ev.port)
        lw._rate[mname] = 1
        merges[i] = Wire(mname)

    def var(i: int) -> Value:
        return merges[i] if i in merges else entries[i]

    carry_idx = range(ni, len(entries))
    # 4. the loop predicate fires once per iteration on the merged values
    (pred,) = lw.lower_graph(cond_gm, [var(i) for i in carry_idx] +
                             [var(i) for i in range(ni)])
    if isinstance(pred, ConstVal):
        raise lw.unsupported(
            node, f"loop predicate is the compile-time constant "
                  f"{pred.value}; a data-dependent loop must read its carry "
                  f"or an input")

    # 5. one BRANCH per circulating variable: taken leg iterates, the
    # not-taken leg exits the loop
    brs: Dict[int, str] = {}
    for i in looped:
        bname = lw.fresh("lbr")
        lw.b.branch(bname, merges[i].node, pred.node,
                    a_port=merges[i].port, ctrl_port=pred.port)
        brs[i] = bname

    def taken(i: int) -> Value:
        return Wire(brs[i], "t") if i in brs else entries[i]

    # 6. body on the taken legs (constant invariants pass straight through)
    new_carries = lw.lower_graph(body_gm, [taken(i) for i in carry_idx] +
                                 [taken(i) for i in range(ni)])

    # 7. recirculation back edges (no initial token): invariants straight
    # from their taken leg, carries from their body result
    t_pace = Wire(brs[looped[0]], "t")
    for i in looped:
        if i < ni:
            lw.b.back_edge(brs[i], merges[i].node, "a", init=None,
                           src_port="t")
    for k, nv in enumerate(new_carries):
        if isinstance(nv, ConstVal):
            nv = lw.paced_const(t_pace, nv.value)
        lw.b.back_edge(nv.node, merges[ni + k].node, "a", init=None,
                       src_port=nv.port)

    # 8. the exit event mints the next demand token (value 0, initial token
    # present so the first element is admitted)
    dem = lw.emit_alu(AluOp.MUL, Wire(brs[ni], "f"), const_b=0,
                      stem="ldem")
    for gname in gate_nodes:
        lw.b.back_edge(dem.node, gname, "b", init=0)

    # 9. the while's results are the carries' exit legs
    return [Wire(brs[ni + k], "f") for k in range(n_carry)]


# ---------------------------------------------------------------------------
# scan: stream recurrences (back-edge carries) and static unrolling
# ---------------------------------------------------------------------------

def _h_scan(lw: Lowerer, node, ins: List[Value], kw) -> List[Value]:
    """Lower ``scan(combine, init, xs)``; the combine subgraph takes
    ``(*carry, *x, *additional)`` and returns ``(*carry, *y)``."""
    body_gm, inits, xs, consts = ins[:4]
    inits, xs, consts = list(inits), list(xs), list(consts)
    ncar = len(inits)

    if xs and all(isinstance(x, ConstArr) for x in xs):
        # a static trip count (xs known at trace time): unroll in place
        length = int(xs[0].value.shape[0])
        if length > MAX_STATIC_UNROLL:
            raise lw.unsupported(
                node, f"static {length}-iteration loop exceeds the "
                      f"{MAX_STATIC_UNROLL}x unroll budget")
        if any(u.args[1] >= ncar and u.users for u in node.users):
            raise lw.unsupported(
                node, "unrolled static loop cannot emit per-iteration "
                      "outputs (no stream paces them)")
        vals: List[Value] = inits
        for k in range(length):
            step = [ConstVal(_fold(x.value[k])) for x in xs]
            vals = lw.lower_graph(body_gm, vals + step + consts)[:ncar]
        return vals + [None] * (len(node.meta["val"]) - ncar)   # unused ys

    # whole-stream recurrence: carries become loop-carried back edges
    length = _shape(node.args[2][0])[0]
    if length != lw.length:
        raise lw.unsupported(
            node, f"scan over {length} elements inside a {lw.length}-element "
                  f"stream trace; only whole-stream scans map to back edges")
    for k, c in enumerate(consts):
        if not isinstance(c, ConstVal):
            raise lw.unsupported(
                node, f"loop-invariant scan operand {k} is a runtime value; "
                      f"only compile-time scalars fold into PE constants")
    for k, iv in enumerate(inits):
        if not isinstance(iv, ConstVal):
            raise lw.unsupported(
                node, f"carry {k} initial value is a runtime value; a back "
                      f"edge's register init must be a compile-time scalar")

    sents = [lw.fresh("@carry") for _ in range(ncar)]
    sent_set = set(sents)
    outs = lw.lower_graph(body_gm, [Wire(s) for s in sents] + xs + consts)
    new_carries, ys = outs[:ncar], outs[ncar:]

    # a y that is the raw previous carry needs a pass-through node to own
    # the back edge (dither's error tap)
    ys = [lw.emit_alu(AluOp.ADD, y, const_b=0, stem="prev")
          if isinstance(y, Wire) and y.node in sent_set else y
          for y in ys]

    finals: List[Value] = []
    for k, nv in enumerate(new_carries):
        if isinstance(nv, ConstVal) or (isinstance(nv, Wire)
                                        and nv.node in sent_set):
            raise lw.unsupported(
                node, f"scan carry {k} is a constant or pass-through; fold "
                      f"the invariant out of the loop")
        init_val = _fold(inits[k].value)
        lw.b.edges = [
            D.Edge(nv.node, nv.port, e.dst, e.dst_port, True, init_val)
            if e.src == sents[k] else e
            for e in lw.b.edges]
        finals.append(FinalWire(nv.node, nv.port))
    return finals + ys


PATTERN_HANDLERS: Dict[str, Callable] = {
    **{op: _h_reduce for op in _REDUCE_OPS},
    "dot": _h_dot,
    "cond": _h_cond,
    "while_loop": _h_while,
    "scan": _h_scan,
}
