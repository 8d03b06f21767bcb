"""Plain PyTorch versions of the fabric kernels (counterpart of
``repro.kernels.ref``).

These define *what* ``csrc/fabric.cu`` computes. The CPU tests run them,
the kernel wrappers take them for tensors that lie on the CPU, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.

int32 semantics follow the reference exactly: arithmetic wraps mod 2^32
(computed in int64 and wrapped back, since signed overflow is not
something to lean on), shift counts are masked with ``& 31``, SHR is
arithmetic, and CMP tests the *wrapped* difference ``a - b``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import dfg as D
from repro_torch.core.isa import AluOp, CmpOp

I32 = torch.int32
I64 = torch.int64


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of an int64 tensor to int32."""
    return (((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(I32)


def dfg_node_eval(op: AluOp, a: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    a64, b64 = a.to(I64), b.to(I64)
    if op == AluOp.ADD:
        return wrap32(a64 + b64)
    if op == AluOp.SUB:
        return wrap32(a64 - b64)
    if op == AluOp.MUL:
        return wrap32(a64 * b64)
    if op == AluOp.SHL:
        return wrap32(a64 << (b64 & 31))
    if op == AluOp.SHR:
        return wrap32(a64 >> (b64 & 31))
    if op == AluOp.AND:
        return torch.bitwise_and(a, b)
    if op == AluOp.OR:
        return torch.bitwise_or(a, b)
    if op == AluOp.XOR:
        return torch.bitwise_xor(a, b)
    if op == AluOp.NOP:
        return a
    raise ValueError(op)


def _const(value, like: torch.Tensor) -> torch.Tensor:
    v = 0 if value is None else int(value)
    return torch.tensor(((v + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31, dtype=I32,
                        device=like.device)


def check_streamable(g: D.DFG) -> None:
    """Raise the reference's ``ValueError`` for a DFG no streaming
    evaluation handles: a loop-carried back edge, or a MERGE that is not
    a select of one predicate's complementary legs (the structural proof
    shared with the capability gate, memoized on the DFG)."""
    if g.back_edges():
        raise ValueError(f"{g.name}: loop-carried back edge — streaming "
                         f"evaluation handles acyclic DFGs only")
    offender = g.__dict__.get("_select_offender", False)
    if offender is False:
        from repro_torch.engine.capabilities import select_conds
        offender = select_conds(g)[1]
        g.__dict__["_select_offender"] = offender
    if offender is not None:
        raise ValueError(
            f"{g.name}: MERGE '{offender}' joins wires that are not "
            f"complementary legs of one branch predicate (not "
            f"select-reducible) — use backend='sim'")


def eval_dfg_streams(g: D.DFG, inputs: Dict[str, torch.Tensor]
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor], Dict[str, str]]:
    """Evaluate the acyclic part of a DFG over whole streams, speculatively.

    Every Branch leg is computed on *all* elements and a boolean validity
    mask rides alongside each wire: a Branch splits its mask by the
    predicate, a Merge rejoins complementary legs with a masked select.
    Inputs may have any shape (``(L,)`` for one request, ``(N, L)`` for a
    lane grid); a wire fed only by constants stays a 0-d tensor.

    Reduction nodes are not folded here; the caller owns the fold. Returns
    ``(stream_outs, red_ins, red_out_of)`` as the reference does.
    """
    check_streamable(g)
    vals: Dict[tuple, torch.Tensor] = {}
    masks: Dict[tuple, torch.Tensor] = {}
    outs: Dict[str, torch.Tensor] = {}
    red_ins: Dict[str, torch.Tensor] = {}
    red_out_of: Dict[str, str] = {}
    first = next(iter(inputs.values()))
    full = torch.ones(first.shape, dtype=torch.bool, device=first.device)

    for name in g.topo_order():
        n = g.nodes[name]

        def operand(port):
            e = g.operand(name, port)
            if e is None:
                return None, None
            key = (e.src, e.src_port)
            return vals[key], masks[key]

        if n.kind == D.INPUT:
            vals[(name, "out")] = inputs[name]
            masks[(name, "out")] = full
        elif n.kind == D.CONST:
            vals[(name, "out")] = _const(n.value, first)
            masks[(name, "out")] = full
        elif n.kind == D.ALU and n.is_reduction():
            a, _ = operand("a")
            if n.value is not None:       # paced counter: acc' = op(acc, c)
                a = _const(n.value, first).expand(first.shape)
            red_ins[name] = a
        elif n.kind == D.ALU:
            a, ma = operand("a")
            b, mb = operand("b")
            if b is None:
                b, mb = _const(n.value, first), ma
            vals[(name, "out")] = dfg_node_eval(n.op, a, b)
            masks[(name, "out")] = ma & mb
        elif n.kind == D.CMP:
            a, ma = operand("a")
            b, mb = operand("b")
            if b is not None:
                a, ma = dfg_node_eval(AluOp.SUB, a, b), ma & mb
            elif n.value is not None:
                a = dfg_node_eval(AluOp.SUB, a, _const(n.value, first))
            r = (a == 0) if n.op == CmpOp.EQZ else (a > 0)
            vals[(name, "out")] = r.to(I32)
            masks[(name, "out")] = ma
        elif n.kind == D.MUX:
            a, ma = operand("a")
            b, mb = operand("b")
            c, mc = operand("ctrl")
            if b is None:
                b, mb = _const(n.value, first), ma
            vals[(name, "out")] = torch.where(c != 0, a, b)
            masks[(name, "out")] = ma & mb & mc
        elif n.kind == D.BRANCH:
            a, ma = operand("a")
            c, mc = operand("ctrl")
            m = ma & mc
            vals[(name, "t")], masks[(name, "t")] = a, m & (c != 0)
            vals[(name, "f")], masks[(name, "f")] = a, m & (c == 0)
        elif n.kind == D.MERGE:
            a, ma = operand("a")
            b, mb = operand("b")
            # complementary legs, proven structurally by select_conds:
            # exactly one side is valid per element
            vals[(name, "out")] = torch.where(ma, a, b)
            masks[(name, "out")] = ma | mb
        elif n.kind == D.OUTPUT:
            e = g.operand(name, "a")
            if g.nodes[e.src].is_reduction():
                red_out_of[name] = e.src
            else:
                outs[name] = vals[(e.src, e.src_port)]
    return outs, red_ins, red_out_of


def reject_reductions(g: D.DFG) -> None:
    """Reductions carry state across the stream and lower through
    ``fabric_reduce``; ``fabric_stream`` rejects them by name."""
    for n in g.nodes.values():
        if n.is_reduction():
            raise ValueError(
                f"{g.name}: accumulator reduction node '{n.name}' "
                f"[reduction] — lower via kernels/fabric_reduce.py, "
                f"not fabric_stream")


def eval_dfg_elementwise(g: D.DFG, inputs: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Evaluate an acyclic, reduction-free DFG over whole streams (what
    ``fabric_stream`` computes). Reductions are rejected by name."""
    reject_reductions(g)
    outs, _, _ = eval_dfg_streams(g, inputs)
    return outs


# identity element per associative reduction op (the fold pads with it)
IDENTITY = {AluOp.ADD: 0, AluOp.SUB: 0, AluOp.XOR: 0, AluOp.OR: 0,
            AluOp.AND: -1, AluOp.MUL: 1}


def fold_lanes(op: AluOp, acc_init: int, x: torch.Tensor) -> torch.Tensor:
    """Fold each row of an int32 ``(N, L)`` tensor into ``acc_init`` with a
    single-emission reduction op, wrapping mod 2^32: ``(N,)`` int32.

    ADD sums in int64 and wraps; SUB is ``acc - sum(x)``. torch has no
    wrapping product or bitwise reduction, so MUL/AND/OR/XOR fold by
    halving (pad to a power of two with the identity, combine halves)."""
    acc = torch.full((x.shape[0],), acc_init, dtype=I32, device=x.device)
    if op in (AluOp.ADD, AluOp.SUB):
        total = x.to(I64).sum(dim=1)
        return wrap32(acc.to(I64) + total if op == AluOp.ADD
                      else acc.to(I64) - total)
    width = 1
    while width < x.shape[1]:
        width *= 2
    if width != x.shape[1]:
        pad = torch.full((x.shape[0], width - x.shape[1]), IDENTITY[op],
                         dtype=I32, device=x.device)
        x = torch.cat([x, pad], dim=1)
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = dfg_node_eval(op, x[:, :h], x[:, h:])
    if x.shape[1] == 1:
        acc = dfg_node_eval(op, acc, x[:, 0])
    return acc
