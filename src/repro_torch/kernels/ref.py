"""Plain PyTorch versions of the port's kernels (counterpart of
``repro.kernels.ref``).

These define *what* the CUDA sources in ``csrc/`` compute. The CPU tests
run them, the kernel wrappers take them for tensors that lie on the CPU,
and ``chip_smoke.py`` holds each CUDA kernel against them on the card.

int32 semantics follow the reference exactly: arithmetic wraps mod 2^32
(computed in int64 and wrapped back, since signed overflow is not
something to lean on), shift counts are masked with ``& 31``, SHR is
arithmetic, and CMP tests the *wrapped* difference ``a - b``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


# ---------------------------------------------------------------------------
# stream_matmul / stream_conv2d / flash_attention (float kernels)
# ---------------------------------------------------------------------------

def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A @ B`` in float32: bfloat16 inputs are upcast first, as
    ``preferred_element_type=float32`` accumulates them. On the card this
    is a full float32 product only while TF32 is off for matmuls (PyTorch's
    default)."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def conv2d_3x3(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """'valid' 3x3 correlation in float32, (H, W) -> (H-2, W-2): the nine
    shifted-slice products summed in row-major tap order. Not
    ``F.conv2d``, which cuDNN runs in TF32 by default."""
    H, W = img.shape
    x = img.to(torch.float32)
    k = kern.to(torch.float32)
    out = torch.zeros((H - 2, W - 2), dtype=torch.float32, device=img.device)
    for r in range(3):
        for c in range(3):
            out = out + k[r, c] * x[r:H - 2 + r, c:W - 2 + c]
    return out


def _attention_logits(q: torch.Tensor, k: torch.Tensor, causal: bool,
                      scale: Optional[float]) -> Tuple[torch.Tensor, float]:
    """Scaled float32 scores ``(h, sq, sk)``, masked entries at -inf (the
    causal mask aligned to the end of the keys), and the scale."""
    h, sq, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("hqd,hkd->hqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        logits = logits.masked_fill(~mask, float("-inf"))
    return logits, scale


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over ``(heads, seq, head_dim)`` with the kv heads already
    broadcast, in float32, returned in q's dtype. The causal mask is
    aligned to the end of the keys, ``tril(diagonal=sk - sq)``; SDPA's
    ``is_causal`` aligns it to the start instead, which differs whenever
    ``sq != sk``."""
    logits, _ = _attention_logits(q, k, causal, scale)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("hqk,hkd->hqd", probs,
                        v.to(torch.float32)).to(q.dtype)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention`'s output and each row's float32
    log-sum-exp of the scaled, masked scores ``(h, sq)`` in natural-log
    units: what the forward kernel saves for the backward."""
    logits, _ = _attention_logits(q, k, causal, scale)
    out = torch.einsum("hqk,hkd->hqd", torch.softmax(logits, dim=-1),
                       v.to(torch.float32))
    return out.to(q.dtype), torch.logsumexp(logits, dim=-1)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             causal: bool = True,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """dq, dk, dv (float32) of :func:`flash_attention` by the explicit
    formulas the backward kernels compute, from the forward's ``o`` and
    ``lse``: P = exp(S scale - lse) with masked entries 0, D =
    rowsum(dO o O), dV = P^T dO, dS = P o (dO V^T - D), dQ = dS K scale,
    dK = dS^T Q scale."""
    f32 = torch.float32
    logits, scale = _attention_logits(q, k, causal, scale)
    p = torch.exp(logits - lse[..., None])          # exp(-inf) = 0: masked
    dof, qf, kf, vf = do.to(f32), q.to(f32), k.to(f32), v.to(f32)
    delta = (dof * o.to(f32)).sum(-1)
    dv = torch.einsum("hqk,hqd->hkd", p, dof)
    ds = p * (torch.einsum("hqd,hkd->hqk", dof, vf) - delta[..., None])
    dq = torch.einsum("hqk,hkd->hqd", ds, kf) * scale
    dk = torch.einsum("hqk,hqd->hkd", ds, qf) * scale
    return dq, dk, dv
