"""Trace torch functions into STRELA DFGs (the port's compiler frontend;
counterpart of ``repro.frontend.tracer``).

A kernel is an ordinary Python function over int32 tensors::

    def relu(x):
        return torch.where(x > 0, x, 0)

``trace(relu, length=N)`` runs ``make_fx`` over fake ``(N,)``-shaped int32
tensors and lowers the resulting aten graph node by node onto the
``core.dfg`` IR, through the same ``Lowerer`` discipline as the reference:

  * ``add/sub/mul/rsub/neg/pow``, shifts, ``bitwise_and/or/xor``
                                                -> ALU nodes
  * ``gt/lt/ge/le/eq/ne``                       -> CMP nodes (+ XOR-1 inverts)
  * ``where`` / ``maximum/minimum`` / ``clamp`` -> CMP + if/else MUX
  * Python scalars, ``scalar_tensor``, ``full``/``zeros`` and captured
    0-d tensors                                 -> folded PE constants
  * ``sum`` / ``prod`` / ``dot``                -> accumulator ALUs
    (see patterns.py)
  * two-way ``torch.cond``                      -> BRANCH/MERGE pairs
  * ``while_loop``                              -> gated Branch/Merge loops
    with recirculation back edges (see patterns.py)
  * ``scan`` over the stream                    -> loop-carried back-edge
    recurrences (see patterns.py)

Anything else raises :class:`UnsupportedPrimitiveError` naming the aten op
and the graph node. Constant placement honours the hardware: a PE holds one
constant on operand *b*; constants on the left of non-commutative ops are
rewritten (``c - x`` becomes ``x * -1 + c``). Values are int32 mod 2^32
throughout: torch widens an int32 ``sum``/``prod`` to int64, and the fabric
result equals it wrapped to int32.

Two tracing modes share all of the lowering code:

  * **stream mode** (default): fake tensors are ``(length,)`` int32 —
    elementwise ops and whole-stream reductions appear naturally;
  * **element mode**: fake tensors are 0-d — required for ``torch.cond`` and
    ``while_loop`` (their predicates must be single-element), at the cost of
    reductions. ``mode="auto"`` retries in element mode when, and only
    when, stream-mode tracing dies on such a non-scalar predicate.
"""
from __future__ import annotations

import dataclasses
import inspect
import operator
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import dfg as D
from repro_torch.core.executor import wrap32
from repro_torch.core.isa import AluOp, CmpOp


class FrontendError(Exception):
    """A traced function cannot be lowered onto the fabric."""


class UnsupportedPrimitiveError(FrontendError):
    """An aten graph node uses an op the fabric has no lowering for."""


@dataclasses.dataclass(frozen=True)
class Wire:
    """A value carried on a DFG signal: (producer node, output port)."""

    node: str
    port: str = "out"


@dataclasses.dataclass(frozen=True)
class FinalWire(Wire):
    """A scan's final carry: the producer emits every element but only the
    *last* token is the value (OMN last-value mode). Valid only as a kernel
    output; joining it with a stream elementwise is rejected at trace time."""


@dataclasses.dataclass(frozen=True)
class ConstVal:
    """A compile-time scalar constant (folds into a PE constant)."""

    value: int


@dataclasses.dataclass(frozen=True, eq=False)
class ConstArr:
    """A compile-time constant with a shape (a captured tensor, ``arange``):
    usable only where it is consumed whole at trace time (the ``xs`` of a
    static-trip ``scan``); it never becomes a PE constant."""

    value: np.ndarray


Value = Union[Wire, ConstVal, ConstArr]

_COMMUTATIVE = {AluOp.ADD, AluOp.MUL, AluOp.AND, AluOp.OR, AluOp.XOR}

_SUPPORTED_NOTE = (
    "the STRELA fabric lowers int32 add/sub/mul/shift/bitwise ALU ops, "
    "eqz/gtz comparisons, where/maximum/minimum/clamp muxes, full-stream "
    "sum/prod reductions, 1-D dot products, two-way torch.cond, "
    "data-dependent while_loop, and whole-stream scan recurrences")

# the errors torch raises for a non-scalar predicate of torch.cond or
# while_loop: in auto mode (and only for these) the trace retries per element
_SCALAR_PRED = re.compile(
    r"Expected pred to be bool or single-element tensor"
    r"|cond_fn to return a (boolean )?scalar tensor")


def _fold(x) -> int:
    return int(np.asarray(wrap32(x)).reshape(()))


def _op_name(node) -> str:
    """``aten.add.Tensor`` for an aten node, the operator's name for a
    higher-order op (``cond``, ``while_loop``, ``scan``)."""
    t = node.target
    if hasattr(t, "overloadpacket"):
        return str(t)
    return getattr(t, "__name__", str(t))


def _node_str(node) -> str:
    s = f"{node.name} = {_op_name(node)}{tuple(node.args)!r}"
    s = " ".join(s.split())
    return s if len(s) <= 200 else s[:197] + "..."


def _shape(node) -> Tuple[int, ...]:
    val = node.meta.get("val") if hasattr(node, "meta") else None
    return tuple(int(d) for d in getattr(val, "shape", ()))


class Lowerer:
    """Lowers one aten graph (plus nested subgraphs) into a DFGBuilder."""

    def __init__(self, name: str, length: int):
        self.name = name
        self.length = length
        self.b = D.DFG.build(name)
        self._counters: Dict[str, int] = {}
        # token rate per node: 1 = one token per stream element (full rate),
        # 0 = reduced (an accumulator emission). Joining the two starves the
        # elastic join in hardware, so it is rejected at trace time.
        self._rate: Dict[str, int] = {}

    def _join_rate(self, wires: Sequence[Optional[Wire]]) -> int:
        for w in wires:
            if isinstance(w, FinalWire):
                raise FrontendError(
                    f"{self.name}: a scan's final carry is a single "
                    f"end-of-stream value; it can only be returned as a "
                    f"kernel output, not consumed elementwise (re-using it "
                    f"needs a multi-shot plan with a re-armed PE constant)")
        rates = {self._rate.get(w.node, 1) for w in wires if w is not None}
        if len(rates) > 1:
            raise FrontendError(
                f"{self.name}: cannot join a reduction output (a single "
                f"emitted token) with a full-rate stream elementwise; "
                f"re-broadcasting a computed scalar needs a multi-shot plan "
                f"with a re-armed PE constant")
        return rates.pop() if rates else 1

    # -- naming / env helpers ----------------------------------------------
    def fresh(self, stem: str) -> str:
        k = self._counters.get(stem, 0)
        self._counters[stem] = k + 1
        return f"{stem}{k}"

    def unsupported(self, node, why: Optional[str] = None) -> FrontendError:
        detail = f" ({why})" if why else ""
        return UnsupportedPrimitiveError(
            f"{self.name}: cannot lower op '{_op_name(node)}'{detail} in "
            f"node `{_node_str(node)}`; {_SUPPORTED_NOTE}")

    def value_of(self, arg, env: Dict[Any, Any]):
        """An fx argument as a lowering value: graph nodes from ``env``,
        Python ints/bools as constants, containers element by element."""
        if isinstance(arg, (list, tuple)):
            return type(arg)(self.value_of(a, env) for a in arg)
        if arg is None or isinstance(arg, str):
            return arg
        if isinstance(arg, (bool, int, np.integer)):
            return ConstVal(_fold(int(arg)))
        if hasattr(arg, "op") and hasattr(arg, "target"):       # fx Node
            return env[arg]
        if isinstance(arg, float):
            raise FrontendError(
                f"{self.name}: floating-point constant {arg}; the fabric "
                f"computes int32")
        return arg                       # dtypes, devices, layouts, ...

    # -- node emission ------------------------------------------------------
    def emit_alu(self, op: AluOp, a: Wire, b: Optional[Wire] = None,
                 const_b: Optional[int] = None, *, stem: Optional[str] = None,
                 acc_init: Optional[int] = None, emit_every: int = 1) -> Wire:
        name = self.fresh(stem or op.name.lower())
        rate = self._join_rate([a, b])
        self.b.alu(name, op, a.node, b.node if b is not None else None,
                   const_b=const_b, acc_init=acc_init, emit_every=emit_every,
                   a_port=a.port, b_port=b.port if b is not None else "out")
        self._rate[name] = 0 if (acc_init is not None
                                 and emit_every != 1) else rate
        return Wire(name)

    def emit_cmp(self, op: CmpOp, a: Wire, b: Optional[Wire] = None,
                 const_b: Optional[int] = None) -> Wire:
        name = self.fresh("cmp")
        self._rate[name] = self._join_rate([a, b])
        self.b.cmp(name, op, a.node, b.node if b is not None else None,
                   const_b=const_b, a_port=a.port,
                   b_port=b.port if b is not None else "out")
        return Wire(name)

    def emit_mux(self, a: Wire, b: Optional[Wire], ctrl: Wire,
                 const_b: Optional[int] = None) -> Wire:
        name = self.fresh("mux")
        self._rate[name] = self._join_rate([a, b, ctrl])
        self.b.mux(name, a.node, b.node if b is not None else None, ctrl.node,
                   a_port=a.port, b_port=b.port if b is not None else "out",
                   ctrl_port=ctrl.port)
        if b is None:
            self.b.nodes[name].value = const_b
        return Wire(name)

    # -- arithmetic with constant discipline --------------------------------
    def alu(self, op: AluOp, a: Value, b: Value) -> Value:
        """Lower ``op(a, b)`` folding/commuting constants onto operand b."""
        from repro_torch.core.executor import alu_eval
        if isinstance(a, ConstVal) and isinstance(b, ConstVal):
            return ConstVal(_fold(alu_eval(op, a.value, b.value)))
        if isinstance(b, ConstVal):
            return self.emit_alu(op, a, const_b=b.value)
        if isinstance(a, ConstVal):
            if op in _COMMUTATIVE:
                return self.emit_alu(op, b, const_b=a.value)
            if op == AluOp.SUB:
                # c - x  ->  x * -1 (+ c unless c == 0): the PE constant
                # lives on operand b, so the left-constant form is rewritten.
                neg = self.emit_alu(AluOp.MUL, b, const_b=_fold(-1))
                if a.value == 0:
                    return neg
                return self.emit_alu(AluOp.ADD, neg, const_b=a.value)
            raise FrontendError(
                f"{self.name}: constant on the left of non-commutative "
                f"{op.name} is not expressible as a PE constant")
        return self.emit_alu(op, a, b)

    def lnot(self, v: Value) -> Value:
        """Logical not of a 0/1 value (comparator output)."""
        if isinstance(v, ConstVal):
            return ConstVal(0 if v.value else 1)
        return self.emit_alu(AluOp.XOR, v, const_b=1, stem="not")

    def gtz(self, a: Value, b: Value) -> Value:
        """a > b as a CMP node (GTZ over a - b)."""
        if isinstance(a, ConstVal) and isinstance(b, ConstVal):
            return ConstVal(int(a.value > b.value))
        if isinstance(a, Wire) and isinstance(b, ConstVal):
            if b.value == 0:
                return self.emit_cmp(CmpOp.GTZ, a)
            return self.emit_cmp(CmpOp.GTZ, a, const_b=b.value)
        if isinstance(a, Wire) and isinstance(b, Wire):
            return self.emit_cmp(CmpOp.GTZ, a, b)
        # const > wire: compare the rewritten difference directly
        diff = self.alu(AluOp.SUB, a, b)
        return self.emit_cmp(CmpOp.GTZ, diff)

    def eqz(self, a: Value, b: Value) -> Value:
        if isinstance(a, ConstVal) and isinstance(b, ConstVal):
            return ConstVal(int(a.value == b.value))
        if isinstance(a, ConstVal):
            a, b = b, a
        if isinstance(b, ConstVal):
            if b.value == 0:
                return self.emit_cmp(CmpOp.EQZ, a)
            return self.emit_cmp(CmpOp.EQZ, a, const_b=b.value)
        return self.emit_cmp(CmpOp.EQZ, a, b)

    def select(self, pred: Value, on_false: Value, on_true: Value) -> Value:
        """if/else mux: ``pred ? on_true : on_false``."""
        if isinstance(pred, ConstVal):
            return on_true if pred.value else on_false
        if isinstance(on_true, Wire):
            if isinstance(on_false, Wire):
                return self.emit_mux(on_true, on_false, pred)
            return self.emit_mux(on_true, None, pred, const_b=on_false.value)
        if isinstance(on_false, Wire):
            # true case is the constant: invert the predicate so the wire
            # rides the mux's a input and the constant folds onto b.
            inv = self.lnot(pred)
            return self.emit_mux(on_false, None, inv, const_b=on_true.value)
        # both cases constant:  f + pred * (t - f)
        span = _fold(on_true.value - on_false.value)
        scaled = self.alu(AluOp.MUL, pred, ConstVal(span))
        return self.alu(AluOp.ADD, scaled, ConstVal(on_false.value))

    def maximum(self, a: Value, b: Value) -> Value:
        if isinstance(a, ConstVal) and isinstance(b, ConstVal):
            return ConstVal(max(a.value, b.value))
        if isinstance(a, ConstVal):
            a, b = b, a
        c = self.gtz(a, b)
        return self.select(c, b, a)

    def minimum(self, a: Value, b: Value) -> Value:
        if isinstance(a, ConstVal) and isinstance(b, ConstVal):
            return ConstVal(min(a.value, b.value))
        if isinstance(a, ConstVal):
            a, b = b, a
        c = self.gtz(a, b)
        return self.select(c, a, b)

    def paced_const(self, pace: Wire, value: int) -> Wire:
        """A constant token stream paced by ``pace`` (one token out per token
        in): x*0 + c. Needed when a torch.cond branch returns a constant."""
        zero = self.emit_alu(AluOp.MUL, pace, const_b=0, stem="pace")
        if value == 0:
            return zero
        return self.emit_alu(AluOp.ADD, zero, const_b=_fold(value))

    # -- graph walking ------------------------------------------------------
    def lower_graph(self, gm, args: Sequence[Value]) -> List[Value]:
        """Lower the fx ``GraphModule`` ``gm`` with its placeholders bound
        to ``args``; returns the flattened output values."""
        env: Dict[Any, Any] = {}
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        if len(placeholders) != len(args):
            raise FrontendError(
                f"{self.name}: graph takes {len(placeholders)} inputs, "
                f"{len(args)} given")
        env.update(zip(placeholders, args))
        for node in gm.graph.nodes:
            if node.op == "get_attr":
                env[node] = self._attr(gm, node)
            elif node.op == "call_function":
                env[node] = self.lower_node(node, env)
            elif node.op == "output":
                (out,) = node.args
                outs = out if isinstance(out, (list, tuple)) else (out,)
                return [self.value_of(o, env) for o in outs]
            elif node.op != "placeholder":
                raise self.unsupported(node, f"fx node kind {node.op!r}")
        raise FrontendError(f"{self.name}: graph has no output")

    def _attr(self, gm, node):
        """A ``get_attr``: a subgraph module (of a higher-order op) or a
        captured tensor constant."""
        obj = gm
        for part in node.target.split("."):
            obj = getattr(obj, part)
        if isinstance(obj, torch.Tensor):
            return const_of_tensor(self, obj)
        return obj

    def lower_node(self, node, env: Dict[Any, Any]):
        if node.target is operator.getitem:
            seq, idx = node.args
            return env[seq][idx]
        val = node.meta.get("val")
        if getattr(val, "dtype", None) is not None and \
                val.dtype.is_floating_point:
            raise self.unsupported(node, f"{val.dtype} result; the fabric "
                                         f"computes int32")
        key = _op_name(node)
        packet = key.split(".")[1] if key.startswith("aten.") else key
        handler = _HANDLERS.get(packet)
        if handler is None:
            from repro_torch.frontend import patterns
            handler = patterns.PATTERN_HANDLERS.get(packet)
        if handler is None:
            raise self.unsupported(node)
        ins = [self.value_of(a, env) for a in node.args]
        kw = {k: self.value_of(v, env) for k, v in node.kwargs.items()}
        if handler not in _TAKES_ARRAYS:
            for v in ins:
                if isinstance(v, ConstArr):
                    raise FrontendError(
                        f"{self.name}: captured non-scalar constant of shape "
                        f"{v.value.shape} in node `{_node_str(node)}`; only "
                        f"scalar closure constants fold into PE constants")
        return handler(self, node, ins, kw)

    # -- graph finishing ----------------------------------------------------
    def finish(self, out_vals: Sequence[Value],
               input_names: Sequence[str]) -> D.DFG:
        for i, val in enumerate(out_vals):
            if not isinstance(val, Wire):
                raise FrontendError(
                    f"{self.name}: output {i} is the compile-time constant "
                    f"{getattr(val, 'value', val)}; a kernel output must "
                    f"depend on a stream")
            self.b.out(f"out{i}", val.node, src_port=val.port)
            if isinstance(val, FinalWire):
                # scan final carry: OMN stores the last value (stride-0)
                self.b.nodes[f"out{i}"].emit_every = 0
        self._prune(input_names)
        return self.b.done()

    def _prune(self, input_names: Sequence[str]) -> None:
        """Drop nodes with no path to an OUTPUT (dead graph code)."""
        b = self.b
        live = set(b.outputs)
        stack = list(b.outputs)
        rev: Dict[str, List[str]] = {}
        for e in b.edges:
            rev.setdefault(e.dst, []).append(e.src)
        while stack:
            n = stack.pop()
            for p in rev.get(n, ()):
                if p not in live:
                    live.add(p)
                    stack.append(p)
        dead_inputs = [n for n in input_names if n not in live]
        if dead_inputs:
            raise FrontendError(
                f"{self.name}: stream input(s) {dead_inputs} are never used "
                f"by the function; every IMN stream must reach an output")
        b.nodes = {n: nd for n, nd in b.nodes.items() if n in live}
        b.edges = [e for e in b.edges if e.src in live and e.dst in live]


def const_of_tensor(lw: Lowerer, t) -> Value:
    """A captured tensor: a 0-d one folds into a PE constant, any other
    stays a :class:`ConstArr`."""
    arr = t.detach().cpu().numpy()
    if arr.dtype.kind == "f":
        raise FrontendError(f"{lw.name}: captured floating-point tensor; "
                            f"the fabric computes int32")
    if arr.ndim == 0:
        return ConstVal(_fold(arr.astype(np.int64)))
    return ConstArr(arr.astype(np.int64))


# ---------------------------------------------------------------------------
# elementwise handlers: handler(lowerer, node, ins, kwargs) -> value
# ---------------------------------------------------------------------------

def _scaled(lw: Lowerer, v: Value, kw) -> Value:
    alpha = kw.get("alpha")
    if alpha is None or (isinstance(alpha, ConstVal) and alpha.value == 1):
        return v
    return lw.alu(AluOp.MUL, v, alpha)


def _h_add(lw, node, ins, kw):
    return lw.alu(AluOp.ADD, ins[0], _scaled(lw, ins[1], kw))


def _h_sub(lw, node, ins, kw):
    return lw.alu(AluOp.SUB, ins[0], _scaled(lw, ins[1], kw))


def _h_rsub(lw, node, ins, kw):
    return lw.alu(AluOp.SUB, ins[1], _scaled(lw, ins[0], kw))


def _simple_alu(op: AluOp):
    def h(lw, node, ins, kw):
        return lw.alu(op, ins[0], ins[1])
    return h


def _h_shift(op: AluOp):
    def h(lw, node, ins, kw):
        a, b = ins[0], ins[1]
        if isinstance(a, ConstVal) and isinstance(b, Wire):
            raise lw.unsupported(node, "constant shifted by a stream")
        return lw.alu(op, a, b)
    return h


def _h_neg(lw, node, ins, kw):
    return lw.alu(AluOp.MUL, ins[0], ConstVal(_fold(-1)))


def _h_pow(lw, node, ins, kw):
    x, y = ins[0], ins[1]
    if not isinstance(y, ConstVal):
        raise lw.unsupported(node, "exponent is a stream")
    if y.value < 1 or y.value > 8:
        raise lw.unsupported(node, f"exponent {y.value} out of the unrolled "
                                   f"range")
    acc = x
    for _ in range(y.value - 1):
        acc = lw.alu(AluOp.MUL, acc, x)
    return acc


def _h_gt(lw, node, ins, kw):
    return lw.gtz(ins[0], ins[1])


def _h_lt(lw, node, ins, kw):
    return lw.gtz(ins[1], ins[0])


def _h_ge(lw, node, ins, kw):
    return lw.lnot(lw.gtz(ins[1], ins[0]))


def _h_le(lw, node, ins, kw):
    return lw.lnot(lw.gtz(ins[0], ins[1]))


def _h_eq(lw, node, ins, kw):
    return lw.eqz(ins[0], ins[1])


def _h_ne(lw, node, ins, kw):
    return lw.lnot(lw.eqz(ins[0], ins[1]))


def _h_where(lw, node, ins, kw):
    pred, on_true, on_false = ins
    return lw.select(pred, on_false, on_true)


def _h_max(lw, node, ins, kw):
    return lw.maximum(ins[0], ins[1])


def _h_min(lw, node, ins, kw):
    return lw.minimum(ins[0], ins[1])


def _h_relu(lw, node, ins, kw):
    return lw.maximum(ins[0], ConstVal(0))


def _h_clamp(lw, node, ins, kw):
    x = ins[0]
    lo = ins[1] if len(ins) > 1 else kw.get("min")
    hi = ins[2] if len(ins) > 2 else kw.get("max")
    if lo is not None:
        x = lw.maximum(x, lo)
    if hi is not None:
        x = lw.minimum(x, hi)
    return x


def _h_clamp_min(lw, node, ins, kw):
    return lw.maximum(ins[0], ins[1])


def _h_clamp_max(lw, node, ins, kw):
    return lw.minimum(ins[0], ins[1])


def _h_alias(lw, node, ins, kw):
    return ins[0]


def _h_to_copy(lw, node, ins, kw):
    """dtype casts: int32 <-> int64 and bool -> int are exact mod 2^32;
    int -> bool is ``x != 0``; narrower integers and floats do not lower."""
    v = ins[0]
    dst = kw.get("dtype")
    src = getattr(node.args[0].meta.get("val"), "dtype", None) \
        if hasattr(node.args[0], "meta") else None
    if dst is None or dst in (torch.int32, torch.int64) or dst == src:
        return v
    if dst is torch.bool:
        return lw.lnot(lw.eqz(v, ConstVal(0)))
    raise lw.unsupported(node, f"cast to {dst}; the fabric computes int32")


def _h_view(lw, node, ins, kw):
    """view/reshape/expand: a value keeps its elements; a runtime value is
    never re-broadcast to more elements."""
    v = ins[0]
    if isinstance(v, ConstVal):
        return v
    src, dst = _shape(node.args[0]), _shape(node)
    if int(np.prod(src)) == int(np.prod(dst)):
        return v
    raise lw.unsupported(
        node, f"broadcast of a runtime value from {src} to {dst} "
              f"(re-broadcasting a computed scalar needs a multi-shot plan "
              f"with a re-armed PE constant)")


def _fill(lw, node, value) -> ConstVal:
    if not isinstance(value, ConstVal):
        raise lw.unsupported(node, "fill value is not a compile-time int")
    return value


def _h_full(lw, node, ins, kw):          # full(size, v) / full_like(x, v)
    return _fill(lw, node, ins[1])


def _h_zeros(lw, node, ins, kw):
    return ConstVal(0)


def _h_scalar_tensor(lw, node, ins, kw):
    return _fill(lw, node, ins[0])


def _h_arange(lw, node, ins, kw):
    bounds = [v.value for v in ins if isinstance(v, ConstVal)]
    if len(bounds) != len(ins):
        raise lw.unsupported(node, "arange bounds are not compile-time ints")
    return ConstArr(np.arange(*bounds, dtype=np.int64))


def _h_reverse(lw, node, ins, kw):
    raise lw.unsupported(
        node, "reversed stream, as in a reverse scan; IMN streams only "
              "ascend (negative strides would need a reversed stream copy)")


_HANDLERS: Dict[str, Callable] = {
    "add": _h_add,
    "sub": _h_sub,
    "rsub": _h_rsub,
    "mul": _simple_alu(AluOp.MUL),
    "bitwise_and": _simple_alu(AluOp.AND),
    "bitwise_or": _simple_alu(AluOp.OR),
    "bitwise_xor": _simple_alu(AluOp.XOR),
    "__lshift__": _h_shift(AluOp.SHL),
    "bitwise_left_shift": _h_shift(AluOp.SHL),
    # >> on int32 is arithmetic in torch, as shift_right_arithmetic is
    "__rshift__": _h_shift(AluOp.SHR),
    "bitwise_right_shift": _h_shift(AluOp.SHR),
    "neg": _h_neg,
    "pow": _h_pow,
    "gt": _h_gt,
    "lt": _h_lt,
    "ge": _h_ge,
    "le": _h_le,
    "eq": _h_eq,
    "ne": _h_ne,
    "where": _h_where,
    "maximum": _h_max,
    "minimum": _h_min,
    "relu": _h_relu,
    "clamp": _h_clamp,
    "clamp_min": _h_clamp_min,
    "clamp_max": _h_clamp_max,
    "_to_copy": _h_to_copy,
    "clone": _h_alias,
    "alias": _h_alias,
    "lift_fresh_copy": _h_alias,
    "view": _h_view,
    "expand": _h_view,
    "full": _h_full,
    "full_like": _h_full,
    "zeros": _h_zeros,
    "zeros_like": _h_zeros,
    "scalar_tensor": _h_scalar_tensor,
    "arange": _h_arange,
    "flip": _h_reverse,
}

# handlers that pass a non-scalar constant on (a captured tensor's copy)
_TAKES_ARRAYS = {_h_alias}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def arg_names_of(fn: Callable, kname: str) -> List[str]:
    try:
        params = [p for p in inspect.signature(fn).parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    except (TypeError, ValueError):
        raise FrontendError(f"{kname}: cannot inspect function signature")
    if not params:
        raise FrontendError(f"{kname}: kernel takes no stream arguments")
    return [p.name for p in params]


@dataclasses.dataclass
class TracedGraph:
    """``make_fx``'s graph of ``fn`` over fake int32 tensors, with the
    pytree spec of ``fn``'s result (the graph returns its flat leaves)."""

    gm: Any
    treedef: Any
    element_mode: bool

    def out_shapes(self, length: int) -> List[Tuple[int, ...]]:
        """Run-time shape of each output leaf: an element-mode graph
        describes one stream element, so each of its outputs is a full
        stream of ``length``."""
        out = [n for n in self.gm.graph.nodes if n.op == "output"][0]
        leaves = out.args[0]
        if self.element_mode:
            return [(length,)] * len(leaves)
        return [_shape(n) if hasattr(n, "meta") else () for n in leaves]


def make_graph(fn: Callable, length: int, n_args: int,
               mode: str = "auto") -> TracedGraph:
    """Trace ``fn`` with ``make_fx`` in ``mode`` ("stream" | "element" |
    "auto"), mirroring the lowering's mode resolution."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils import _pytree as pytree

    if mode not in ("auto", "stream", "element"):
        raise ValueError(f"bad trace mode {mode!r}")
    spec: Dict[str, Any] = {}

    def flat(*args):
        leaves, spec["treedef"] = pytree.tree_flatten(fn(*args))
        return tuple(leaves)

    def run(shape):
        args = [torch.zeros(shape, dtype=torch.int32) for _ in range(n_args)]
        return make_fx(flat, tracing_mode="fake",
                       _allow_non_fake_inputs=True)(*args)

    if mode in ("auto", "stream"):
        try:
            return TracedGraph(run((length,)), spec["treedef"], False)
        except RuntimeError as e:
            # torch.cond / while_loop demand a single-element predicate; in
            # auto mode retry the per-element trace, which lowers them to
            # Branch/Merge. Any other error is the function's own.
            if mode == "stream" or not _SCALAR_PRED.search(str(e)):
                raise
    return TracedGraph(run(()), spec["treedef"], True)


def lower(tg: TracedGraph, length: int, name: str,
          arg_names: Sequence[str]) -> D.DFG:
    lw = Lowerer(name, length)
    args: List[Value] = []
    for aname in arg_names:
        lw.b.inp(aname)
        args.append(Wire(aname))
    outs = lw.lower_graph(tg.gm, args)
    return lw.finish(outs, arg_names)


def trace(fn: Callable, length: int, *, name: Optional[str] = None,
          mode: str = "auto") -> D.DFG:
    """Trace ``fn`` over int32 streams of ``length`` into a validated DFG.

    ``mode``: "stream" traces over ``(length,)`` tensors (reductions work),
    "element" over 0-d tensors (``torch.cond`` and ``while_loop`` work),
    "auto" tries stream and falls back to element when tracing fails on a
    non-scalar predicate. Raises :class:`UnsupportedPrimitiveError` (with the
    offending node) or :class:`FrontendError` for structural problems.
    """
    kname = name or getattr(fn, "__name__", "traced")
    arg_names = arg_names_of(fn, kname)
    tg = make_graph(fn, length, len(arg_names), mode)
    return lower(tg, length, kname, arg_names)
