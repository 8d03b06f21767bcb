"""Benchmark DFGs from the paper (Sec. VI-B, Figs. 5 and 7).

One-shot kernels:
  * ``fft``       — radix-2 butterfly (data-driven, 10 arith ops / 4 inputs)
  * ``relu``      — max(x, 0) via comparator + if/else mux (Fig. 5 right)
  * ``dither``    — 1-D threshold dither with error feedback (loop-carried)
  * ``find2min``  — two running minima + indices (irregular loop, 4 scalars out)

Irregular-loop kernels (data-dependent trip counts, gated Branch/Merge):
  * ``div_loop``  — hand-built divmod-by-repeated-subtraction (10 FUs)
  * ``TRACED_LOOPS`` — plain-Python torch ``while_loop``/``scan`` kernels
    (div_iter / isqrt / clip_scan / gemv_early) lowered by
    ``repro_torch.frontend``

Multi-shot building blocks:
  * ``mac3``      — three dot-products at a time (Fig. 7c: 4 input vectors)
  * ``conv2d_row``— one 3-wide filter-row partial accumulation (3 shots total)
  * ``axpby``     — out = alpha*x + beta*y elementwise (gemm/gemver epilogues)
  * ``scale_add`` — out = alpha*x + y
  * ``mac1``      — single dot-product (gemver/gesummv matvec rows)
  * ``outer_row`` — a_row + u1_i*v1 + u2_i*v2 (gemver phase-1 row update)

All integer 32-bit, matching the embedded-domain datapath of Sec. III-C.
"""
from __future__ import annotations

from repro_torch.core.dfg import DFG
from repro_torch.core.isa import AluOp, CmpOp

Q = 15  # fixed-point fraction bits used by the fft twiddles


def fft_butterfly(wr: int = 23170, wi: int = -23170) -> DFG:
    """Radix-2 DIT butterfly: (a, b) -> (a + w*b, a - w*b), complex.

    4 inputs (ar, ai, br, bi), 4 outputs, 10 arithmetic ops — the paper's
    op-count example ('ten arithmetic operations ... every four inputs').
    Twiddle (wr, wi) is Q15 fixed-point, folded as PE constants.
    """
    b = DFG.build("fft")
    ar, ai = b.inp("ar"), b.inp("ai")
    br, bi = b.inp("br"), b.inp("bi")
    t1 = b.alu("t1", AluOp.MUL, br, const_b=wr)
    t2 = b.alu("t2", AluOp.MUL, bi, const_b=wi)
    t3 = b.alu("t3", AluOp.MUL, br, const_b=wi)
    t4 = b.alu("t4", AluOp.MUL, bi, const_b=wr)
    tr = b.alu("tr", AluOp.SUB, t1, t2)
    ti = b.alu("ti", AluOp.ADD, t3, t4)
    or0 = b.alu("or0", AluOp.ADD, ar, tr)
    oi0 = b.alu("oi0", AluOp.ADD, ai, ti)
    or1 = b.alu("or1", AluOp.SUB, ar, tr)
    oi1 = b.alu("oi1", AluOp.SUB, ai, ti)
    b.out("out_or0", or0)
    b.out("out_oi0", oi0)
    b.out("out_or1", or1)
    b.out("out_oi1", oi1)
    return b.done()


def relu() -> DFG:
    """ReLU (Fig. 5 right): c = x > 0; out = c ? x : 0."""
    b = DFG.build("relu")
    x = b.inp("x")
    c = b.cmp("c", CmpOp.GTZ, x)
    o = b.mux("o", x, None, c)               # b-operand is the PE const 0
    b.nodes["o"].value = 0
    b.out("out", o)
    return b.done()


def dither(threshold: int = 127, white: int = 255) -> DFG:
    """1-D threshold dither with full error diffusion (one-shot, control).

    v = x + err ; c = (v - T) > 0 ; out = c * WHITE ; err' = v - out.
    The err' -> v edge is a loop-carried (non-immediate) feedback loop —
    exactly the irregular-loop pattern Sec. III-C adds Branch/Merge logic
    for. The 4-FU feedback loop gives the paper's II = 4 (Sec. VII-B).
    """
    b = DFG.build("dither")
    x = b.inp("x")
    v = b.alu("v", AluOp.ADD, x, None)               # b comes from back edge
    c = b.cmp("c", CmpOp.GTZ, v, const_b=threshold)  # (v - T) > 0
    o = b.alu("o", AluOp.MUL, c, const_b=white)
    e = b.alu("e", AluOp.SUB, v, o)
    b.back_edge(e, v, "b", init=0)
    b.out("out", o)
    return b.done()


INT_MAX = (1 << 31) - 1


def find2min() -> DFG:
    """Two smallest values and their indices (irregular loop, Sec. VI-B).

    Loop-carried state: m1, m2 (running minima), i1, i2 (indices), idx
    (position counter, an immediate-feedback accumulator). Four scalar
    outputs drained once at the end of the stream (OMN stride-0 'last value'
    mode). 9 enabled FUs per element — Table I's 9216 ops / 1024 elements.
    """
    b = DFG.build("find2min")
    x = b.inp("x")
    # position counter: idx = idx_prev + 1, starting at 0.  Accumulators with
    # a const operand step by the const, paced by (but ignoring) operand a —
    # the hardware's data-register-init + immediate-feedback counter idiom.
    idx = b.alu("idx", AluOp.ADD, x, const_b=1, acc_init=-1, emit_every=1)
    c1 = b.cmp("c1", CmpOp.GTZ, None, x)             # m1_prev - x > 0
    m1 = b.mux("m1", x, None, c1)                    # new m1
    cand = b.mux("cand", None, x, c1)                # displaced candidate
    c2 = b.cmp("c2", CmpOp.GTZ, None, cand)          # m2_prev - cand > 0
    m2 = b.mux("m2", cand, None, c2)                 # new m2
    i1 = b.mux("i1", idx, None, c1)
    iold = b.mux("iold", None, idx, c1)              # index of cand
    i2 = b.mux("i2", iold, None, c2)
    b.back_edge(m1, c1, "a", init=INT_MAX)
    b.back_edge(m1, m1, "b", init=INT_MAX)
    b.back_edge(m1, cand, "a", init=INT_MAX)
    b.back_edge(m2, c2, "a", init=INT_MAX)
    b.back_edge(m2, m2, "b", init=INT_MAX)
    b.back_edge(i1, i1, "b", init=-1)
    b.back_edge(i1, iold, "a", init=-1)
    b.back_edge(i2, i2, "b", init=-1)
    b.out("out_m1", m1)
    b.out("out_i1", i1)
    b.out("out_m2", m2)
    b.out("out_i2", i2)
    for o in ("out_m1", "out_i1", "out_m2", "out_i2"):
        b.nodes[o].emit_every = 0                    # OMN stores last value
    return b.done()


def find2min_brmg() -> DFG:
    """Paper-faithful find2min via Branch/Merge recirculation (Fig. 5 BR/MG).

    Two cascaded dataflow-min stages, 9 enabled FUs — matching Table I's
    9 ops/element exactly: per stage, the running min recirculates through
    a Merge; a Branch pair steers the loser to the next stage.

      c1 = m1 - x > 0 ; br_x(x, c1): t -> new m1, f -> cand
      br_m(m1, c1):     t -> cand   , f -> m1 kept
      m1' = Merge(br_x.t, br_m.f) ; cand = Merge(br_m.t, br_x.f)
      (same again for m2 over cand; cand2 is discarded — empty fork mask)
    """
    b = DFG.build("find2min_brmg")
    x = b.inp("x")
    c1 = b.cmp("c1", CmpOp.GTZ, None, x)              # m1_prev - x > 0
    brx = b.branch("brx", x, c1)
    brm = b.branch("brm", None, c1)
    m1 = b.merge("m1", brx, brm, a_port="t", b_port="f")
    cand = b.merge("cand", brm, brx, a_port="t", b_port="f")
    c2 = b.cmp("c2", CmpOp.GTZ, None, cand)           # m2_prev - cand > 0
    brc = b.branch("brc", cand, c2)
    brm2 = b.branch("brm2", None, c2)
    m2 = b.merge("m2", brc, brm2, a_port="t", b_port="f")
    # brc.f / brm2.t (the overall loser) are discarded: empty fork mask.
    b.back_edge(m1, c1, "a", init=INT_MAX)
    b.back_edge(m1, brm, "a", init=INT_MAX)
    b.back_edge(m2, c2, "a", init=INT_MAX)
    b.back_edge(m2, brm2, "a", init=INT_MAX)
    b.out("out_m1", m1)
    b.out("out_m2", m2)
    for o in ("out_m1", "out_m2"):
        b.nodes[o].emit_every = 0                     # OMN stores last value
    return b.done()


def div_loop(divisor: int = 7) -> DFG:
    """Iterative division by repeated subtraction — the paper's "irregular
    loop" pattern on the gated Branch/Merge schema (Fig. 4 elastic feedback).

    Per element x (x >= 0): circulate (q, r) with r -= divisor, q += 1 while
    r >= divisor; the exit legs release (q, r) = divmod(x, divisor). The
    *gate* joins each fresh element with a demand token minted by the
    previous element's exit (initial demand token present), so exactly one
    element is in flight and OMN order is preserved. Recirculation back
    edges carry no initial token (``init=None``); the simulator terminates
    by token exhaustion since trip counts are data-dependent.
    """
    b = DFG.build("div_loop")
    x = b.inp("x")
    gate = b.alu("gate", AluOp.ADD, x, None)          # b <- demand back edge
    q0 = b.alu("q0", AluOp.MUL, gate, const_b=0)      # paced constant q=0
    mr = b.merge("mr", None, gate)                    # a <- recirculated r
    mq = b.merge("mq", None, q0)                      # a <- recirculated q
    c = b.cmp("c", CmpOp.GTZ, mr, const_b=divisor - 1)   # r >= divisor
    brr = b.branch("brr", mr, c)
    brq = b.branch("brq", mq, c)
    rn = b.alu("rn", AluOp.SUB, brr, const_b=divisor, a_port="t")
    qn = b.alu("qn", AluOp.ADD, brq, const_b=1, a_port="t")
    b.back_edge(rn, mr, "a", init=None)
    b.back_edge(qn, mq, "a", init=None)
    dem = b.alu("dem", AluOp.MUL, brq, const_b=0, a_port="f")
    b.back_edge(dem, gate, "b", init=0)
    b.out("out_q", brq, src_port="f")
    b.out("out_r", brr, src_port="f")
    return b.done()


# ---------------------------------------------------------------------------
# traced irregular-loop kernels (plain Python/torch, lowered by the frontend)
# ---------------------------------------------------------------------------

def loop_div_fn(divisor: int = 7):
    """q, r = divmod(x, divisor) for x >= 0 via a ``while_loop`` of
    repeated subtraction — a data-dependent trip count per element."""
    import torch
    from torch._higher_order_ops.while_loop import while_loop

    def div_iter(x):
        def cond(q, r):
            return r > divisor - 1

        def body(q, r):
            return q + 1, r - divisor

        return while_loop(cond, body, (torch.zeros_like(x), x))
    return div_iter


def loop_isqrt_fn():
    """Integer square root: smallest s with (s+1)^2 > x (x >= 0) — the
    stream element rides the loop as a cond-closure invariant."""
    import torch
    from torch._higher_order_ops.while_loop import while_loop

    def isqrt(x):
        def cond(s):
            return (s + 1) * (s + 1) <= x
        return while_loop(cond, lambda s: s + 1, (torch.zeros_like(x),))
    return isqrt


def clip_scan_fn(lo: int = -128, hi: int = 127):
    """Data-dependent clipping integrator: acc' = clip(acc + x, lo, hi) —
    a ``scan`` recurrence (loop-carried back edge, like dither). torch's
    scan refuses a body that returns one tensor as both carry and output,
    hence the ``clone``."""
    import torch
    from torch._higher_order_ops.scan import scan

    def clip_scan(x):
        def f(acc, xi):
            a2 = torch.clamp(acc + xi, lo, hi)
            return a2, a2.clone()
        _, ys = scan(f, torch.zeros((), dtype=torch.int32), x)
        return ys
    return clip_scan


def gemv_early_fn(threshold: int = 1 << 20):
    """Dot-product row with an early-exit threshold: accumulation freezes
    once the partial sum exceeds ``threshold`` (branchy GEMV row); the final
    carry drains through a last-value OMN. torch's scan needs a tensor
    per-step output, so the body emits the partial sum, which is unused."""
    import torch
    from torch._higher_order_ops.scan import scan

    def gemv_early(a, b):
        def f(c, ab):
            acc, done = c
            ai, bi = ab
            acc2 = torch.where(done != 0, acc, acc + ai * bi)
            done2 = done | (acc2 > threshold).to(torch.int32)
            return (acc2, done2), acc2.clone()
        zero = torch.zeros((), dtype=torch.int32)
        (acc, _), _ = scan(f, (zero, zero.clone()), (a, b))
        return acc
    return gemv_early


# name -> (python-function factory, number of input streams)
TRACED_LOOPS = {
    "div_iter": (loop_div_fn, 1),
    "isqrt": (loop_isqrt_fn, 1),
    "clip_scan": (clip_scan_fn, 1),
    "gemv_early": (gemv_early_fn, 2),
}


def mac1(vec_len: int) -> DFG:
    """Single dot-product lane: acc += a*b, emit after ``vec_len`` tokens."""
    b = DFG.build("mac1")
    a, x = b.inp("a"), b.inp("b0")
    m = b.alu("m", AluOp.MUL, a, x)
    s = b.alu("s", AluOp.ADD, m, acc_init=0, emit_every=vec_len)
    b.out("out0", s)
    return b.done()


def mac3(vec_len: int) -> DFG:
    """Fig. 7c: three simultaneous dot-products sharing the ``a`` stream.

    4 input vectors (a row + 3 B columns), 3 scalar outputs per shot.
    """
    b = DFG.build("mac3")
    a = b.inp("a")
    outs = []
    for k in range(3):
        xk = b.inp(f"b{k}")
        m = b.alu(f"m{k}", AluOp.MUL, a, xk)
        s = b.alu(f"s{k}", AluOp.ADD, m, acc_init=0, emit_every=vec_len)
        outs.append(s)
    for k, s in enumerate(outs):
        b.out(f"out{k}", s)
    return b.done()


def mac2x(vec_len: int) -> DFG:
    """gesummv row kernel: two dot-products sharing the x stream:
    d1 = sum(a*x), d2 = sum(b*x)."""
    b = DFG.build("mac2x")
    a, bb, x = b.inp("a"), b.inp("b"), b.inp("x")
    m1 = b.alu("m1", AluOp.MUL, a, x)
    s1 = b.alu("s1", AluOp.ADD, m1, acc_init=0, emit_every=vec_len)
    m2 = b.alu("m2", AluOp.MUL, bb, x)
    s2 = b.alu("s2", AluOp.ADD, m2, acc_init=0, emit_every=vec_len)
    b.out("out0", s1)
    b.out("out1", s2)
    return b.done()


def scale(alpha: int) -> DFG:
    """out = alpha * x (gemver w-epilogue)."""
    b = DFG.build("scale")
    x = b.inp("x")
    o = b.alu("o", AluOp.MUL, x, const_b=alpha)
    b.out("out", o)
    return b.done()


def conv2d_row3(k0: int, k1: int, k2: int) -> DFG:
    """First conv2d shot: no partial-sum input (initializes the plane)."""
    b = DFG.build("conv2d_row3")
    x0, x1, x2 = b.inp("x0"), b.inp("x1"), b.inp("x2")
    t0 = b.alu("t0", AluOp.MUL, x0, const_b=k0)
    t1 = b.alu("t1", AluOp.MUL, x1, const_b=k1)
    t2 = b.alu("t2", AluOp.MUL, x2, const_b=k2)
    s0 = b.alu("s0", AluOp.ADD, t0, t1)
    s1 = b.alu("s1", AluOp.ADD, s0, t2)
    b.out("pout", s1)
    return b.done()


def conv2d_row(k0: int, k1: int, k2: int) -> DFG:
    """One filter-row partial sum of a 3x3 convolution (3 shots total).

    pout = pin + k0*x0 + k1*x1 + k2*x2, with x0/x1/x2 the same image row at
    column offsets 0/1/2 (three IMN streams over the same data) and pin the
    partial-sum plane of the previous shot (memory-resident between shots).
    """
    b = DFG.build("conv2d_row")
    x0, x1, x2 = b.inp("x0"), b.inp("x1"), b.inp("x2")
    pin = b.inp("pin")
    t0 = b.alu("t0", AluOp.MUL, x0, const_b=k0)
    t1 = b.alu("t1", AluOp.MUL, x1, const_b=k1)
    t2 = b.alu("t2", AluOp.MUL, x2, const_b=k2)
    s0 = b.alu("s0", AluOp.ADD, t0, t1)
    s1 = b.alu("s1", AluOp.ADD, s0, t2)
    po = b.alu("po", AluOp.ADD, pin, s1)
    b.out("pout", po)
    return b.done()


def axpby(alpha: int, beta: int) -> DFG:
    """out = alpha*x + beta*y (gemm epilogue: alpha*(AB) + beta*C)."""
    b = DFG.build("axpby")
    x, y = b.inp("x"), b.inp("y")
    ax = b.alu("ax", AluOp.MUL, x, const_b=alpha)
    by = b.alu("by", AluOp.MUL, y, const_b=beta)
    o = b.alu("o", AluOp.ADD, ax, by)
    b.out("out", o)
    return b.done()


def scale_add(alpha: int) -> DFG:
    """out = alpha*x + y."""
    b = DFG.build("scale_add")
    x, y = b.inp("x"), b.inp("y")
    ax = b.alu("ax", AluOp.MUL, x, const_b=alpha)
    o = b.alu("o", AluOp.ADD, ax, y)
    b.out("out", o)
    return b.done()


def vadd() -> DFG:
    """out = x + y (gemver x += z phase)."""
    b = DFG.build("vadd")
    x, y = b.inp("x"), b.inp("y")
    o = b.alu("o", AluOp.ADD, x, y)
    b.out("out", o)
    return b.done()


def outer_row2(u1_0: int, u2_0: int, u1_1: int, u2_1: int) -> DFG:
    """gemver phase 1, two rows fused (fabric-level unrolling, Sec. IV):
    a_k' = a_k + u1_k*v1 + u2_k*v2 for k in {0,1}, sharing the v1/v2 streams.
    """
    b = DFG.build("outer_row2")
    a0, a1 = b.inp("a0"), b.inp("a1")
    v1, v2 = b.inp("v1"), b.inp("v2")
    for k, (a, w1, w2) in enumerate([(a0, u1_0, u2_0), (a1, u1_1, u2_1)]):
        t1 = b.alu(f"t1_{k}", AluOp.MUL, v1, const_b=w1)
        t2 = b.alu(f"t2_{k}", AluOp.MUL, v2, const_b=w2)
        s = b.alu(f"s_{k}", AluOp.ADD, t1, t2)
        o = b.alu(f"o_{k}", AluOp.ADD, a, s)
        b.out(f"out{k}", o)
    return b.done()


def outer_row(u1_i: int, u2_i: int) -> DFG:
    """gemver phase 1, one row: a' = a + u1_i*v1 + u2_i*v2 (u*_i folded as
    consts for the shot — the CPU re-arms consts per row, Sec. IV strategy 3).
    """
    b = DFG.build("outer_row")
    a = b.inp("a")
    v1, v2 = b.inp("v1"), b.inp("v2")
    t1 = b.alu("t1", AluOp.MUL, v1, const_b=u1_i)
    t2 = b.alu("t2", AluOp.MUL, v2, const_b=u2_i)
    s = b.alu("s", AluOp.ADD, t1, t2)
    o = b.alu("o", AluOp.ADD, a, s)
    b.out("out", o)
    return b.done()


ONE_SHOT = {
    "fft": fft_butterfly,
    "relu": relu,
    "dither": dither,
    "find2min": find2min,
}

# hand-built data-dependent loop kernels (gated Branch/Merge recirculation)
LOOP_KERNELS = {
    "div_loop": div_loop,
}
