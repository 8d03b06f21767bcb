"""Fixed-point model-layer kernels: transformer / SSM / MoE per-layer ops
decomposed onto the int32 streaming fabric (counterpart of
``repro.workloads.kernels``).

The STRELA datapath is a 32-bit integer ALU (ADD/SUB/MUL/SHL/SHR/AND/OR/XOR
+ EQZ/GTZ). The bridge is the standard quantized-inference decomposition:
activations are Q8 fixed point (1.0 == 256), layer constants fold into the
PE configuration at trace time, and every float op is rewritten into the
primitive set the frontend lowers — shifts for requantization, clamp/select
for piecewise nonlinearities, the ALU accumulator for row reductions,
Branch/Merge for routing decisions, and the elastic loop schema for
recurrences.

Decomposition rules (DESIGN.md §16):

  * **requantize with shifts** — a Qa x Qb product is brought back to Q8
    with an arithmetic right shift; non-power-of-two divisors become a
    multiply by a Q15/Q16 reciprocal followed by a shift (e.g. ``/6`` is
    ``* 21845 >> 16`` after a ``>> 9``);
  * **piecewise nonlinearities** — GELU/SiLU use the *hard* variants of
    quantized inference (h-swish: ``x * clamp(x+3, 0, 6) / 6``), exact in
    int32 and within a stated float tolerance of the real activation;
  * **exp via exponent/mantissa split** — softmax terms ``2^x`` (logits
    pre-scaled by log2 e) split into an integer exponent (variable SHR)
    and a linearly interpolated mantissa;
  * **recurrences ride the elastic loop schema** — an SSD-style gated
    recurrence is a ``scan`` (loop-carried back edge); an *implicit* state
    update solved by fixed-point iteration is a ``while_loop``
    (demand-gated recirculation, data-dependent trip count);
  * **routing is Branch/Merge** — MoE top-1 gating steers each token down
    one expert leg of a ``torch.cond``; only the taken side fires.

Every kernel here comes in two forms that must stay in lockstep:

  * the **traced form** (``*_fn`` factories) — plain Python/torch over
    int32 streams, lowered by ``repro_torch.frontend.trace`` through
    partition, P&R, config emission, and either execution backend. The
    torch spellings: ``torch.clamp`` lowers to ``minimum(maximum(x, lo),
    hi)``; ``torch.sum`` widens to int64 and the fabric wraps it mod 2^32;
    ``scan`` takes a tensor init and its body ``.clone()``s a value it
    returns as both carry and output; ``while_loop`` takes a tensor carry;
    ``torch.cond`` is the two-way Branch/Merge;
  * the **oracle** (``*_oracle``) — the same integer arithmetic evaluated
    directly in torch int32 on the CPU, *independently of the DFG*, each
    returning a tuple of int32 numpy arrays. The differential gate in
    tests/test_torch_workloads.py requires them bit-exact, which checks the
    whole trace -> partition -> map -> execute stack, not the kernels.

All intermediates are kept below 2**31 by the input ranges in
``registry.py``, so int32 wraparound never triggers and numpy / torch /
executor semantics coincide exactly.
"""
from __future__ import annotations

import numpy as np
import torch

Q = 8                       # activation fixed point: Q8, 1.0 == 256
ONE = 1 << Q

# layer constants (fold into PE configs at trace time; one config class
# per kernel, so every request of a class batches under one fabric config)
LN_GAIN = 307               # LayerNorm gain  ~1.199 Q8
LN_BIAS = -13               # LayerNorm bias  ~-0.051 Q8
INV6_Q16 = 21845            # 1/3 in Q16 (pairs with a >>9 for /1536)
SCORE_SHIFT = 7             # attention scores requantize per product (Q7)
SSM_DECAY_MAX = 230         # selective-scan decay gate upper bound (~0.9)
REC_A = 128                 # implicit-step recurrence weight 0.5 Q8
REC_B = 192                 # implicit-step input weight    0.75 Q8
REC_TOL = 2                 # fixed-point iteration stop (Q8 units)
MOE_W0 = 282                # expert-0 weight ~1.102 Q8
MOE_W1 = 154                # expert-1 weight ~0.602 Q8


# ---------------------------------------------------------------------------
# transformer: LayerNorm affine + residual, MLP activations
# ---------------------------------------------------------------------------

def ln_affine_fn():
    """LayerNorm/RMSNorm scale-shift fused with the residual add:
    ``out = x*g >> Q + b + r`` over a normalized activation stream ``x``
    and a residual stream ``r`` (a norm's ``g * x_hat + b`` tail plus the
    block's skip connection)."""
    def ln_affine(x, r):
        return ((x * LN_GAIN) >> Q) + LN_BIAS + r
    return ln_affine


def _hswish(x):
    """Hard-SiLU (h-swish), the quantized-inference SiLU:
    ``x * clamp(x+3, 0, 6) / 6`` — exact in int32 via ``* 21845 >> 25``."""
    t = torch.clamp(x + 3 * ONE, 0, 6 * ONE)
    p = (x * t) >> 9
    return (p * INV6_Q16) >> 16


def silu_q_fn():
    """Transformer MLP activation: hard-SiLU elementwise pipeline."""
    def silu_q(x):
        return _hswish(x)
    return silu_q


def swiglu_fn():
    """SwiGLU MLP gate: ``hswish(g) * u >> Q`` over the gate and up
    projections. Served under ``pe_limit`` so the 8-FU pipeline
    partitions into a multi-shot plan (the preemptible long request)."""
    def swiglu(g, u):
        return (_hswish(g) * u) >> Q
    return swiglu


# ---------------------------------------------------------------------------
# attention: score-row dot tile, softmax denominator
# ---------------------------------------------------------------------------

def attn_score_fn():
    """One attention-score row piece: the q·k dot tile of a flash-attention
    inner loop, requantized per product (Q7 operands) and folded by the ALU
    accumulator."""
    def attn_score(q, k):
        return torch.sum((q * k) >> SCORE_SHIFT)
    return attn_score


def softmax_denom_fn():
    """Softmax denominator over max-shifted logits (``x <= 0``, Q8,
    pre-scaled by log2 e): each term ``2^(x/256)`` splits into an integer
    exponent (variable SHR) and a linear mantissa, then folds through the
    ALU accumulator — the online-softmax normalizer of chunked attention."""
    def softmax_denom(x):
        d = -x
        k = d >> Q                        # integer part of the exponent
        f = d & (ONE - 1)                 # fractional part
        mant = ONE - (f >> 1)             # 2^-f linearly interpolated
        return torch.sum(mant >> k)
    return softmax_denom


# ---------------------------------------------------------------------------
# SSM: selective-scan recurrence (explicit + implicit forms)
# ---------------------------------------------------------------------------

def ssm_scan_fn():
    """Selective SSD recurrence: per step ``h = a_t*h >> Q + u_t`` with a
    data-dependent decay gate stream ``a`` — a loop-carried back edge
    (sim-only: loop-state)."""
    from torch._higher_order_ops.scan import scan

    def ssm_scan(u, a):
        def step(h, ua):
            ui, ai = ua
            h2 = ((ai * h) >> Q) + ui
            return h2, h2.clone()
        _, ys = scan(step, torch.zeros((), dtype=torch.int32), (u, a))
        return ys
    return ssm_scan


def ssm_relax_fn():
    """Implicit (trapezoid-style) SSM state update solved by fixed-point
    iteration: per element, relax ``h = A*h >> Q + c`` (``c = B*x >> Q``)
    from 0 until the increment falls to ``REC_TOL`` — a data-dependent
    trip count per element, lowered onto the demand-gated elastic loop
    schema (sim-only: loop-state + recirculation)."""
    from torch._higher_order_ops.while_loop import while_loop

    def ssm_relax(x):
        c = (x * REC_B) >> Q

        def cond(h, d):
            return d > REC_TOL

        def body(h, d):
            h2 = ((h * REC_A) >> Q) + c
            return h2, h2 - h

        h, _ = while_loop(cond, body, (torch.zeros_like(c),
                                       torch.full_like(c, REC_TOL + 1)))
        return h
    return ssm_relax


# ---------------------------------------------------------------------------
# MoE: top-1 routing as Branch/Merge
# ---------------------------------------------------------------------------

def moe_gate_fn():
    """MoE top-1-of-2 gate: the router margin ``s = logit0 - logit1``
    steers each token down one expert leg of a ``torch.cond``
    (Branch/Merge — only the taken expert fires); also emits the chosen
    expert index."""

    def moe_gate(x, s):
        pred = s > 0
        y = torch.cond(pred,
                       lambda v: (v * MOE_W0) >> Q,
                       lambda v: (v * MOE_W1) >> Q, (x,))
        return y, pred.to(torch.int32)
    return moe_gate


# ---------------------------------------------------------------------------
# oracles: the same integer arithmetic in torch int32, evaluated directly
# ---------------------------------------------------------------------------

def _i32(*arrs):
    return tuple(torch.as_tensor(np.asarray(a, dtype=np.int32))
                 for a in arrs)


def _np(*ts):
    return tuple(np.asarray(t.numpy(), dtype=np.int32) for t in ts)


def _sum32(t):
    """torch widens an int32 sum to int64; the fabric wraps mod 2^32."""
    return torch.sum(t).to(torch.int32)


def ln_affine_oracle(x, r):
    (x, r) = _i32(x, r)
    return _np(((x * LN_GAIN) >> Q) + LN_BIAS + r)


def silu_q_oracle(x):
    (x,) = _i32(x)
    return _np(_hswish(x))


def swiglu_oracle(g, u):
    (g, u) = _i32(g, u)
    return _np((_hswish(g) * u) >> Q)


def attn_score_oracle(q, k):
    (q, k) = _i32(q, k)
    return _np(_sum32((q * k) >> SCORE_SHIFT))


def softmax_denom_oracle(x):
    (x,) = _i32(x)
    d = -x
    mant = ONE - ((d & (ONE - 1)) >> 1)
    return _np(_sum32(mant >> (d >> Q)))


def ssm_scan_oracle(u, a):
    (u, a) = _i32(u, a)
    h = torch.zeros((), dtype=torch.int32)
    ys = torch.empty_like(u)
    for i in range(u.shape[0]):
        h = ((a[i] * h) >> Q) + u[i]
        ys[i] = h
    return _np(ys)


def ssm_relax_oracle(x):
    """Vectorized masked relaxation: converged lanes freeze, so the joint
    loop is element-wise identical to the fabric's per-element loop."""
    (x,) = _i32(x)
    c = (x * REC_B) >> Q
    h = torch.zeros_like(c)
    d = torch.full_like(c, REC_TOL + 1)
    while bool(torch.any(d > REC_TOL)):
        live = d > REC_TOL
        h2 = torch.where(live, ((h * REC_A) >> Q) + c, h)
        d = torch.where(live, h2 - h, d)
        h = h2
    return _np(h)


def moe_gate_oracle(x, s):
    (x, s) = _i32(x, s)
    pred = s > 0
    y = torch.where(pred, (x * MOE_W0) >> Q, (x * MOE_W1) >> Q)
    return _np(y, pred.to(torch.int32))


# ---------------------------------------------------------------------------
# float references: tie each integer kernel to the real layer semantics
# ---------------------------------------------------------------------------
# Each returns (got_float, want_float, atol): the dequantized fabric
# output vs the float layer math, with the stated quantization tolerance
# (derived in DESIGN.md §16 from the shift-truncation error budget).

def _f(a):
    return np.asarray(a, dtype=np.float64) / ONE


def ln_affine_float(inputs, outputs):
    x, r = _f(inputs["x"]), _f(inputs["r"])
    want = x * (LN_GAIN / ONE) + (LN_BIAS / ONE) + r
    return _f(outputs[0]), want, 0.02


def _hswish_f(x):
    return x * np.clip(x + 3.0, 0.0, 6.0) / 6.0


def silu_q_float(inputs, outputs):
    return _f(outputs[0]), _hswish_f(_f(inputs["x"])), 0.02


def swiglu_float(inputs, outputs):
    g, u = _f(inputs["g"]), _f(inputs["u"])
    return _f(outputs[0]), _hswish_f(g) * u, 0.2


def attn_score_float(inputs, outputs):
    q = np.asarray(inputs["q"], dtype=np.float64) / (1 << SCORE_SHIFT)
    k = np.asarray(inputs["k"], dtype=np.float64) / (1 << SCORE_SHIFT)
    got = np.asarray(outputs[0], dtype=np.float64) / (1 << SCORE_SHIFT)
    return got, np.sum(q * k, keepdims=True), len(q) / 128.0


def softmax_denom_float(inputs, outputs):
    x = _f(inputs["x"])
    want = np.sum(np.exp2(x), keepdims=True)
    got = _f(outputs[0])
    # relative tolerance (the mantissa interpolation is ~6% worst case):
    # normalize both to the exact denominator before the atol compare
    return got / want, want / want, 0.08


def ssm_scan_float(inputs, outputs):
    u, a = _f(inputs["u"]), _f(inputs["a"])
    h, ys = 0.0, np.zeros_like(u)
    for i in range(len(u)):
        h = a[i] * h + u[i]
        ys[i] = h
    return _f(outputs[0]), ys, 0.05


def ssm_relax_float(inputs, outputs):
    x = _f(inputs["x"])
    cf = x * (REC_B / ONE)
    want = cf / (1.0 - REC_A / ONE)       # the implicit step's fixed point
    return _f(outputs[0]), want, 0.04


def moe_gate_float(inputs, outputs):
    x = _f(inputs["x"])
    s = np.asarray(inputs["s"])
    want = np.where(s > 0, x * (MOE_W0 / ONE), x * (MOE_W1 / ONE))
    return _f(outputs[0]), want, 0.01
