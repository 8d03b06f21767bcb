"""Irregular-loop frontend tests for the port — the cases of
``tests/test_frontend_loops.py`` over torch forms.

``while_loop`` and ``scan`` (``torch._higher_order_ops``) lower onto the
elastic Branch/Merge loop schema: gated entry (demand tokens), entry MERGE,
predicate-steered BRANCH per loop variable, recirculation back edges
(``init=None``), and token-exhaustion termination. Every kernel here is
checked on the functional executor AND the cycle-accurate elastic sim
against the eager torch function. A static-trip loop is a ``scan`` over
``torch.arange(n)`` (torch has no ``fori_loop``); a dynamic one is a
``while_loop`` with a counter.
"""
import numpy as np
import pytest
import torch
from torch._higher_order_ops.scan import scan
from torch._higher_order_ops.while_loop import while_loop

from repro_torch.core import kernels_lib as K
from repro_torch.core.elastic_sim import simulate
from repro_torch.core.executor import execute
from repro_torch.core.fabric import Fabric
from repro_torch.core.mapper import map_dfg
from repro_torch.frontend import (FrontendError, UnsupportedPrimitiveError,
                                  offload, plan, trace)

rng = np.random.default_rng(0)

_div7 = K.loop_div_fn(7)
_isqrt = K.loop_isqrt_fn()


def _zero():
    return torch.zeros((), dtype=torch.int32)


def _eager(fn, ins, element):
    """The torch function eagerly: per element (``while_loop`` does not run
    under ``torch.vmap``) or over the whole stream; leaves wrapped to
    int32."""
    ts = [torch.from_numpy(a) for a in ins]
    if element:
        rows = []
        for k in range(len(ins[0])):
            r = fn(*[t[k] for t in ts])
            rows.append(r if isinstance(r, tuple) else (r,))
        outs = [torch.stack(col) for col in zip(*rows)]
    else:
        r = fn(*ts)
        outs = list(r) if isinstance(r, tuple) else [r]
    return [np.asarray(o.to(torch.int64)).astype(np.int32).reshape(-1)
            for o in outs]


def _check_both_backends(fn, n_in, length=24, lo=0, hi=120, name=None,
                         element=True):
    """Trace, then assert executor == elastic sim == the eager function."""
    g = trace(fn, length, name=name or getattr(fn, "__name__", "loop"))
    ins = [rng.integers(lo, hi, length).astype(np.int32) for _ in range(n_in)]
    outs = execute(g, dict(zip(g.inputs, ins)))
    sim = simulate(map_dfg(g, restarts=400), dict(zip(g.inputs, ins)))
    for i, r in enumerate(_eager(fn, ins, element)):
        np.testing.assert_array_equal(outs[f"out{i}"], r)
        np.testing.assert_array_equal(sim.outputs[f"out{i}"], r)
    return g, sim


# ---------------------------------------------------------------------------
# while_loop: data-dependent trip counts
# ---------------------------------------------------------------------------

def test_while_division_both_backends():
    g, sim = _check_both_backends(_div7, 1, name="div_iter")
    assert g.has_recirculation()
    assert np.isfinite(sim.steady_ii())


def test_while_isqrt_invariant_closure():
    # the stream element rides the loop as a cond-closure invariant
    g, _ = _check_both_backends(_isqrt, 1, name="isqrt")
    assert g.has_recirculation()


def test_while_zero_trip_elements():
    # elements below the divisor exit on their first predicate evaluation
    g = trace(_div7, 6, name="div_zero")
    x = np.array([0, 1, 6, 3, 5, 2], dtype=np.int32)
    outs = execute(g, {"x": x})
    np.testing.assert_array_equal(outs["out0"], np.zeros(6, np.int32))
    np.testing.assert_array_equal(outs["out1"], x)


def test_while_matches_hand_built_div_loop():
    # the traced while lowers to the same schema as the hand-built kernel
    g = trace(_div7, 16, name="div_iter")
    assert g.canonical_signature() == K.div_loop(7).canonical_signature()


def test_fori_loop_dynamic_bound_is_a_while():
    def count_to(x):
        n = x & 7
        return while_loop(lambda i, v: i < n,
                          lambda i, v: (i + 1, v + i),
                          (torch.zeros_like(x), torch.zeros_like(x)))[1]

    def ref(x):
        return np.array([sum(range(int(v) & 7)) for v in x], dtype=np.int32)

    g = trace(count_to, 8, name="count_to")
    assert g.has_recirculation()
    x = rng.integers(0, 64, 8).astype(np.int32)
    np.testing.assert_array_equal(execute(g, {"x": x})["out0"], ref(x))


def test_fori_loop_static_bound_unrolls():
    def poly(x):
        v, _ = scan(lambda v, i: (v * 2 + 1, i.clone()), x,
                    torch.arange(5, dtype=torch.int32))
        return v

    g = trace(poly, 16, name="poly5")
    assert not g.has_recirculation() and not g.back_edges()
    _check_both_backends(poly, 1, length=16, lo=-50, hi=50, name="poly5b",
                         element=False)


# ---------------------------------------------------------------------------
# scan: loop-carried recurrences over the stream
# ---------------------------------------------------------------------------

def test_scan_clipping_recurrence():
    fn = K.clip_scan_fn(-10, 10)
    g, _ = _check_both_backends(fn, 1, lo=-30, hi=30, name="clip_scan",
                                element=False)
    assert g.back_edges() and not g.has_recirculation()


def test_scan_dither_matches_hand_built_golden():
    """Dither written as a scan produces the paper's dither DFG."""
    def dither_scan(x):
        def f(err, xi):
            v = xi + err
            o = (v > 127).to(torch.int32) * 255
            return v - o, o
        _, ys = scan(f, _zero(), x)
        return ys

    g = trace(dither_scan, 64, name="dither")
    assert g.canonical_signature() == K.dither().canonical_signature()


def test_scan_final_carry_is_last_value_output():
    fn = K.gemv_early_fn(1000)
    g = trace(fn, 16, name="gemv_early")
    assert g.nodes["out0"].emit_every == 0        # OMN last-value mode
    a = rng.integers(0, 12, 16).astype(np.int32)
    b = rng.integers(0, 12, 16).astype(np.int32)
    acc = 0
    for ai, bi in zip(a, b):
        if acc <= 1000:
            acc += int(ai) * int(bi)
    outs = execute(g, {"a": a, "b": b})
    assert outs["out0"].tolist() == [acc]
    sim = simulate(map_dfg(g, restarts=400), {"a": a, "b": b})
    assert sim.outputs["out0"].tolist() == [acc]
    assert int(fn(torch.from_numpy(a), torch.from_numpy(b))) == acc


def test_scan_previous_element_delay_line():
    # carry' = x: an INPUT-sourced back edge (first-difference filter)
    def diff(x):
        def f(prev, xi):
            return xi.clone(), xi - prev
        _, ys = scan(f, _zero(), x)
        return ys

    g, _ = _check_both_backends(diff, 1, lo=-50, hi=50, name="diff",
                                element=False)
    assert any(g.nodes[e.src].kind == "input" for e in g.back_edges())


# ---------------------------------------------------------------------------
# named-node diagnostics (one test per diagnostic)
# ---------------------------------------------------------------------------

def test_unsupported_primitive_inside_while_body_names_equation():
    def bad(x):
        def body(c):
            return c % 5                      # remainder has no lowering
        return while_loop(lambda c: c > 3, body, (x,))

    with pytest.raises(UnsupportedPrimitiveError,
                       match=r"remainder.*in node"):
        trace(bad, 8, name="bad_body")


def test_unsupported_primitive_inside_scan_body_names_equation():
    def bad(x):
        def f(acc, xi):
            y = acc + xi // 3                 # integer div: no lowering
            return y, y.clone()
        _, ys = scan(f, _zero(), x)
        return ys

    with pytest.raises(UnsupportedPrimitiveError,
                       match=r"floor_divide.*in node"):
        trace(bad, 8, name="bad_scan")


def test_three_way_switch_names_equation():
    # torch.cond is two-way only; an n-way selection indexes a stack
    def sw(x):
        cases = torch.stack([x + 1, x * 2, x - 3])
        return torch.index_select(cases, 0, x.reshape(1)).reshape(())

    with pytest.raises(UnsupportedPrimitiveError,
                       match=r"stack.*in node"):
        trace(sw, 8, name="switch3", mode="element")


def test_while_without_stream_operand_is_diagnosed():
    def pure(x):
        r = while_loop(lambda c: c < 5, lambda c: c + 1, (_zero(),))
        return x + r

    with pytest.raises(UnsupportedPrimitiveError,
                       match="no stream operands"):
        trace(pure, 8, name="pure_loop", mode="element")


def test_scan_reverse_is_diagnosed():
    def rev(x):
        _, ys = scan(lambda a, xi: (a + xi, a.clone()), _zero(), x,
                     reverse=True)
        return ys

    with pytest.raises(UnsupportedPrimitiveError, match="reverse scan"):
        trace(rev, 8, name="rev_scan")


def test_scan_runtime_carry_init_is_diagnosed():
    def bad(x):
        s = torch.sum(x).to(torch.int32)      # runtime scalar as carry init
        _, ys = scan(lambda a, xi: (a + xi, a.clone()), s, x)
        return ys

    with pytest.raises(UnsupportedPrimitiveError,
                       match="carry 0 initial value is a runtime value"):
        trace(bad, 8, name="bad_init")


def test_static_unroll_budget_is_diagnosed():
    def big(x):
        v, _ = scan(lambda v, i: (v + 1, i.clone()), x,
                    torch.arange(1000, dtype=torch.int32))
        return v

    with pytest.raises(UnsupportedPrimitiveError, match="unroll budget"):
        trace(big, 8, name="big_loop")


def test_reduction_entering_while_loop_is_diagnosed():
    # a reduction emits one token per stream; the loop gate needs one per
    # element — joining them must fail at trace time, not mis-execute
    def bad(x):
        s = torch.sum(x)
        q, r = _div7(s)
        return x + r

    with pytest.raises(FrontendError,
                       match="reduction output|single .* token"):
        trace(bad, 8, name="sum_loop")


def test_recirculation_init_discriminates_signature():
    # init=None (recirculation) vs init=0 are different machines; the
    # structural fingerprint must distinguish them
    import dataclasses

    g = K.div_loop(7)
    g2 = K.div_loop(7)
    g2.edges = [dataclasses.replace(e, init=0)
                if e.back and e.init is None else e for e in g2.edges]
    assert g.canonical_signature() != g2.canonical_signature()


def test_unroll_chained_rejects_recirculation():
    from repro_torch.core.dfg import unroll, unroll_chained
    from repro_torch.core.mapper import auto_unroll

    g = K.div_loop(7)
    with pytest.raises(ValueError, match="chaining is undefined"):
        unroll_chained(g, 2)
    # independent-lane unrolling of a gated loop stays correct
    gu = unroll(g, 2)
    x = rng.integers(0, 99, 8).astype(np.int32)
    outs = execute(gu, {"x@0": x, "x@1": x + 1})
    np.testing.assert_array_equal(outs["out_q@0"], x // 7)
    np.testing.assert_array_equal(outs["out_q@1"], (x + 1) // 7)
    # auto_unroll with chained=True must fall back to independent lanes
    m, factor = auto_unroll(g, chained=True, max_factor=2, restarts=60)
    assert not any(e.init is None and e.back and "@1" in e.dst
                   and "@0" in e.src for e in m.dfg.edges)


def test_scan_final_carry_consumed_elementwise_is_diagnosed():
    def bad(x):
        acc, ys = scan(lambda a, xi: (a + xi, (a + xi).clone()), _zero(), x)
        return ys + acc                       # joins a final with a stream

    with pytest.raises(FrontendError, match="final carry"):
        trace(bad, 8, name="final_join")


# ---------------------------------------------------------------------------
# partitioning: loop bodies stay atomic, cuts after the exit legs are legal
# ---------------------------------------------------------------------------

def test_partition_keeps_while_loop_atomic():
    """A while kernel with a fat elementwise epilogue exceeds one fabric
    load; the plan must cut *after* the loop's exit legs (full rate), never
    through the recirculation body."""
    def loop_and_epilogue(x):
        q, r = _div7(x)
        y = q * 3 + r
        y = y * y + 7
        y = (y ^ 21) + (y >> 2)
        y = y * 5 - 9
        y = (y | 3) + (y & 14) + (y ^ 2) - (y >> 1)
        return y

    g = trace(loop_and_epilogue, 16, name="loop_epi")
    pl = plan(g)
    assert pl.n_shots >= 2
    # the recirculation cluster lands intact inside exactly one shot
    loop_shots = [s for s in pl.shots if s.dfg.has_recirculation()]
    assert len(loop_shots) == 1
    body = g.recirculation_nodes()
    shot_nodes = set(loop_shots[0].dfg.nodes)
    assert body <= shot_nodes
    x = rng.integers(0, 120, 16).astype(np.int32)
    np.testing.assert_array_equal(
        pl.run({"x": x}, with_timing=False)["out0"],
        execute(g, {"x": x})["out0"])


def test_loop_kernel_on_nondefault_geometry():
    g = trace(_div7, 12, name="div_geo")
    fab = Fabric(rows=6, cols=4)
    m = map_dfg(g, fab, restarts=400)
    x = rng.integers(0, 120, 12).astype(np.int32)
    sim = simulate(m, {"x": x})
    np.testing.assert_array_equal(sim.outputs["out0"], x // 7)
    np.testing.assert_array_equal(sim.outputs["out1"], x % 7)


# ---------------------------------------------------------------------------
# acceptance: a while kernel through the engine
# ---------------------------------------------------------------------------

def test_offload_while_kernel_end_to_end():
    """A traced ``while_loop`` kernel with a data-dependent trip count
    compiles through the engine, runs on both the elastic sim and the
    functional executor with identical outputs matching the Python
    reference, and reports a finite II."""
    from repro_torch.engine import ArtifactCache, Engine

    kernel = offload(K.loop_div_fn(7), debug=True)     # debug: eager check
    x = rng.integers(0, 200, 32).astype(np.int32)
    q, r = kernel(x)                                   # sim backend
    np.testing.assert_array_equal(np.asarray(q), x // 7)
    np.testing.assert_array_equal(np.asarray(r), x % 7)
    assert kernel.last.backend == "sim" and kernel.last.n_shots == 1
    assert np.isfinite(kernel.last.ii) and kernel.last.cycles > 0

    # the same artifact through the engine runs on the executor (ShotRunner
    # functional path) and agrees with the sim measurement above
    eng = Engine(cache=ArtifactCache(memory_only=True))
    art = eng.compile(K.div_loop(7))
    outs = eng.run(art, {"x": x})
    np.testing.assert_array_equal(outs["out_q"], x // 7)
    np.testing.assert_array_equal(outs["out_r"], x % 7)
    assert np.isfinite(art.estimated_ii()) and art.estimated_ii() >= 1


def test_offload_loop_kernels_cache_hits():
    kernel = offload(K.loop_isqrt_fn())
    x = rng.integers(0, 4096, 16).astype(np.int32)
    y1 = kernel(x)
    y2 = kernel(x)
    np.testing.assert_array_equal(np.asarray(y1),
                                  np.sqrt(x).astype(np.int64))
    np.testing.assert_array_equal(y1, y2)
    hits, misses, _ = kernel.cache_info()
    assert misses == 1 and hits >= 1
