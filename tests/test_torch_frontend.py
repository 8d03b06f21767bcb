"""The port's compiler frontend: torch aten graph -> DFG tracing, pattern
recognition, multi-shot partitioning, and the @offload decorator — the
cases of ``tests/test_frontend.py`` over torch forms of the same kernels.

Golden criterion: traced equivalents of the paper's hand-built kernels
produce DFGs with the same node/edge structure (canonical signature) or,
where construction order differs, the same simulated initiation interval on
identical streams. The ``"cuda"`` backend runs here on the CPU
(``device="cpu"``), where the lane kernel's plain version computes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import kernels_lib as K
from repro_torch.core.elastic_sim import simulate
from repro_torch.core.executor import execute
from repro_torch.core.mapper import map_dfg
from repro_torch.frontend import (FrontendError, UnsupportedPrimitiveError,
                                  offload, plan, trace)

rng = np.random.default_rng(0)

WR, WI = 23170, -23170


def _relu(x):
    return torch.where(x > 0, x, 0)


def _axpby(x, y):
    return 3 * x + 5 * y


def _mac1(a, b0):
    return torch.sum(a * b0)


def _fft(ar, ai, br, bi):
    tr = br * WR - bi * WI
    ti = br * WI + bi * WR
    return ar + tr, ai + ti, ar - tr, ai - ti


def _ref(fn, arrays):
    """The torch function itself, eager, each result wrapped to int32."""
    out = fn(*[torch.from_numpy(a) for a in arrays])
    outs = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o.to(torch.int64)).astype(np.int32).reshape(-1)
            for o in outs]


# ---------------------------------------------------------------------------
# golden structure: traced graphs == hand-built kernels_lib graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn,hand", [
    (_relu, K.relu),
    (_axpby, lambda: K.axpby(3, 5)),
    (_mac1, lambda: K.mac1(64)),
    (_fft, K.fft_butterfly),
], ids=["relu", "axpby", "mac1", "fft"])
def test_traced_structure_matches_hand_built(fn, hand):
    g = trace(fn, 64)
    assert g.canonical_signature() == hand().canonical_signature()


def test_traced_relu_max_form_matches_hand_built():
    for form in (lambda x: torch.maximum(x, torch.zeros_like(x)),
                 lambda x: torch.clamp(x, min=0), lambda x: torch.relu(x)):
        g = trace(form, 64, name="relu_max")
        assert g.canonical_signature() == K.relu().canonical_signature()


@pytest.mark.parametrize("fn,hand,n_in", [
    (_relu, K.relu, 1),
    (_fft, K.fft_butterfly, 4),
], ids=["relu", "fft"])
def test_traced_ii_matches_hand_built(fn, hand, n_in):
    n = 256
    gt, gh = trace(fn, n), hand()
    ins = [rng.integers(-4096, 4096, n).astype(np.int32) for _ in range(n_in)]
    st = simulate(map_dfg(gt), dict(zip(gt.inputs, ins)))
    sh = simulate(map_dfg(gh), dict(zip(gh.inputs, ins)))
    assert st.steady_ii() == sh.steady_ii()
    assert st.cycles == sh.cycles


# ---------------------------------------------------------------------------
# lowering coverage: elementwise ops, comparisons, control
# ---------------------------------------------------------------------------

def _check_traced(fn, n_in, length=48, lo=-100, hi=100):
    """Trace + execute + compare against the torch function itself."""
    g = trace(fn, length)
    ins = [rng.integers(lo, hi, length).astype(np.int32)
           for _ in range(n_in)]
    outs = execute(g, dict(zip(g.inputs, ins)))
    for i, r in enumerate(_ref(fn, ins)):
        np.testing.assert_array_equal(outs[f"out{i}"], r)


@pytest.mark.parametrize("fn,n_in", [
    (lambda x, y: (x + y, x - y, x * y), 2),
    (lambda x, y: (x & y, x | y, x ^ y), 2),
    (lambda x: x << 3, 1),
    (lambda x: x >> 2, 1),
    (lambda x: -x, 1),
    (lambda x: x ** 3, 1),
    (lambda x: 7 - x, 1),                       # const on the left of SUB
    (lambda x, y: torch.minimum(x, y), 2),
    (lambda x, y: torch.maximum(x, y), 2),
    (lambda x: torch.clamp(x, -5, 5), 1),
    (lambda x, y: torch.where(x > y, x + 1, y * 2), 2),
    (lambda x, y: (x >= y).to(torch.int32), 2),
    (lambda x, y: (x <= y).to(torch.int32), 2),
    (lambda x, y: (x != y).to(torch.int32), 2),
    (lambda x, y: (x == y).to(torch.int32), 2),
    (lambda x, y: (x < y).to(torch.int32), 2),
    (lambda x: torch.where(x > 2, 10, 20), 1),  # both select cases constant
], ids=["arith", "bitwise", "shl", "shr", "neg", "pow3", "rsub", "min",
        "max", "clip", "where", "ge", "le", "ne", "eq", "lt", "const_sel"])
def test_elementwise_lowering(fn, n_in):
    _check_traced(fn, n_in)


def test_dot_product_lowering():
    g = trace(lambda a, b: torch.dot(a, b), 32, name="dotk")
    assert g.canonical_signature() == K.mac1(32).canonical_signature()
    a = rng.integers(-50, 50, 32).astype(np.int32)
    b = rng.integers(-50, 50, 32).astype(np.int32)
    outs = execute(g, dict(zip(g.inputs, [a, b])))
    assert outs["out0"][0] == np.int32(np.dot(a.astype(np.int64), b))


def test_cond_lowers_to_branch_merge():
    def k(x):
        return torch.cond(x > 0, lambda v: v + 1, lambda v: v * 2, (x,))
    g = trace(k, 16)
    kinds = sorted(n.kind for n in g.nodes.values())
    assert "branch" in kinds and "merge" in kinds
    x = rng.integers(-50, 50, 16).astype(np.int32)
    outs = execute(g, {"x": x})
    np.testing.assert_array_equal(outs["out0"], np.where(x > 0, x + 1, x * 2))


def test_cond_constant_branch_is_paced():
    def k(x):
        return torch.cond(x > 0, lambda v: v - 2,
                          lambda v: torch.full_like(v, 42), (x,))
    g = trace(k, 16)
    x = rng.integers(-50, 50, 16).astype(np.int32)
    outs = execute(g, {"x": x})
    np.testing.assert_array_equal(outs["out0"], np.where(x > 0, x - 2, 42))


def test_reduction_recognized_as_accumulator():
    g = trace(_mac1, 40)
    accs = [n for n in g.nodes.values() if n.is_reduction()]
    assert len(accs) == 1
    assert accs[0].emit_every == 40 and accs[0].acc_init == 0


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------

def test_unsupported_primitive_names_the_equation():
    with pytest.raises(UnsupportedPrimitiveError) as ei:
        trace(lambda x: torch.sort(x)[0], 16, name="bad")
    msg = str(ei.value)
    assert "bad" in msg and "sort" in msg and "node" in msg


def test_reduction_rebroadcast_is_rejected():
    with pytest.raises(FrontendError) as ei:
        trace(lambda x: x - torch.sum(x), 16)
    assert "reduction" in str(ei.value)


def test_unused_input_is_rejected():
    with pytest.raises(FrontendError) as ei:
        trace(lambda x, y: x + 1, 16)
    assert "y" in str(ei.value)


def test_constant_output_is_rejected():
    with pytest.raises(FrontendError):
        trace(lambda x: (x + 1, 5), 16)


# ---------------------------------------------------------------------------
# @offload: dispatch, debug checking, compilation cache
# ---------------------------------------------------------------------------

def test_offload_relu_sim_backend():
    k = offload(_relu, debug=True)
    x = rng.integers(-100, 100, 128).astype(np.int32)
    y = k(x)
    np.testing.assert_array_equal(y, np.maximum(x, 0))
    assert k.last.backend == "sim" and k.last.n_shots == 1
    assert k.last.ii == 1.0


def test_offload_fft_matches_numpy():
    k = offload(_fft, debug=True)
    ins = [rng.integers(-4096, 4096, 64).astype(np.int32) for _ in range(4)]
    outs = k(*ins)
    ar, ai, br, bi = (a.astype(np.int64) for a in ins)
    tr, ti = br * WR - bi * WI, br * WI + bi * WR
    for got, ref in zip(outs, (ar + tr, ai + ti, ar - tr, ai - ti)):
        np.testing.assert_array_equal(got, ref.astype(np.int32))


def test_offload_mac1_scalar_output():
    k = offload(_mac1, debug=True)
    a = rng.integers(-50, 50, 24).astype(np.int32)
    b = rng.integers(-50, 50, 24).astype(np.int32)
    out = k(a, b)
    assert out.shape == ()
    assert np.int32(out) == np.int32(np.dot(a.astype(np.int64), b))


def test_offload_cuda_backend_matches_sim():
    ks = offload(_axpby, backend="sim")
    kc = offload(_axpby, backend="cuda", device="cpu")
    x = rng.integers(-1000, 1000, 200).astype(np.int32)
    y = rng.integers(-1000, 1000, 200).astype(np.int32)
    np.testing.assert_array_equal(ks(x, y), kc(x, y))


def test_offload_cuda_runs_reductions():
    """The capability set admits single-emission reductions: a traced dot
    product dispatches to the lane kernel (its plain version on the CPU),
    bit-exact vs the debug check and the sim backend."""
    from repro_torch.kernels import fabric_reduce as fr
    kc = offload(_mac1, backend="cuda", device="cpu", debug=True)
    ks = offload(_mac1, backend="sim")
    a = rng.integers(-50, 50, 16).astype(np.int32)
    b = rng.integers(-50, 50, 16).astype(np.int32)
    plain = fr.plain_calls
    assert np.int32(kc(a, b)) == np.int32(ks(a, b))
    assert kc.last.backend == "cuda"
    assert fr.plain_calls == plain + 1


def test_offload_cuda_rejects_loop_state_by_name():
    """Feature detection, not blanket refusal: the rejection diagnostic
    must name the offending capability feature."""
    from torch._higher_order_ops.scan import scan

    from repro_torch.engine import CapabilityError

    def _dither_like(x):
        def f(err, xi):
            v = xi + err
            out = torch.where(v > 127, 255, 0).to(torch.int32)
            return v - out, out
        _, ys = scan(f, torch.zeros((), dtype=torch.int32), x)
        return ys

    k = offload(_dither_like, backend="cuda", device="cpu")
    with pytest.raises(CapabilityError, match="loop-carried back edge"):
        k(np.ones(8, np.int32))


def test_offload_cond_kernel_end_to_end():
    @offload(debug=True)
    def k(x):
        return torch.cond(x > 0, lambda v: v + 1, lambda v: v * 2, (x,))
    x = rng.integers(-50, 50, 32).astype(np.int32)
    out = k(x)
    assert out.shape == (32,)
    np.testing.assert_array_equal(out, np.where(x > 0, x + 1, x * 2))


def test_offload_cache_keys_captured_constants():
    """Captured 0-d tensors are graph constants (invisible in the graph
    text, which names them only); kernels differing only in the captured
    value must not collide."""
    def make(c):
        cc = torch.tensor(c, dtype=torch.int32)
        return offload(lambda x: x * cc, name=f"capt{c}")

    x = np.arange(8, dtype=np.int32)
    k3, k5 = make(3), make(5)
    np.testing.assert_array_equal(k3(x), 3 * x)
    np.testing.assert_array_equal(k5(x), 5 * x)
    # same graph text, different constants -> different digests
    assert not (set(k3._cache) & set(k5._cache))


def test_offload_cache_hits():
    k = offload(_axpby)
    x = rng.integers(-10, 10, 32).astype(np.int32)
    y = rng.integers(-10, 10, 32).astype(np.int32)
    k(x, y)
    assert k.cache_info() == (0, 1, 1)
    k(x + 1, y - 1)                       # same length -> same graph -> hit
    assert k.cache_info() == (1, 1, 1)
    k(np.resize(x, 64), np.resize(y, 64))  # new length -> new compilation
    assert k.cache_info() == (1, 2, 2)
    k(x, y)                                # first entry still cached
    assert k.cache_info() == (2, 2, 2)


# ---------------------------------------------------------------------------
# multi-shot partitioning
# ---------------------------------------------------------------------------

def _big(x, y):
    t = x
    for i in range(1, 23):                 # 22 ALU pairs -> 66 PEs
        t = t * 3 + y + i
    return t


def test_oversized_graph_partitions_and_matches_numpy():
    g = trace(_big, 64, name="big")
    assert g.n_pes_used() > 16
    pl = plan(g)
    assert pl.n_shots > 1
    for shot in pl.shots:
        assert shot.dfg.n_pes_used() <= 16
        assert len(shot.dfg.inputs) <= 4 and len(shot.dfg.outputs) <= 4
    x = rng.integers(-50, 50, 64).astype(np.int32)
    y = rng.integers(-50, 50, 64).astype(np.int32)
    outs = pl.run({"x": x, "y": y})
    np.testing.assert_array_equal(outs["out0"], _ref(_big, [x, y])[0])


def test_offload_dispatches_multi_shot_with_tally():
    k = offload(_big, debug=True)
    x = rng.integers(-50, 50, 64).astype(np.int32)
    y = rng.integers(-50, 50, 64).astype(np.int32)
    out = k(x, y)
    np.testing.assert_array_equal(out, _ref(_big, [x, y])[0])
    assert k.last.n_shots > 1
    t = k.last.tally
    assert t is not None and t.shots == k.last.n_shots
    assert t.config > 0 and t.rearm > 0 and t.exec > 0


def test_partition_never_cuts_branch_legs():
    """An oversized cond body cannot be cut mid-leg (data-dependent token
    rate); the planner must reject it with a diagnostic, not deadlock."""
    def big_cond(x):
        def t(v):
            for i in range(1, 12):
                v = v * 3 + i
            return v

        def f(v):
            for i in range(1, 12):
                v = v * 2 - i
            return v
        return torch.cond(x > 0, t, f, (x,))

    g = trace(big_cond, 16, name="big_cond")
    assert g.n_pes_used() > 16
    with pytest.raises(FrontendError) as ei:
        plan(g)
    assert "rate" in str(ei.value) or "decomposition" in str(ei.value)


def test_partition_keeps_loop_bodies_atomic():
    """A back edge closes a loop through its whole forward path; partition
    must keep every body node in one shot (not just the edge endpoints)."""
    from repro_torch.core.dfg import DFG
    from repro_torch.core.isa import AluOp

    b = DFG.build("loopy")
    x = b.inp("x")
    n1 = b.alu("n1", AluOp.ADD, x, None)           # b fed by the back edge
    n2 = b.alu("n2", AluOp.ADD, n1, const_b=1)
    n3 = b.alu("n3", AluOp.ADD, n2, const_b=2)
    b.back_edge(n3, n1, "b", init=0)
    t = n3
    for i in range(18):                            # overflow the fabric
        t = b.alu(f"t{i}", AluOp.ADD, t, const_b=i)
    b.out("out", t)
    g = b.done()
    assert g.n_pes_used() > 16
    pl = plan(g)
    assert pl.n_shots > 1
    homes = {s.key for s in pl.shots
             if any(n in s.dfg.nodes for n in ("n1", "n2", "n3"))}
    assert len(homes) == 1, f"loop body split across shots {homes}"
    x_in = rng.integers(-20, 20, 32).astype(np.int32)
    outs = pl.run({"x": x_in})
    ref, carry = [], 0
    for v in x_in.tolist():
        n1v = v + carry
        carry = n1v + 3
        ref.append(carry)
    ref = np.asarray(ref, dtype=np.int64)
    for i in range(18):
        ref = ref + i
    np.testing.assert_array_equal(outs["out"], ref.astype(np.int32))


def test_offload_forced_element_mode_shapes():
    k = offload(lambda x: x + 1, mode="element", name="elem")
    x = np.arange(8, dtype=np.int32)
    out = k(x)
    assert out.shape == (8,)
    np.testing.assert_array_equal(out, x + 1)


def test_single_shot_plan_fast_path():
    g = trace(_axpby, 32)
    pl = plan(g)
    assert pl.n_shots == 1
    x = rng.integers(-10, 10, 32).astype(np.int32)
    y = rng.integers(-10, 10, 32).astype(np.int32)
    outs = pl.run({"x": x, "y": y})
    np.testing.assert_array_equal(outs["out0"],
                                  (3 * x.astype(np.int64) + 5 * y)
                                  .astype(np.int32))
