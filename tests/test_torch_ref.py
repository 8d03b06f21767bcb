"""The port's plain DFG evaluator (``repro_torch.kernels.ref``) against the
reference ``repro.kernels.ref``, bit-exact on int32, and the CUDA kernel's
instruction table (``fabric_stream.lower``) against the plain evaluator.

The CUDA kernel itself runs only on a card; what it interprets is the
table that ``lower`` builds here on the CPU. ``_run_table`` below executes
that table with the semantics of ``csrc/fabric.cu`` (uint32 arithmetic;
each lane of at most ``BLOCK_LANE`` elements folded in one pass, longer
lanes as per-slice partials folded per lane, as ``fabric_reduce.
lane_layout`` says), so a lowering or layout fault shows up in the CPU
tests and not first on the chip.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels_lib as RK
from repro.kernels import ref as rref
from repro_torch.convert import dfg_from_reference
from repro_torch.core import kernels_lib as K
from repro_torch.core.dfg import DFG
from repro_torch.core.isa import AluOp, CmpOp
from repro_torch.engine.capabilities import backend_skip_reason
from repro_torch.kernels import fabric_reduce as fr
from repro_torch.kernels import fabric_stream as fs
from repro_torch.kernels import ref
from test_conformance import N_CASES, _mk_case


def _full_range(rng, shape):
    return rng.integers(-2 ** 31, 2 ** 31, size=shape,
                        dtype=np.int64).astype(np.int32)


def _both(g_ref, ins):
    """(reference, port) eval_dfg_streams on the same numpy inputs."""
    want = rref.eval_dfg_streams(g_ref, {k: jnp.asarray(v)
                                         for k, v in ins.items()})
    got = ref.eval_dfg_streams(dfg_from_reference(g_ref),
                               {k: torch.from_numpy(v)
                                for k, v in ins.items()})
    return want, got


def _assert_streams_equal(want, got, shape):
    (w_outs, w_red, w_of), (g_outs, g_red, g_of) = want, got
    assert set(w_outs) == set(g_outs) and set(w_red) == set(g_red)
    assert w_of == g_of
    for k in w_outs:
        w = np.broadcast_to(np.asarray(w_outs[k]), shape)
        g = g_outs[k].expand(shape).numpy()
        np.testing.assert_array_equal(g, w, err_msg=k)
    for k in w_red:
        np.testing.assert_array_equal(
            g_red[k].expand(shape).numpy(),
            np.broadcast_to(np.asarray(w_red[k]), shape), err_msg=k)


# ---------------------------------------------------------------------------
# plain evaluator vs reference
# ---------------------------------------------------------------------------

REF_KERNELS = {
    "fft": RK.fft_butterfly,
    "relu": RK.relu,
    "mac1": lambda: RK.mac1(64),
    "mac3": lambda: RK.mac3(64),
    "mac2x": lambda: RK.mac2x(64),
    "axpby": lambda: RK.axpby(3, 5),
    "scale_add": lambda: RK.scale_add(4),
    "conv2d_row": lambda: RK.conv2d_row(1, -2, 3),
    "outer_row2": lambda: RK.outer_row2(2, -3, 5, 1),
}


@pytest.mark.parametrize("name", sorted(REF_KERNELS))
@pytest.mark.parametrize("shape", [(1,), (64,), (3, 257)])
def test_plain_matches_reference(name, shape):
    g = REF_KERNELS[name]()
    rng = np.random.default_rng(11)
    ins = {k: _full_range(rng, shape) for k in g.inputs}
    _assert_streams_equal(*_both(g, ins), shape)


@pytest.mark.parametrize("name", ["dither", "find2min"])
def test_loop_carried_one_shots_raise_the_reference_error(name):
    g = RK.ONE_SHOT[name]()
    ins = {k: np.arange(8, dtype=np.int32) for k in g.inputs}
    with pytest.raises(ValueError) as want:
        rref.eval_dfg_streams(g, {k: jnp.asarray(v) for k, v in ins.items()})
    with pytest.raises(ValueError) as got:
        ref.eval_dfg_streams(dfg_from_reference(g),
                             {k: torch.from_numpy(v) for k, v in ins.items()})
    assert str(got.value) == str(want.value)


def test_plain_matches_reference_on_conformance_corpus():
    """Every corpus case: eligible ones evaluate bit-exact, the others raise
    the reference's error (or are skipped by both capability gates)."""
    eligible = 0
    for seed in range(N_CASES):
        length = (8, 16, 24)[seed % 3]
        g_ref, inputs, _ = _mk_case(seed, length)
        if backend_skip_reason(dfg_from_reference(g_ref), length) is None:
            eligible += 1
            _assert_streams_equal(*_both(g_ref, inputs), (length,))
            continue
        try:
            rref.eval_dfg_streams(g_ref, {k: jnp.asarray(v)
                                          for k, v in inputs.items()})
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                ref.eval_dfg_streams(
                    dfg_from_reference(g_ref),
                    {k: torch.from_numpy(v) for k, v in inputs.items()})
            assert str(got.value) == str(e)
    assert eligible == 76


def test_nonreducible_merge_raises_the_reference_error():
    from repro.core import dfg as RD
    b = RD.DFG.build("bad_merge")
    x, y = b.inp("x"), b.inp("y")
    b.out("out", b.merge("m", x, y))
    g = b.done()
    with pytest.raises(ValueError) as want:
        rref.eval_dfg_elementwise(g, {"x": jnp.arange(4),
                                      "y": jnp.arange(4)})
    with pytest.raises(ValueError, match="select-reducible") as got:
        ref.eval_dfg_elementwise(dfg_from_reference(g),
                                 {"x": torch.arange(4), "y": torch.arange(4)})
    assert str(got.value) == str(want.value)


def test_elementwise_rejects_reductions_with_the_reference_error():
    g = RK.mac1(8)
    ins = {k: np.ones(8, np.int32) for k in g.inputs}
    with pytest.raises(ValueError) as want:
        rref.eval_dfg_elementwise(g, {k: jnp.asarray(v)
                                      for k, v in ins.items()})
    with pytest.raises(ValueError) as got:
        ref.eval_dfg_elementwise(dfg_from_reference(g),
                                 {k: torch.from_numpy(v)
                                  for k, v in ins.items()})
    assert str(got.value) == str(want.value)


EDGE = np.array([-2 ** 31, -2 ** 31 + 1, -65536, -33, -32, -31, -1, 0, 1, 2,
                 31, 32, 33, 46341, 65535, 2 ** 31 - 2, 2 ** 31 - 1],
                dtype=np.int32)


@pytest.mark.parametrize("op", list(AluOp))
def test_node_eval_wraps_and_masks_shifts_like_the_reference(op):
    from repro.core.isa import AluOp as RAluOp
    a = np.repeat(EDGE, len(EDGE))
    b = np.tile(EDGE, len(EDGE))
    want = np.asarray(rref.dfg_node_eval(RAluOp[op.name], jnp.asarray(a),
                                         jnp.asarray(b)))
    got = ref.dfg_node_eval(op, torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cmp_tests_the_wrapped_difference():
    b = DFG.build("cmpw")
    x, y = b.inp("x"), b.inp("y")
    b.out("gt", b.cmp("c_gt", CmpOp.GTZ, x, y))
    b.out("eq", b.cmp("c_eq", CmpOp.EQZ, x, const_b=-2 ** 31))
    g = b.done()
    x = torch.tensor([2 ** 31 - 1, -2 ** 31, 5, -2 ** 31], dtype=torch.int32)
    y = torch.tensor([-1, 1, 5, 0], dtype=torch.int32)
    outs, _, _ = ref.eval_dfg_streams(g, {"x": x, "y": y})
    # INT_MAX - (-1) wraps negative; INT_MIN - 1 wraps positive
    assert outs["gt"].tolist() == [0, 1, 0, 0]
    assert outs["eq"].tolist() == [0, 1, 0, 1]


@pytest.mark.parametrize("op", [AluOp.ADD, AluOp.SUB, AluOp.MUL, AluOp.AND,
                                AluOp.OR, AluOp.XOR])
@pytest.mark.parametrize("length", [0, 1, 5, 1000])
def test_fold_lanes_matches_a_sequential_fold(op, length):
    rng = np.random.default_rng(int(op) * 100 + length)
    x = _full_range(rng, (3, length))
    if op == AluOp.MUL:
        x = x | 1                  # odd factors: the product stays nonzero
    got = ref.fold_lanes(op, -5, torch.from_numpy(x))
    for k in range(3):
        acc = -5
        for v in x[k].tolist():
            acc = int(ref.dfg_node_eval(op, torch.tensor(acc),
                                        torch.tensor(v)))
        assert int(got[k]) == acc


# ---------------------------------------------------------------------------
# the kernel's instruction table, executed with fabric.cu's semantics
# ---------------------------------------------------------------------------

def _alu_u32(op, a, b):
    ua, ub = a.astype(np.uint32), b.astype(np.uint32)
    with np.errstate(over="ignore"):
        if op == AluOp.ADD:
            r = ua + ub
        elif op == AluOp.SUB:
            r = ua - ub
        elif op == AluOp.MUL:
            r = ua * ub
        elif op == AluOp.SHL:
            r = ua << (ub & 31)
        elif op == AluOp.SHR:
            return a.astype(np.int32) >> (ub & 31).astype(np.int32)
        elif op == AluOp.AND:
            r = ua & ub
        elif op == AluOp.OR:
            r = ua | ub
        elif op == AluOp.XOR:
            r = ua ^ ub
        else:
            return a.astype(np.int32)
    return r.astype(np.uint32).view(np.int32)


def _combine(op, a, b):
    return _alu_u32(AluOp.ADD if op == AluOp.SUB else op, a, b)


def _run_table(prog, ins):
    """Interpret ``prog.table`` over ``(N, L)`` numpy lanes as fabric.cu
    does: every element runs the table; each reduction folds a lane in one
    pass where ``fr.lane_layout`` gives it no partials, else folds each
    ``BLOCK_LANE``-element slice into a partial and the partials into
    acc_init."""
    n, length = next(iter(ins.values())).shape
    val = [None] * prog.n_slots
    ok = [None] * prog.n_slots
    full = [None] * len(prog.full_names)
    red_x = [None] * len(prog.red_names)
    shape = (n, length)
    for kind, op, dst, a, b, c, imm, aux in prog.table.tolist():
        imm_arr = np.full(shape, imm, np.int32)
        if kind == fs.K_INPUT:
            val[dst], ok[dst] = ins[prog.in_names[a]], np.ones(shape, bool)
        elif kind == fs.K_CONST:
            val[dst], ok[dst] = imm_arr, np.ones(shape, bool)
        elif kind == fs.K_ALU:
            vb, mb = (val[b], ok[b]) if b >= 0 else (imm_arr, ok[a])
            val[dst], ok[dst] = _alu_u32(AluOp(op), val[a], vb), ok[a] & mb
        elif kind == fs.K_CMP:
            if b >= 0:
                d, m = _alu_u32(AluOp.SUB, val[a], val[b]), ok[a] & ok[b]
            else:
                d, m = _alu_u32(AluOp.SUB, val[a], imm_arr), ok[a]
            r = (d == 0) if op == CmpOp.EQZ else (d > 0)
            val[dst], ok[dst] = r.astype(np.int32), m
        elif kind == fs.K_MUX:
            vb, mb = (val[b], ok[b]) if b >= 0 else (imm_arr, ok[a])
            val[dst] = np.where(val[c] != 0, val[a], vb)
            ok[dst] = ok[a] & mb & ok[c]
        elif kind == fs.K_BRANCH:
            m = ok[a] & ok[c]
            val[dst] = val[b] = val[a]
            ok[dst], ok[b] = m & (val[c] != 0), m & (val[c] == 0)
        elif kind == fs.K_MERGE:
            val[dst] = np.where(ok[a], val[a], val[b])
            ok[dst] = ok[a] | ok[b]
        elif kind == fs.K_RED:
            red_x[aux] = val[a] if a >= 0 else imm_arr
        elif kind == fs.K_OUT:
            full[aux] = val[a]
    _, per_lane = fr.lane_layout(len(prog.red_names), length)
    unit = fr.BLOCK_LANE if per_lane else max(length, 1)
    n_units = max(per_lane, 1)
    reds = []
    for r, (op, init) in enumerate(zip(prog.red_ops, prog.red_inits)):
        op = AluOp(op)
        ident = int(ref.IDENTITY[op])
        x = np.full((n, n_units * unit), ident, np.int32)
        x[:, :length] = red_x[r]
        part = x.reshape(n, n_units, unit)
        while part.shape[2] > 1:          # any order is exact: tree-fold
            h = (part.shape[2] + 1) // 2
            pad = np.full((n, n_units, 2 * h - part.shape[2]), ident,
                          np.int32)
            part = np.concatenate([part, pad], axis=2)
            part = _combine(op, part[:, :, :h], part[:, :, h:])
        s = part[:, :, 0]
        if per_lane:                      # the fold kernel's second pass
            acc_s = np.full(n, ident, np.int32)
            for k in range(per_lane):
                acc_s = _combine(op, acc_s, s[:, k])
            s = acc_s
        else:
            s = s[:, 0]
        acc = np.full(n, init, np.int32)
        reds.append(_alu_u32(AluOp.SUB, acc, s) if op == AluOp.SUB
                    else _combine(op, acc, s))
    return full, reds


def _branch_legs():
    b = DFG.build("legs")
    x, y = b.inp("x"), b.inp("y")
    c = b.cmp("c", CmpOp.GTZ, x)
    bx, by = b.branch("bx", x, c), b.branch("by", y, c)
    t1 = b.alu("t1", AluOp.MUL, bx, const_b=3, a_port="t")
    t2 = b.alu("t2", AluOp.XOR, t1, by, b_port="t")
    f1 = b.alu("f1", AluOp.SUB, bx, by, a_port="f", b_port="f")
    f2 = b.alu("f2", AluOp.SHL, f1, const_b=2)
    b.out("out", b.merge("m", t2, f2))
    return b.done()


def _reduction(op):
    b = DFG.build(f"red_{op.name}")
    x, y = b.inp("x"), b.inp("y")
    m = b.alu("m", AluOp.ADD, x, y)
    b.out("sum", b.alu("s", op, m, acc_init=-7, emit_every=0))
    b.out("m_out", m)
    return b.done()


TABLE_CASES = {
    "fft": K.fft_butterfly, "relu": K.relu, "mac3": lambda: K.mac3(16),
    "mac2x": lambda: K.mac2x(16), "conv2d_row": lambda: K.conv2d_row(1, -2, 3),
    "outer_row2": lambda: K.outer_row2(2, -3, 5, 1), "legs": _branch_legs,
    **{f"red_{op.name}": (lambda op=op: _reduction(op))
       for op in (AluOp.ADD, AluOp.SUB, AluOp.MUL, AluOp.AND, AluOp.OR,
                  AluOp.XOR)},
}


@pytest.mark.parametrize("name", sorted(TABLE_CASES))
@pytest.mark.parametrize("n_lanes,length", [(1, 1), (3, 1023), (2, 1025),
                                            (1, 3000), (3, 257), (2, 4097),
                                            (1, 9000)])
def test_lowered_table_matches_plain(name, n_lanes, length):
    g = TABLE_CASES[name]()
    rng = np.random.default_rng(len(name) * 1000 + length)
    ins = {k: _full_range(rng, (n_lanes, length)) for k in g.inputs}
    prog = fs.lower(g)
    full, reds = _run_table(prog, ins)
    outs, red_ins, _ = ref.eval_dfg_streams(
        g, {k: torch.from_numpy(v) for k, v in ins.items()})
    for o, v in zip(prog.full_names, full):
        np.testing.assert_array_equal(
            np.broadcast_to(v, (n_lanes, length)),
            outs[o].expand(n_lanes, length).numpy(), err_msg=o)
    for r, v in zip(prog.red_names, reds):
        node = g.nodes[r]
        want = ref.fold_lanes(node.op, node.acc_init,
                              red_ins[r].expand(n_lanes, length))
        np.testing.assert_array_equal(v, want.numpy(), err_msg=r)


def test_lowered_table_matches_plain_on_conformance_corpus():
    n_checked = 0
    for seed in range(N_CASES):
        length = (8, 16, 24)[seed % 3]
        g_ref, inputs, refs = _mk_case(seed, length)
        g = dfg_from_reference(g_ref)
        if backend_skip_reason(g, length) is not None:
            continue
        prog = fs.lower(g)
        full, reds = _run_table(prog, {k: v[None] for k, v in inputs.items()})
        got = dict(zip(prog.full_names, full))
        got.update({o: reds[prog.red_names.index(r)]
                    for o, r in prog.red_of.items()})
        for o, want in refs.items():
            if o in prog.red_of:
                v = got[o]
            else:
                v = np.broadcast_to(got[o], (1, length))[0]
                if g.nodes[o].emit_every == 0:
                    v = v[-1:]
            assert v.tolist() == want, (seed, o)
        n_checked += 1
    assert n_checked == 76


def test_lower_rejects_what_the_kernel_cannot_hold():
    b = DFG.build("wide")
    x = b.inp("x")
    w = x
    for i in range(fs.MAX_SLOTS):
        w = b.alu(f"a{i}", AluOp.ADD, w, const_b=1)
    b.out("out", w)
    from repro_torch.engine.capabilities import CapabilityError
    with pytest.raises(CapabilityError, match="wire slots"):
        fs.lower(b.done())
