"""The port's kernel wrappers on ``device="cpu"`` (their plain PyTorch
versions) against the reference Pallas kernels in interpret mode,
bit-exact on int32: ``fabric_reduce_lanes``, ``run_dfg_lanes``/``run_dfg``
and ``fabric_stream``, plus the named rejections they share."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dfg as RD
from repro.core import kernels_lib as RK
from repro.core.isa import AluOp as RAluOp
from repro.core.isa import CmpOp as RCmpOp
from repro.kernels import fabric_reduce as rfr
from repro.kernels import fabric_stream as rfs
from repro_torch.convert import dfg_from_reference
from repro_torch.engine.capabilities import CapabilityError
from repro_torch.kernels import fabric_reduce as fr
from repro_torch.kernels import fabric_stream as fs

LENGTHS = (0, 1, 127, 1024, 3000)


def _full_range(rng, n):
    return rng.integers(-2 ** 31, 2 ** 31, size=n,
                        dtype=np.int64).astype(np.int32)


def _legs():
    """Branch/Merge with ops on both legs."""
    b = RD.DFG.build("legs")
    x, y = b.inp("x"), b.inp("y")
    c = b.cmp("c", RCmpOp.GTZ, x)
    bx, by = b.branch("bx", x, c), b.branch("by", y, c)
    t = b.alu("t", RAluOp.MUL, bx, by, a_port="t", b_port="t")
    f = b.alu("f", RAluOp.SHR, bx, const_b=3, a_port="f")
    b.out("out", b.merge("m", t, f))
    return b.done()


def _last_value():
    """A stride-0 OMN: the OUTPUT keeps only the stream's last element,
    beside a SUB reduction with a nonzero acc_init."""
    b = RD.DFG.build("last")
    x, y = b.inp("x"), b.inp("y")
    m = b.alu("m", RAluOp.XOR, x, y)
    b.out("last", m)
    b.nodes["last"].emit_every = 0
    b.out("acc", b.alu("a", RAluOp.SUB, m, acc_init=12345, emit_every=0))
    return b.done()


LANE_DFGS = {
    "mac1": lambda n: RK.mac1(n),
    "mac3": lambda n: RK.mac3(n),
    "fft": lambda n: RK.fft_butterfly(),
    "relu": lambda n: RK.relu(),
    "legs": lambda n: _legs(),
    "last_value": lambda n: _last_value(),
}


@pytest.mark.parametrize("name", sorted(LANE_DFGS))
def test_fabric_reduce_lanes_matches_reference(name):
    """1, 3 and 5 lanes with their own data: every reduction carry starts
    from acc_init in each lane, as the reference's does."""
    rng = np.random.default_rng(len(name))
    for n in LENGTHS:
        g_ref = LANE_DFGS[name](n)
        g = dfg_from_reference(g_ref)
        for n_lanes in (1, 3, 5):
            lanes = [{k: _full_range(rng, n) for k in g_ref.inputs}
                     for _ in range(n_lanes)]
            want = rfr.fabric_reduce_lanes(g_ref, lanes, interpret=True)
            got = fr.fabric_reduce_lanes(g, lanes, device="cpu")
            assert len(got) == n_lanes
            for w, o in zip(want, got):
                assert set(w) == set(o)
                for k in w:
                    assert o[k].dtype == np.int32
                    np.testing.assert_array_equal(o[k], w[k],
                                                  err_msg=f"{n} {k}")


def test_stride0_output_keeps_the_last_value():
    g = dfg_from_reference(_last_value())
    x = np.arange(10, dtype=np.int32)
    y = np.full(10, 3, np.int32)
    out = fr.run_dfg(g, {"x": x, "y": y}, device="cpu")
    assert out["last"].tolist() == [9 ^ 3]
    assert out["acc"].tolist() == [12345 - int(np.sum(x ^ y))]


def test_run_dfg_lanes_matches_reference_dispatcher():
    rng = np.random.default_rng(3)
    g_ref = RK.mac2x(300)
    lanes = [{k: _full_range(rng, 300) for k in g_ref.inputs}
             for _ in range(4)]
    want = rfr.run_dfg_lanes(g_ref, lanes, interpret=True)
    got = fr.run_dfg_lanes(dfg_from_reference(g_ref), lanes, device="cpu")
    for w, o in zip(want, got):
        for k in w:
            np.testing.assert_array_equal(o[k], w[k])


def test_unequal_lane_lengths_raise_by_name():
    g = dfg_from_reference(RK.relu())
    with pytest.raises(CapabilityError, match="equal stream lengths"):
        fr.fabric_reduce_lanes(g, [{"x": np.ones(4, np.int32)},
                                   {"x": np.ones(5, np.int32)}],
                               device="cpu")


def test_segmented_reduction_raises_by_name():
    g = dfg_from_reference(RK.mac1(4))
    ins = {k: np.ones(12, np.int32) for k in g.inputs}
    with pytest.raises(CapabilityError, match=r"'s' emits every 4 tokens"):
        fr.run_dfg(g, ins, device="cpu")


def test_capability_gate_names_the_feature():
    g = dfg_from_reference(RK.dither())
    with pytest.raises(CapabilityError, match="loop-state"):
        fr.run_dfg(g, {"x": np.ones(4, np.int32)}, device="cpu")


def test_subrate_output_raises_by_name():
    b = RD.DFG.build("leg_out")
    x = b.inp("x")
    c = b.cmp("c", RCmpOp.GTZ, x)
    br = b.branch("br", x, c)
    b.out("out_t", b.alu("t", RAluOp.ADD, br, const_b=1, a_port="t"))
    b.out("out_f", b.alu("f", RAluOp.SUB, br, const_b=1, a_port="f"))
    g = dfg_from_reference(b.done())
    with pytest.raises(CapabilityError, match="sub-rate"):
        fr.run_dfg(g, {"x": np.arange(-4, 4, dtype=np.int32)}, device="cpu")


def test_length_zero_returns_empty_outputs():
    g = dfg_from_reference(RK.mac3(0))
    before = fr.plain_calls
    out = fr.fabric_reduce_lanes(g, [{k: np.zeros(0, np.int32)
                                      for k in g.inputs}] * 2, device="cpu")
    assert fr.plain_calls == before          # nothing ran
    assert [sorted(o) for o in out] == [["out0", "out1", "out2"]] * 2
    assert all(v.shape == (0,) for o in out for v in o.values())


def test_cpu_tensors_take_the_plain_version_only():
    g = dfg_from_reference(RK.mac3(16))
    ins = {k: torch.ones((2, 16), dtype=torch.int32) for k in g.inputs}
    launches, plain = fr.launches, fr.plain_calls
    full, red = fr.reduce_lanes(g, ins)
    assert fr.launches == launches and fr.plain_calls == plain + 1
    assert red["s0"].tolist() == [16, 16] and not full


FS_CASES = {
    "relu": (RK.relu, ("x",)),
    "fft": (RK.fft_butterfly, ("ar", "ai", "br", "bi")),
    "axpby": (lambda: RK.axpby(3, 5), ("x", "y")),
    "scale_add": (lambda: RK.scale_add(7), ("x", "y")),
    "vadd": (RK.vadd, ("x", "y")),
    "legs": (_legs, ("x", "y")),
}


@pytest.mark.parametrize("name", sorted(FS_CASES))
def test_fabric_stream_matches_reference(name):
    maker, names = FS_CASES[name]
    g_ref = maker()
    g = dfg_from_reference(g_ref)
    rng = np.random.default_rng(5)
    for n in (1, 127, 1024, 3000):
        ins = {k: _full_range(rng, n) for k in names}
        want = rfs.fabric_stream(g_ref, {k: jnp.asarray(v)
                                         for k, v in ins.items()},
                                 interpret=True)
        got = fs.fabric_stream(g, ins, device="cpu")
        for k in want:
            assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)


def test_fabric_stream_keeps_cpu_tensors_on_the_cpu():
    g = dfg_from_reference(RK.relu())
    x = torch.tensor([-3, 0, 7], dtype=torch.int32)
    launches = fs.launches
    assert fs.fabric_stream(g, {"x": x})["out"].tolist() == [0, 0, 7]
    assert fs.launches == launches
    assert fs.fabric_stream(g, {"x": x[:0]})["out"].shape == (0,)


def test_fabric_stream_rejects_reductions_with_the_reference_error():
    g_ref = RK.mac1(8)
    ins = {k: np.ones(8, np.int32) for k in g_ref.inputs}
    with pytest.raises(ValueError) as want:
        rfs.fabric_stream(g_ref, {k: jnp.asarray(v) for k, v in ins.items()},
                          interpret=True)
    with pytest.raises(ValueError) as got:
        fs.fabric_stream(dfg_from_reference(g_ref), ins, device="cpu")
    assert str(got.value) == str(want.value)
