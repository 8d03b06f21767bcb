"""The port's CUDA kernels on the card, against their plain PyTorch
versions on the same device inputs, bit-exact; and the ``"cuda"`` engine
end to end. Marked ``gpu``: each test asks its fixture for the card and
skips, with the reason, where there is none. This file imports neither
``jax`` nor the JAX package, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import kernels_lib as K
from repro_torch.core.dfg import DFG
from repro_torch.core.isa import AluOp, CmpOp
from repro_torch.kernels import fabric_reduce as fr
from repro_torch.kernels import fabric_stream as fs

pytestmark = pytest.mark.gpu

PARITY = {
    "fft": lambda n: K.fft_butterfly(), "relu": lambda n: K.relu(),
    "mac1": K.mac1, "mac3": K.mac3, "mac2x": K.mac2x,
    "axpby": lambda n: K.axpby(3, 5), "scale": lambda n: K.scale(7),
    "scale_add": lambda n: K.scale_add(4), "vadd": lambda n: K.vadd(),
    "conv2d_row3": lambda n: K.conv2d_row3(1, -2, 3),
    "conv2d_row": lambda n: K.conv2d_row(1, -2, 3),
    "outer_row": lambda n: K.outer_row(2, -3),
    "outer_row2": lambda n: K.outer_row2(2, -3, 5, 1),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; none is available here")
    return torch.device("cuda")


def _full_range(rng, shape, device):
    x = rng.integers(-2 ** 31, 2 ** 31, size=shape, dtype=np.int64)
    return torch.from_numpy(x.astype(np.int32)).to(device)


@pytest.mark.parametrize("name", sorted(PARITY))
def test_fabric_reduce_lanes_kernel_matches_plain(cuda, name):
    rng = np.random.default_rng(len(name))
    for length in (0, 1, 127, 1024, 3000, 4096):
        g = PARITY[name](length)
        for n_lanes in (1, 3, 512):
            ins = {k: _full_range(rng, (n_lanes, length), cuda)
                   for k in g.inputs}
            kf, kr = fr.reduce_lanes(g, ins)
            pf, pr = fr.reduce_lanes_plain(g, ins)
            torch.cuda.synchronize()
            for o in pf:
                assert torch.equal(kf[o], pf[o]), (length, n_lanes, o)
            for r in pr:
                assert torch.equal(kr[r], pr[r]), (length, n_lanes, r)


@pytest.mark.parametrize("op", [AluOp.ADD, AluOp.SUB, AluOp.MUL, AluOp.AND,
                                AluOp.OR, AluOp.XOR])
def test_each_reduction_op_folds_like_plain(cuda, op):
    b = DFG.build(f"red_{op.name}")
    x, y = b.inp("x"), b.inp("y")
    m = b.alu("m", AluOp.ADD, x, y)
    b.out("sum", b.alu("s", op, m, acc_init=-7, emit_every=0))
    g = b.done()
    rng = np.random.default_rng(int(op))
    for n_lanes, length in ((1, 1), (3, 1025), (512, 4096), (2, 70000)):
        ins = {k: _full_range(rng, (n_lanes, length), cuda)
               for k in g.inputs}
        _, kr = fr.reduce_lanes(g, ins)
        _, pr = fr.reduce_lanes_plain(g, ins)
        assert torch.equal(kr["s"], pr["s"]), (n_lanes, length)


def test_fabric_stream_kernel_matches_plain(cuda):
    b = DFG.build("legs")
    x, y = b.inp("x"), b.inp("y")
    c = b.cmp("c", CmpOp.GTZ, x)
    bx, by = b.branch("bx", x, c), b.branch("by", y, c)
    t = b.alu("t", AluOp.MUL, bx, by, a_port="t", b_port="t")
    f = b.alu("f", AluOp.SHR, bx, const_b=3, a_port="f")
    b.out("out", b.merge("m", t, f))
    graphs = [b.done(), K.relu(), K.fft_butterfly(), K.axpby(3, 5),
              K.vadd(), K.outer_row2(2, -3, 5, 1)]
    rng = np.random.default_rng(1)
    launches = fs.launches
    for g in graphs:
        for n in (1, 127, 1024, 3000, 1 << 20):
            ins = {k: _full_range(rng, (n,), cuda) for k in g.inputs}
            k, p = fs.stream_kernel(g, ins), fs.stream_plain(g, ins)
            for o in p:
                assert torch.equal(k[o], p[o]), (g.name, n, o)
    assert fs.launches == launches + 5 * len(graphs)


def test_cuda_engine_serves_clients_through_the_kernel(cuda):
    from repro_torch.engine import ArtifactCache, Engine, clients
    rng = np.random.default_rng(2)
    A = rng.integers(-99, 99, (12, 30)).astype(np.int32)
    B = rng.integers(-99, 99, (30, 10)).astype(np.int32)
    C = rng.integers(-99, 99, (12, 10)).astype(np.int32)
    want = (3 * (A.astype(np.int64) @ B) + 2 * C).astype(np.int32)
    eng = Engine(backend="cuda", cache=ArtifactCache(memory_only=True))
    assert eng.device.type == "cuda"
    launches, plain = fr.launches, fr.plain_calls
    clients.run_gemm(eng, 3, A, B, 2, C)
    np.testing.assert_array_equal(C, want)
    assert fr.launches > launches and fr.plain_calls == plain
    assert eng.stats.lane_batches > 0 and eng.stats.lane_batch_failures == 0
