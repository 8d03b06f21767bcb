"""The port's CUDA kernels on the card, against their plain PyTorch
versions on the same device inputs (the fabric kernels bit-exact, the
float kernels within ``tests/test_kernels_pallas.py``'s tolerances, with
TF32 off); and the ``"cuda"`` engine end to end. Marked ``gpu``: each test asks its fixture for the card and
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
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import stream_conv2d as sc
from repro_torch.kernels import stream_matmul as sm

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
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _full_range(rng, shape, device):
    x = rng.integers(-2 ** 31, 2 ** 31, size=shape, dtype=np.int64)
    return torch.from_numpy(x.astype(np.int32)).to(device)


# lane lengths at the edges of the lane kernel's units: a warp's lane
# (fr.WARP_LANE = 256), a block's tile (2048) and lane (fr.BLOCK_LANE =
# 4096, past which lanes split into slices folded by a second kernel)
LANE_LENGTHS = (0, 1, 31, 32, 33, 127, 240, 250, 255, 256, 257, 1024, 1025,
                3000, 4095, 4096, 4097)
LANE_COUNTS = (1, 3, 7, 8, 9, 37, 512)


@pytest.mark.parametrize("name", sorted(PARITY))
def test_fabric_reduce_lanes_kernel_matches_plain(cuda, name):
    rng = np.random.default_rng(len(name))
    shapes = [(n, length) for length in LANE_LENGTHS for n in LANE_COUNTS]
    if name == "mac3":
        shapes.append((14800, 240))          # PolyBench gemm MEDIUM's grid
    for n_lanes, length in shapes:
        g = PARITY[name](length)
        ins = {k: _full_range(rng, (n_lanes, length), cuda)
               for k in g.inputs}
        folds = fr.fold_launches
        kf, kr = fr.reduce_lanes(g, ins)
        pf, pr = fr.reduce_lanes_plain(g, ins)
        torch.cuda.synchronize()
        split = bool(pr) and length > fr.BLOCK_LANE
        assert fr.fold_launches == folds + split, (length, n_lanes)
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
    for n_lanes, length in ((1, 1), (1, 33), (7, 255), (8, 256), (9, 257),
                            (3, 1025), (37, 4095), (512, 4096), (37, 4097),
                            (2, 70000)):
        ins = {k: _full_range(rng, (n_lanes, length), cuda)
               for k in g.inputs}
        _, kr = fr.reduce_lanes(g, ins)
        _, pr = fr.reduce_lanes_plain(g, ins)
        assert torch.equal(kr["s"], pr["s"]), (n_lanes, length)


def _wide_dfg(merge):
    """64 wire slots, the most the kernels hold: x, y and a chain of ALU
    ops; where ``merge``, ending in a Branch/Merge on x > 0 (tracked
    validity bits: the stream kernel runs such a table with one stage)."""
    b = DFG.build("wide_merge" if merge else "wide")
    x, y = b.inp("x"), b.inp("y")
    w = x
    ops = (AluOp.ADD, AluOp.XOR, AluOp.MUL, AluOp.SUB)
    for i in range(56 if merge else 62):
        w = b.alu(f"w{i}", ops[i % 4], w, y if i % 3 else None,
                  const_b=None if i % 3 else 2 * i + 1)
    if merge:
        c = b.cmp("c", CmpOp.GTZ, x)
        bw = b.branch("bw", w, c)
        t = b.alu("t", AluOp.MUL, bw, const_b=3, a_port="t")
        f = b.alu("f", AluOp.SHR, bw, const_b=2, a_port="f")
        w = b.merge("m", t, f)
    b.out("out", w)
    return b.done()


def test_fabric_stream_kernel_matches_plain(cuda):
    b = DFG.build("legs")
    x, y = b.inp("x"), b.inp("y")
    c = b.cmp("c", CmpOp.GTZ, x)
    bx, by = b.branch("bx", x, c), b.branch("by", y, c)
    t = b.alu("t", AluOp.MUL, bx, by, a_port="t", b_port="t")
    f = b.alu("f", AluOp.SHR, bx, const_b=3, a_port="f")
    b.out("out", b.merge("m", t, f))
    graphs = [b.done(), K.relu(), K.fft_butterfly(), K.axpby(3, 5),
              K.vadd(), K.outer_row2(2, -3, 5, 1), _wide_dfg(False),
              _wide_dfg(True)]
    assert [fs.lower(g).n_slots for g in graphs[-2:]] == [fs.MAX_SLOTS] * 2
    # more tiles than the card can hold blocks at once (an SM holds at most
    # 2048 threads), plus 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    many = sms * (2048 // fs.THREADS) + 3
    rng = np.random.default_rng(1)
    launches, n_calls = fs.launches, 0

    def check(g, ins, what):
        nonlocal n_calls
        k, p = fs.stream_kernel(g, ins), fs.stream_plain(g, ins)
        n_calls += 1
        for o in p:
            assert torch.equal(k[o], p[o]), (g.name, what, o)

    for g in graphs:
        _, tile = fs.stream_geometry(fs.lower(g).n_slots)
        for n in (1, 127, 1024, 3000, 1 << 20, tile - 1, tile, tile + 1,
                  many * tile + 1):
            check(g, {k: _full_range(rng, (n,), cuda) for k in g.inputs}, n)
        # streams 4, 8 and 12 bytes past 16-byte alignment: contiguous
        # slices at offsets 1-3, of every stream or of the first only
        for off in (1, 2, 3):
            for first_only in (False, True):
                n = tile + 1
                ins = {k: _full_range(rng, (n + off,), cuda)[
                    off if i == 0 or not first_only else 0:][:n]
                    for i, k in enumerate(g.inputs)}
                assert ins[g.inputs[0]].data_ptr() % 16 == 4 * off
                check(g, ins, (off, first_only))
    torch.cuda.synchronize()
    assert fs.launches == launches + n_calls

    # the wrapper launches on the current stream: inputs written and the
    # kernel launched on a side stream are right once that stream is done
    g = graphs[0]
    src = {k: _full_range(rng, (1 << 20,), cuda) for k in g.inputs}
    ins = {k: torch.empty_like(v) for k, v in src.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for k in ins:
            ins[k].copy_(src[k])
        got = fs.stream_kernel(g, ins)
    side.synchronize()
    want = fs.stream_plain(g, src)
    assert all(torch.equal(got[o], want[o]) for o in want)
    assert fs.launches == launches + n_calls + 1


def test_cuda_engine_serves_clients_through_the_kernel(cuda):
    from repro_torch.engine import ArtifactCache, Engine, clients
    rng = np.random.default_rng(2)
    A = rng.integers(-99, 99, (12, 30)).astype(np.int32)
    B = rng.integers(-99, 99, (30, 10)).astype(np.int32)
    C = rng.integers(-99, 99, (12, 10)).astype(np.int32)
    want = (3 * (A.astype(np.int64) @ B) + 2 * C).astype(np.int32)
    eng = Engine(backend="cuda", cache=ArtifactCache(memory_only=True))
    assert eng.device.type == "cuda"
    launches, plain, folds = fr.launches, fr.plain_calls, fr.fold_launches
    clients.run_gemm(eng, 3, A, B, 2, C)
    np.testing.assert_array_equal(C, want)
    assert fr.launches > launches and fr.plain_calls == plain
    assert fr.fold_launches == folds        # every lane fits one block
    assert eng.stats.lane_batches > 0 and eng.stats.lane_batch_failures == 0


def test_cuda_serve_soak_matches_the_cpu_run(cuda):
    """A virtual-clock soak of the paper mix on the card: every batch and
    every shot through the lane kernel (no fold, no plain version, no
    failed grid), with digests equal to the same soak on the CPU."""
    from repro_torch import bench_serve as pb
    length = 512
    mean_us = pb.calibrate("cuda", length, device="cpu")
    kw = dict(seed=0, n_requests=64, length=length, backend="cuda",
              rate_per_us=2.0 / mean_us)
    launches, plain, folds = fr.launches, fr.plain_calls, fr.fold_launches
    serve, rep = pb.soak(**kw)
    torch.cuda.synchronize()
    assert serve.engine.device.type == "cuda"
    assert fr.launches > launches and fr.plain_calls == plain
    assert fr.fold_launches == folds
    assert serve.engine.stats.lane_batches > 0
    assert serve.engine.stats.lane_batch_failures == 0
    assert rep["failed"] == 0 and rep["served"] > 0
    assert rep["offered"] == rep["served"] + rep["rejected"]
    _, cpu = pb.soak(device="cpu", **kw)
    for k in ("served", "rejected", "preemptions", "trace_digest",
              "results_digest"):
        assert rep[k] == cpu[k], k


def test_cuda_server_serves_exact_results_from_its_worker(cuda):
    """``Server`` runs the engine on a worker thread: its grids launch on
    the engine's device and every answer equals the executor's."""
    from repro_torch.core.executor import execute
    from repro_torch.engine import ArtifactCache, Engine
    from repro_torch.serve import (ServeConfig, Server, request_inputs,
                                   serve_classes)
    length = 1024
    eng = Engine(backend="cuda", cache=ArtifactCache(memory_only=True))
    classes = serve_classes(eng, length)
    rng = np.random.default_rng(7)
    launches, plain = fr.launches, fr.plain_calls
    with Server(eng, ServeConfig(max_wait_us=500.0)) as srv:
        tickets = [(art, srv.submit(art, request_inputs(art, length, rng)))
                   for _ in range(4) for _, art in sorted(classes.items())]
        for art, tk in tickets:
            out = tk.result(timeout=120)
            want = execute(art.dfg, tk.inputs)
            for k in want:
                np.testing.assert_array_equal(out[k], want[k])
    assert not srv._thread.is_alive()
    assert srv.core.report()["served"] == len(tickets)
    assert fr.launches > launches and fr.plain_calls == plain
    assert eng.stats.lane_batch_failures == 0


def test_reduce_lanes_lowers_and_uploads_each_dfg_once(cuda):
    g = K.mac3(240)
    ins = {k: _full_range(np.random.default_rng(5), (9, 240), cuda)
           for k in g.inputs}
    lowered, uploads = fs.lowerings, fs.table_uploads
    first = fr.reduce_lanes(g, ins)[1]
    second = fr.reduce_lanes(g, ins)[1]
    assert (fs.lowerings, fs.table_uploads) == (lowered + 1, uploads + 1)
    for r in first:
        assert torch.equal(first[r], second[r])


def _normal(rng, shape, device, dtype=torch.float32):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(device).to(dtype)


def _offset(x, off):
    """``x``'s values in a contiguous tensor ``off`` elements past an
    aligned allocation."""
    if off == 0:
        return x
    flat = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    y = flat[off:].view(x.shape)
    y.copy_(x)
    return y


F32, BF16 = torch.float32, torch.bfloat16


# the float32 cases hold the SGEMM's edges: K below, at and one past its
# 16-deep k tile and past its ring of four, K % 4 != 0, M and N around its
# 128 x 128 tile, A or B one float past 16-byte alignment (B then takes the
# 4-byte copies), and both output types
@pytest.mark.parametrize("m,k,n,dtype,out_dtype,tol,a_off,b_off", [
    (70, 90, 50, F32, F32, 1e-4, 0, 0),
    (1, 1, 1, F32, F32, 1e-4, 0, 0),
    (300, 300, 300, F32, F32, 1e-4, 0, 0),
    (129, 67, 131, F32, BF16, 2 ** -7, 0, 0),
    (127, 15, 129, F32, F32, 1e-4, 0, 0),
    (129, 16, 127, F32, F32, 1e-4, 0, 0),
    (128, 17, 128, F32, F32, 1e-4, 0, 0),
    (128, 17, 128, F32, BF16, 2 ** -7, 0, 0),
    (257, 65, 255, F32, F32, 1e-4, 0, 0),
    (200, 64, 136, F32, F32, 1e-4, 1, 0),
    (200, 64, 136, F32, F32, 1e-4, 0, 1),
    (200, 64, 136, F32, BF16, 2 ** -7, 1, 1),
    (70, 90, 50, BF16, F32, 5e-2, 0, 0),
    (300, 300, 300, BF16, F32, 5e-2, 0, 0),
    (136, 64, 200, BF16, BF16, 2 ** -7, 0, 0),
])
def test_stream_matmul_kernel_matches_plain(cuda, m, k, n, dtype, out_dtype,
                                            tol, a_off, b_off):
    rng = np.random.default_rng(m + k + n)
    a = _offset(_normal(rng, (m, k), cuda, dtype), a_off)
    b = _offset(_normal(rng, (k, n), cuda, dtype), b_off)
    assert a.is_contiguous() and b.is_contiguous()
    launches = sm.launches
    got = sm.matmul_kernel(a, b, out_dtype)
    want = sm.matmul_plain(a, b, out_dtype)
    torch.cuda.synchronize()
    assert sm.launches == launches + 1 and got.dtype == out_dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("h,w", [(3, 200), (64, 200), (300, 517)])
def test_stream_conv2d_kernel_matches_plain_bit_exact(cuda, h, w):
    rng = np.random.default_rng(h * w)
    img, kern = _normal(rng, (h, w), cuda), _normal(rng, (3, 3), cuda)
    got = sc.conv_kernel(img, kern)
    want = sc.conv_plain(img, kern)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("h,sq,sk,d,causal,dtype", [
    (2, 200, 200, 80, True, torch.float32),
    (2, 128, 1000, 64, False, torch.float32),
    (2, 1, 4096, 64, True, torch.float32),
    (2, 200, 200, 16, True, torch.float32),
    (2, 100, 300, 128, True, torch.float32),
    (3, 150, 70, 16, False, torch.float32),
    (2, 100, 300, 128, True, torch.bfloat16),
])
def test_flash_attention_kernel_matches_plain(cuda, h, sq, sk, d, causal,
                                              dtype):
    rng = np.random.default_rng(sq + sk + d)
    q = _normal(rng, (h, sq, d), cuda, dtype)
    k, v = (_normal(rng, (h, sk, d), cuda, dtype) for _ in range(2))
    got = fa.attention_kernel(q, k, v, causal)
    want = fa.attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    tol = 3e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [
    (64, 64, 256),         # one tile
    (130, 8, 40),          # K = 8
    (100, 72, 96),         # K not a multiple of 64
    (200, 136, 264),       # M and N ragged against the 128 x 256 tile
    (300, 72, 8),          # N = 8
    (257, 520, 264),       # a partial last K step, three row tiles
])
def test_stream_matmul_wgmma_route_edges(cuda, m, k, n, out_dtype):
    rng = np.random.default_rng(m * k + n)
    a = _normal(rng, (m, k), cuda, torch.bfloat16)
    b = _normal(rng, (k, n), cuda, torch.bfloat16)
    assert sm.route(a, b) == "wgmma"
    before = (sm.wgmma_launches, sm.mma_sync_launches)
    got = sm.matmul_kernel(a, b, out_dtype)
    want = sm.matmul_plain(a, b, out_dtype)
    torch.cuda.synchronize()
    assert (sm.wgmma_launches, sm.mma_sync_launches) == (before[0] + 1,
                                                         before[1])
    tol = 5e-2 if out_dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_stream_matmul_misaligned_a_takes_mma_sync(cuda):
    rng = np.random.default_rng(3)
    m, k, n = 100, 64, 128
    a = _normal(rng, (m * k + 1,), cuda, torch.bfloat16)[1:].view(m, k)
    b = _normal(rng, (k, n), cuda, torch.bfloat16)
    assert a.is_contiguous() and a.data_ptr() % 16 == 2
    assert sm.route(a, b) == "mma_sync"
    before = (sm.wgmma_launches, sm.mma_sync_launches)
    got = sm.matmul_kernel(a, b)
    want = sm.matmul_plain(a, b)
    torch.cuda.synchronize()
    assert (sm.wgmma_launches, sm.mma_sync_launches) == (before[0],
                                                         before[1] + 1)
    torch.testing.assert_close(got, want, atol=5e-2, rtol=5e-2)


def test_stream_matmul_cuda_side_refuses_wgmma_on_misaligned_rows(cuda):
    a = torch.ones((16, 12), dtype=torch.bfloat16, device=cuda)
    b = torch.ones((12, 16), dtype=torch.bfloat16, device=cuda)
    launches = sm.wgmma_launches
    with pytest.raises(RuntimeError, match="wgmma"):
        sm._launch_route(a, b, torch.float32, "wgmma")
    assert sm.wgmma_launches == launches
    torch.testing.assert_close(sm._launch_route(a, b, torch.float32,
                                               "mma_sync"),
                               torch.full((16, 16), 12.0, device=cuda))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq", [127, 129, 257])
@pytest.mark.parametrize("d", [16, 80, 128])
def test_flash_attention_query_tile_edges(cuda, d, sq, causal):
    rng = np.random.default_rng(d * sq + causal)
    sk = sq + 37
    q = _normal(rng, (2, sq, d), cuda)
    k, v = (_normal(rng, (2, sk, d), cuda) for _ in range(2))
    launches = fa.launches
    got = fa.attention_kernel(q, k, v, causal)
    want = fa.attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.launches == launches + 1
    torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)


# ---------------------------------------------------------------------------
# the traced frontend: @offload(backend="cuda") on the card
# ---------------------------------------------------------------------------

def _offload_big(x, y):
    t = x
    for i in range(1, 23):                 # 66 PEs: a multi-shot plan
        t = t * 3 + y + i
    return t


def _offload_cond(x):
    return torch.cond(x > 0, lambda v: v * 3 - 1, lambda v: v + 7, (x,))


@pytest.mark.parametrize("name,fn,n_in", [
    ("mac1", lambda a, b0: torch.sum(a * b0), 2),
    ("cond", _offload_cond, 1),
    ("big", _offload_big, 2),
])
def test_offload_cuda_matches_sim_on_the_card(cuda, name, fn, n_in):
    """Traced kernels through ``@offload(backend="cuda")``: values from the
    lane kernel, bit-exact against ``backend="sim"``, the multi-shot tally
    equal to sim's, and the plain version never called."""
    from repro_torch.engine import ArtifactCache
    from repro_torch.frontend import offload
    rng = np.random.default_rng(4)
    ins = [rng.integers(-1000, 1000, 1024).astype(np.int32)
           for _ in range(n_in)]
    kc = offload(fn, backend="cuda", name=name, debug=True,
                 cache=ArtifactCache(memory_only=True))
    ks = offload(fn, backend="sim", name=name,
                 cache=ArtifactCache(memory_only=True))
    assert kc.device.type == "cuda"
    launches, plain = fr.launches, fr.plain_calls
    got = kc(*ins)
    assert fr.launches - launches == kc.last.n_shots
    assert fr.plain_calls == plain
    want = ks(*ins)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)
    if kc.last.n_shots > 1:
        assert kc.last.tally == ks.last.tally


def test_cuda_model_mix_soak_matches_the_cpu_run(cuda):
    """A virtual-clock soak of the model-layer mix on the card: the SSM
    classes dropped by name, every batch and shot through the lane kernel
    (no fold, no plain version), every response equal to its oracle, and
    digests equal to the same soak on the CPU."""
    from repro_torch import bench_serve as pb
    length = 512
    mean_us = pb.calibrate("cuda", length, device="cpu", mix="model")
    kw = dict(seed=0, n_requests=48, length=length, backend="cuda",
              rate_per_us=2.0 / mean_us, mix="model")
    launches, plain, folds = fr.launches, fr.plain_calls, fr.fold_launches
    serve, rep = pb.soak(**kw)
    torch.cuda.synchronize()
    assert serve.engine.device.type == "cuda"
    assert fr.launches > launches and fr.plain_calls == plain
    assert fr.fold_launches == folds
    assert serve.engine.stats.lane_batch_failures == 0
    assert rep["failed"] == 0 and rep["served"] > 0
    assert rep["oracle_checked"] == rep["served"]
    assert rep["oracle_mismatches"] == 0
    assert not {tk.artifact.name for tk in serve.served} & {"ssm_scan",
                                                           "ssm_relax"}
    _, cpu = pb.soak(device="cpu", **kw)
    for k in ("served", "rejected", "preemptions", "trace_digest",
              "results_digest"):
        assert rep[k] == cpu[k], k


def test_cuda_fleet_matches_the_cpu_run(cuda):
    """Two ``"cuda"`` fabrics on the card, one failing mid-soak, over
    paper and model classes: the lane kernel launched and its plain
    version never, and the report and digests equal to the same fleet on
    the CPU."""
    from repro_torch.engine import ArtifactCache
    from repro_torch.fleet import fleet_soak, homogeneous
    cfg = homogeneous(2, backend="cuda", length=512, n_requests=40,
                      rate_per_us=0.05,
                      classes=("relu", "mac1", "attn_score", "moe_gate",
                               "swiglu_ms"),
                      fail_at=(("f1", 300.0),))
    launches, plain = fr.launches, fr.plain_calls
    fleet, rep = fleet_soak(3, cfg, cache=ArtifactCache(memory_only=True))
    torch.cuda.synchronize()
    assert all(w.engine.device.type == "cuda" for w in fleet.workers)
    assert fr.launches > launches and fr.plain_calls == plain
    assert rep["failed"] == 0 and rep["dead"] == ["f1"]
    assert rep["offered"] == rep["served"] + rep["rejected"]
    cpu_fleet, cpu = fleet_soak(3, cfg, cache=ArtifactCache(memory_only=True),
                                device="cpu")
    for k in ("served", "rejected", "drained", "steals", "latency",
              "trace_digest"):
        assert rep[k] == cpu[k], k
    assert fleet.results_digest() == cpu_fleet.results_digest()


# the LM serving path (chip_smoke.py phase 14): minicpm-2b serves batch 4,
# so attention runs 4 x 36 = 144 heads at d = 64, one query against the
# 1..48 cached keys while decoding and sq = sk for a prefill
@pytest.mark.parametrize("sq,sk", [(1, 1), (1, 17), (1, 49), (1024, 1024)])
def test_flash_attention_at_the_lm_shapes(cuda, sq, sk):
    rng = np.random.default_rng(sq * sk)
    q = _normal(rng, (144, sq, 64), cuda)
    k, v = (_normal(rng, (144, sk, 64), cuda) for _ in range(2))
    got = fa.attention_kernel(q, k, v, True)
    want = fa.attention_plain(q, k, v, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)


def test_serve_lm_at_full_width_launches_flash_per_layer_and_step(cuda):
    """minicpm-2b at full width, cut to 2 layers, serving batch 4 x (32 +
    16) tokens on the card: one flash launch per layer and decode step and
    no plain call; the tokens in the vocab, the logits finite, and the
    first step's logits within the reference's decode tolerance of the
    same parameters on the CPU."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model, transformer
    cfg = dataclasses.replace(get_arch("minicpm-2b"), n_layers=2)
    api = build_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32))
    cpu_logits, _ = api.decode_step(
        params, transformer.init_caches(cfg, 4, 49, device="cpu"),
        prompt[:, :1], 0)
    params, prompt = params.to(cuda), prompt.to(cuda)
    first, _ = api.decode_step(
        params, transformer.init_caches(cfg, 4, 49, device=cuda),
        prompt[:, :1], 0)
    torch.testing.assert_close(first.cpu().float(), cpu_logits.float(),
                               atol=3e-2, rtol=3e-2)
    launches, plain = fa.launches, fa.plain_calls
    with torch.inference_mode():
        res = serve_lm.generate(api, params, prompt, 16)
    assert fa.launches - launches == 2 * (32 + 16)
    assert fa.plain_calls == plain
    assert res["tokens"].shape == (4, 16)
    assert res["tokens"].min() >= 0 and res["tokens"].max() < cfg.vocab
    assert res["logits"].device.type == "cuda"
    assert bool(torch.isfinite(res["logits"].float()).all())


# the MoE layer at granite-moe-3b-a800m's widths (chip_smoke.py phase 15):
# D 1536, F 512, 40 experts top-8, bf16 parameters from seed 0; batch 4 at
# decode (N = 4, C = 1) and a 128-token prefill (N = 128, C = 32)
def _granite_moe():
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as M
    cfg = get_arch("granite-moe-3b-a800m")
    p = M.moe_init(torch.Generator().manual_seed(0), cfg.d_model, cfg.d_ff,
                   cfg.moe, torch.bfloat16)
    return cfg, p


def _moved(p, device):
    return {k: _moved(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in p.items()}


def _moe_input(cfg, n, seed=0):
    x = torch.randn(4, n // 4, cfg.d_model,
                    generator=torch.Generator().manual_seed(seed))
    return x.to(torch.bfloat16)


@pytest.mark.parametrize("n", [4, 128])
def test_moe_apply_on_the_card_matches_the_cpu(cuda, n):
    """Card run against a CPU run on the same parameters and input: the
    same experts chosen, outputs within the LM tolerance (3e-2), the aux
    loss within float32 rounding."""
    from repro_torch.models import moe as M
    cfg, p = _granite_moe()
    x = _moe_input(cfg, n)
    cpu_out, cpu_aux = M.moe_apply(p, cfg.moe, cfg.d_ff, x)
    _, _, cpu_idx = M.route(p, cfg.moe, x)
    pc, xc = _moved(p, cuda), x.to(cuda)
    out, aux = M.moe_apply(pc, cfg.moe, cfg.d_ff, xc)
    _, _, idx = M.route(pc, cfg.moe, xc)
    assert torch.equal(idx.cpu(), cpu_idx)
    assert out.device.type == "cuda" and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.cpu().float(), cpu_out.float(),
                               atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(aux.cpu(), cpu_aux, atol=0, rtol=1e-5)


def test_moe_apply_on_the_card_is_bit_identical_across_runs(cuda):
    """No float atomics: two card runs give the same bits (a CPU run
    alike), at both token counts."""
    from repro_torch.models import moe as M
    cfg, p = _granite_moe()
    pc = _moved(p, cuda)
    for n in (4, 128):
        x = _moe_input(cfg, n, seed=n)
        for params, xs in ((pc, x.to(cuda)), (p, x)):
            a = M.moe_apply(params, cfg.moe, cfg.d_ff, xs)
            b = M.moe_apply(params, cfg.moe, cfg.d_ff, xs)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_moe_apply_makes_no_host_sync_on_the_card(cuda):
    """``moe_apply`` under ``set_sync_debug_mode("error")`` on the card
    (any operation that waits for the device raises), then its result
    against a CPU run."""
    from repro_torch.models import moe as M
    cfg, p = _granite_moe()
    x = _moe_input(cfg, 4)
    pc, xc = _moved(p, cuda), x.to(cuda)
    M.moe_apply(pc, cfg.moe, cfg.d_ff, xc)          # warm: allocations
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ = M.moe_apply(pc, cfg.moe, cfg.d_ff, xc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.testing.assert_close(out.cpu().float(),
                               M.moe_apply(p, cfg.moe, cfg.d_ff, x)[0].float(),
                               atol=3e-2, rtol=3e-2)


def test_serve_lm_moe_at_full_width_launches_flash_per_layer_and_step(cuda):
    """granite-moe-3b-a800m at full width, cut to 2 layers, serving batch
    4 x (32 + 16) tokens on the card: one flash launch per layer and
    step, no plain call, tokens in the vocab, finite logits."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m"), n_layers=2)
    api = build_model(cfg)
    params = api.init_params(torch.Generator(cuda).manual_seed(0))
    assert params.layers[0].moe.router.dtype == torch.float32
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32)).to(cuda)
    launches, plain = fa.launches, fa.plain_calls
    with torch.inference_mode():
        res = serve_lm.generate(api, params, prompt, 16)
    assert fa.launches - launches == 2 * (32 + 16)
    assert fa.plain_calls == plain
    assert res["tokens"].shape == (4, 16)
    assert res["tokens"].min() >= 0 and res["tokens"].max() < cfg.vocab
    assert bool(torch.isfinite(res["logits"][:, :cfg.vocab].float()).all())


# the SSD layer and the hybrid (chip_smoke.py phase 16): one layer at
# mamba2-1.3b's and zamba2-2.7b's widths, and both models at full width
# cut to 2 SSD layers and to 6 (one site of zamba2's shared block)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_ssd_layer_on_the_card_matches_the_cpu(cuda, arch, dtype):
    """The chunked form at S = 256 and 512 (one and two chunks), then 4
    decode steps from the carried state: card against CPU within the LM
    tolerance (3e-2), two card runs bit-identical, and no host sync under
    sync-debug "error"."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import ssm as S
    cfg = dataclasses.replace(get_arch(arch), dtype=str(dtype)[6:])
    p = S.ssm_init(torch.Generator().manual_seed(0), cfg, dtype)
    pc = {k: v.to(cuda) for k, v in p.items()}
    x = torch.randn(1, 516, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(dtype)
    xc = x.to(cuda)
    with torch.inference_mode():
        for seq in (256, 512):
            want, wst = S.ssm_forward(p, cfg, x[:, :seq])
            got, gst = S.ssm_forward(pc, cfg, xc[:, :seq])
            again, _ = S.ssm_forward(pc, cfg, xc[:, :seq])
            assert torch.equal(got, again)
            torch.testing.assert_close(got.cpu().float(), want.float(),
                                       atol=3e-2, rtol=3e-2)
        wst = tuple(t.clone() for t in wst)
        gst = tuple(t.clone() for t in gst)
        for t in range(512, 516):
            want, wst = S.ssm_forward(p, cfg, x[:, t:t + 1], wst)
            got, gst = S.ssm_forward(pc, cfg, xc[:, t:t + 1], gst)
            torch.testing.assert_close(got.cpu().float(), want.float(),
                                       atol=3e-2, rtol=3e-2)
        torch.testing.assert_close(gst[1].cpu(), wst[1], atol=3e-2,
                                   rtol=3e-2)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            S.ssm_forward(pc, cfg, xc[:, :256])
            S.ssm_forward(pc, cfg, xc[:, 512:513], gst)
        finally:
            torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("arch,n_layers,sites", [("mamba2-1.3b", 2, 0),
                                                 ("zamba2-2.7b", 6, 1)])
def test_serve_lm_ssm_and_hybrid_at_full_width(cuda, arch, n_layers, sites):
    """Full width cut in depth, serving batch 4 x (32 + 16) on the card in
    bf16: a flash launch per site and step and no plain call; the tokens
    in the vocab and the logits finite. Before it, the first decode step
    of the same weights in float32 within the LM tolerance of the CPU
    (bf16 rounding differs between the card's and the CPU's GEMMs and adds
    up over the layers)."""
    import copy
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    api, api32 = build_model(cfg), build_model(cfg32)
    params = api.init_params(torch.Generator().manual_seed(0))
    f32 = copy.deepcopy(params).float()
    f32.cfg = cfg32
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32))
    with torch.inference_mode():
        cpu_logits, _ = api32.decode_step(
            f32, serve_lm.init_decode_state(cfg32, 4, 49, "cpu"),
            prompt[:, :1], 0)
        first, _ = api32.decode_step(
            f32.to(cuda), serve_lm.init_decode_state(cfg32, 4, 49, cuda),
            prompt[:, :1].to(cuda), 0)
    torch.testing.assert_close(first.cpu(), cpu_logits, atol=3e-2,
                               rtol=3e-2)
    params, prompt = params.to(cuda), prompt.to(cuda)
    launches, plain = fa.launches, fa.plain_calls
    with torch.inference_mode():
        res = serve_lm.generate(api, params, prompt, 16)
    assert fa.launches - launches == sites * (32 + 16)
    assert fa.plain_calls == plain
    assert res["tokens"].shape == (4, 16)
    assert res["tokens"].min() >= 0 and res["tokens"].max() < cfg.vocab
    assert bool(torch.isfinite(res["logits"][:, :cfg.vocab].float()).all())


# the Whisper encoder-decoder (chip_smoke.py phase 17): whisper-base at
# batch 4 runs 4 x 8 = 32 heads at d = 64: the encoder non-causal over its
# 1500 frames (11 query tiles of 128 and one of 92), the decoder's
# self-attention causal over its cache, and cross-attention non-causal of
# one query (a decode step) or of the prompt against the 1500 frames
@pytest.mark.parametrize("sq,sk,causal", [(1500, 1500, False),
                                          (1, 1500, False),
                                          (32, 1500, False),
                                          (1, 49, True)])
def test_flash_attention_at_the_whisper_shapes(cuda, sq, sk, causal):
    rng = np.random.default_rng(sq + sk)
    q = _normal(rng, (32, sq, 64), cuda)
    k, v = (_normal(rng, (32, sk, 64), cuda) for _ in range(2))
    got = fa.attention_kernel(q, k, v, causal)
    want = fa.attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)


def test_reduced_whisper_on_the_card_matches_the_cpu(cuda):
    """whisper-base reduced, float32, from the same parameters on the card
    and on the CPU: the encoder and decoder's logits, the loss, prefill
    and decode steps within the LM's float32 tolerance (2e-4)."""
    import copy
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models import encdec as E
    cfg = dataclasses.replace(get_arch("whisper-base").reduced(),
                              dtype="float32")
    api = build_model(cfg)
    cpu = api.init_params(torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.encdec.enc_len, cfg.d_model)).astype(np.float32) * 0.02)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)).astype(
        np.int32))
    out = {}
    for label, params in (("cpu", cpu), ("card", card)):
        dev = params.embed.device
        f, t = frames.to(dev), toks.to(dev)
        with torch.inference_mode():
            enc = E.encode(params, cfg, f)
            logits = E.decode(params, cfg, t, enc)[0]
            loss = api.loss(params, {"tokens": t[:, :8], "targets": t[:, 1:9],
                                     "frames": f})[0]
            pre, _ = api.prefill(params, {"tokens": t[:, :8], "frames": f})
            state = (enc, E.init_caches(cfg, 2, 12, device=dev))
            steps = [api.decode_step(params, state, t[:, i:i + 1], i)[0]
                     for i in range(12)]
        out[label] = [x.cpu() for x in [enc, logits, loss, pre] + steps]
    for got, want in zip(out["card"], out["cpu"]):
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


def test_serve_lm_whisper_at_full_width_launches_flash_582_times(cuda):
    """whisper-base at full width (6 + 6 layers, 1500 frames, bf16)
    serving batch 4 x (32 + 16) through ``serve_lm.generate``: the
    encoder's 6 flash launches in the prefill, then 6 self- and 6
    cross-attention launches a step, 6 + 48 x 12 = 582, and no plain
    call; the tokens in the vocab and the logits finite."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model
    cfg = get_arch("whisper-base")
    api = build_model(cfg)
    params = api.init_params(torch.Generator(cuda).manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32)).to(cuda)
    launches, plain = fa.launches, fa.plain_calls
    with torch.inference_mode():
        res = serve_lm.generate(api, params, prompt, 16)
    assert fa.launches - launches == 6 + 48 * 12 == 582
    assert fa.plain_calls == plain
    assert res["tokens"].shape == (4, 16)
    assert res["tokens"].min() >= 0 and res["tokens"].max() < cfg.vocab
    assert bool(torch.isfinite(res["logits"][:, :cfg.vocab].float()).all())


# training (chip_smoke.py phase 18): the flash backward kernels against
# the plain backward and autograd of the plain forward, at the reduced
# models' d = 16 and at every shape training reaches at batch 4 (minicpm-2b,
# zamba2-2.7b's shared block at d = 80, d = 128, whisper-base's encoder and
# cross-attention); two runs bit-identical
BWD_CASES = [(2, 5, 9, 16, True), (3, 130, 200, 16, False),
             (4, 70, 70, 16, True), (144, 512, 512, 64, True),
             (128, 512, 512, 80, True), (64, 512, 512, 128, True),
             (32, 1500, 1500, 64, False), (32, 512, 1500, 64, False)]
# ragged tiles at d = 80 and 128 (blocks of 128 and 64 own rows, streamed
# tiles of 64 and 32): a part-full last block and tile, one query, one
# 63-row tile
BWD_RAGGED = [(2, sq, sk, d, causal) for d in (80, 128)
              for sq, sk, causal in ((130, 200, True), (1, 77, True),
                                     (1, 77, False), (63, 63, True),
                                     (63, 63, False))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,sq,sk,d,causal", BWD_CASES + BWD_RAGGED)
def test_flash_backward_kernels_match_plain(cuda, h, sq, sk, d, causal,
                                            dtype):
    from repro_torch.kernels import ref
    rng = np.random.default_rng(h + sq + sk + d)
    q = _normal(rng, (h, sq, d), cuda, dtype)
    k, v = (_normal(rng, (h, sk, d), cuda, dtype) for _ in range(2))
    do = _normal(rng, (h, sq, d), cuda, dtype)
    o, lse = fa.attention_lse_kernel(q, k, v, causal)
    o_p, lse_p = ref.flash_attention_lse(q, k, v, causal)
    got = fa.attention_backward_kernel(q, k, v, o, lse, do, causal)
    again = fa.attention_backward_kernel(q, k, v, o, lse, do, causal)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention(*leaves, causal=causal),
                               leaves, do)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, lse_p, atol=1e-5, rtol=0)
    # max |kernel - plain| / max |plain|: float32-grade products (three
    # TF32 passes on the tensor cores, about 2^-21 relative a product;
    # ex2.approx, other sums' order); bf16 outputs round to 8 bits and D
    # uses the rounded o
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b, w in zip(got, again, want):
        assert a.dtype == dtype and torch.equal(a, b)
        assert float((a.float() - w.float()).abs().max()) <= \
            tol * float(w.float().abs().max())


@pytest.mark.parametrize("entry", ["strela_flash_bwd_dkdv",
                                   "strela_flash_bwd_dq"])
@pytest.mark.parametrize("d", [8, 32, 96, 256])
def test_flash_backward_entry_points_refuse_an_unsupported_head_dim(
        cuda, entry, d):
    """The C entry points return cudaErrorInvalidValue (1) for a d the
    kernels are not instantiated for, and launch nothing."""
    from repro_torch.kernels import _build
    h, sq, sk = 2, 8, 8
    q, k, v, do = (torch.zeros((h, n, d), device=cuda)
                   for n in (sq, sk, sk, sq))
    lse, delta = (torch.zeros((h, sq), device=cuda) for _ in range(2))
    out = [torch.full((h, n, d), 7.0, device=cuda) for n in (sq, sk)]
    lib = _build.load()
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    outs = ([out[1].data_ptr(), out[1].data_ptr()] if entry.endswith("dkdv")
            else [out[0].data_ptr()])
    rc = getattr(lib, entry)(*ptrs, *outs, h, sq, sk, d, 0, 1,
                             1.0 / d ** 0.5,
                             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 1
    assert all(bool((t == 7.0).all()) for t in out)
    with pytest.raises(ValueError, match="head_dim"):
        (fa.bwd_dkdv_kernel if entry.endswith("dkdv") else fa.bwd_dq_kernel)(
            q, k, v, do, lse, delta, True)


def test_flash_attention_fn_on_the_card_runs_the_kernels_only(cuda):
    """With a gradient the Function runs the forward kernel (with lse)
    and the three backward kernels once each, and no plain version."""
    rng = np.random.default_rng(5)
    q, k, v = (_normal(rng, (8, 96, 64), cuda).requires_grad_()
               for _ in range(3))
    counts = (fa.launches, fa.bwd_preprocess_launches, fa.bwd_dkdv_launches,
              fa.bwd_dq_launches, fa.plain_calls, fa.backward_plain_calls)
    out = fa.flash_attention(q, k, v, True)
    out.square().sum().backward()
    torch.cuda.synchronize()
    after = (fa.launches, fa.bwd_preprocess_launches, fa.bwd_dkdv_launches,
             fa.bwd_dq_launches, fa.plain_calls, fa.backward_plain_calls)
    assert [b - a for a, b in zip(counts, after)] == [1, 1, 1, 1, 0, 0]
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def test_attention_kernel_refuses_an_input_that_needs_a_gradient(cuda):
    rng = np.random.default_rng(6)
    q, k, v = (_normal(rng, (2, 16, 64), cuda) for _ in range(3))
    launches = fa.launches
    with pytest.raises(ValueError, match="attention_kernel returns no "
                                         "gradient"):
        fa.attention_kernel(q.requires_grad_(), k, v, True)
    assert fa.launches == launches


def test_serving_launches_no_backward_kernel(cuda):
    """Serving (no_grad / inference mode) takes the forward kernel alone,
    without lse, once per layer and step, as before training came."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model
    cfg = get_arch("minicpm-2b").reduced()
    api = build_model(cfg)
    params = api.init_params(torch.Generator(cuda).manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32)).to(cuda)
    before = (fa.launches, fa.bwd_preprocess_launches, fa.bwd_dkdv_launches,
              fa.bwd_dq_launches, fa.plain_calls)
    with torch.inference_mode():
        serve_lm.generate(api, params, prompt, 4)
    after = (fa.launches, fa.bwd_preprocess_launches, fa.bwd_dkdv_launches,
             fa.bwd_dq_launches, fa.plain_calls)
    assert [b - a for a, b in zip(before, after)] == [
        cfg.n_layers * (8 + 4), 0, 0, 0, 0]


@pytest.mark.parametrize("arch", ["minicpm-2b", "whisper-base"])
def test_train_steps_on_the_card_match_the_cpu(cuda, arch):
    """Two ``make_step`` steps of the reduced model in float32 from one
    set of parameters: losses and gnorms within 1e-5 and 1e-4 relative,
    parameters within 2 x (lr_1 + lr_2) = 3.6e-4 (an entry with a near
    zero gradient may take Adam's sign-like step the other way), such
    entries under 0.1% of all."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.convert import (lm_params_from_reference,
                                     lm_params_to_reference)
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamW
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    api = build_model(cfg)
    tree = lm_params_to_reference(api.init_params(
        torch.Generator().manual_seed(0)), cfg)
    runs = []
    for dev in (torch.device("cpu"), cuda):
        params = lm_params_from_reference(tree, cfg, dev)
        opt = AdamW(lr=train.schedule("wsd", 3e-4, 2))
        state = opt.init(list(params.parameters()))
        step = train.make_step(api, opt, False)
        pipe = TokenPipeline(DataCfg(cfg.vocab, 32, 2, seed=0))
        metrics = []
        for i in range(2):
            batch = train.make_batch(cfg, pipe, i, 2, dev)
            params, state, _, m = step(params, state, None, batch)
            metrics.append((float(m["loss"]), float(m["gnorm"])))
        runs.append((np.array(metrics),
                     [p.detach().cpu() for p in params.parameters()]))
    (mc, pc), (mg, pg) = runs
    np.testing.assert_allclose(mg[:, 0], mc[:, 0], rtol=1e-5)
    np.testing.assert_allclose(mg[:, 1], mc[:, 1], rtol=1e-4)
    diffs = [(a - b).abs() for a, b in zip(pc, pg)]
    assert max(float(d.max()) for d in diffs) <= 3.6e-4
    assert sum(int((d > 1e-6).sum()) for d in diffs) <= \
        1e-3 * sum(d.numel() for d in diffs)
