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
