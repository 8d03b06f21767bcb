"""The port's CUDA kernels on the card, against their plain PyTorch
versions on the same device inputs (the fabric kernels bit-exact, the
float kernels within ``tests/test_kernels_pallas.py``'s tolerances, with
TF32 off); and every path that runs them end to end: the ``"cuda"``
engine, the serving loop and the fleet, ``@offload``, each LM family's
serving at full width cut in depth, training, the one-rank NCCL mesh and
the dry run. Marked ``gpu``: each test asks its fixture for the card and
skips, with the reason, where there is none. This file imports neither
``jax`` nor the JAX package, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

``python3 chip_smoke.py`` runs it, with ``tests/test_torch_gpu_adamw.py``
and the kernel bench.
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

# the reference parity suite's kernels, a Branch/Merge with ops on both
# legs, and tables of 64 wire slots, the most the kernels hold
PARITY = {
    "fft": lambda n: K.fft_butterfly(), "relu": lambda n: K.relu(),
    "mac1": K.mac1, "mac3": K.mac3, "mac2x": K.mac2x,
    "axpby": lambda n: K.axpby(3, 5), "scale": lambda n: K.scale(7),
    "scale_add": lambda n: K.scale_add(4), "vadd": lambda n: K.vadd(),
    "conv2d_row3": lambda n: K.conv2d_row3(1, -2, 3),
    "conv2d_row": lambda n: K.conv2d_row(1, -2, 3),
    "outer_row": lambda n: K.outer_row(2, -3),
    "outer_row2": lambda n: K.outer_row2(2, -3, 5, 1),
    "legs": lambda n: _legs_dfg(), "wide": lambda n: _wide_dfg(False),
    "wide_merge": lambda n: _wide_dfg(True),
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


def _legs_dfg():
    """x > 0 ? x * y : x >> 3, a Branch/Merge with an op on each leg."""
    b = DFG.build("legs")
    x, y = b.inp("x"), b.inp("y")
    c = b.cmp("c", CmpOp.GTZ, x)
    bx, by = b.branch("bx", x, c), b.branch("by", y, c)
    t = b.alu("t", AluOp.MUL, bx, by, a_port="t", b_port="t")
    f = b.alu("f", AluOp.SHR, bx, const_b=3, a_port="f")
    b.out("out", b.merge("m", t, f))
    return b.done()


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
    graphs = [_legs_dfg(), K.relu(), K.fft_butterfly(), K.axpby(3, 5),
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


def _wrap32(x):
    return ((np.asarray(x, dtype=np.int64) + 2 ** 31) % 2 ** 32
            - 2 ** 31).astype(np.int32)


def test_cuda_engine_one_shot_mix_and_gesummv_match_the_executor(cuda):
    """The one-shot mix (relu, vadd, fft_butterfly, axpby, scale_add, mac1)
    at length 4096, 8 requests a class in one flush of
    ``Engine(backend="cuda")``: every output equal to the executor's, the
    tally and the configuration cycles equal to ``Engine("sim")``'s on the
    same stream; then PolyBench gesummv through ``clients``; the lane
    kernel launched, its plain version never."""
    from repro_torch.core.executor import execute
    from repro_torch.engine import ArtifactCache, Engine, clients
    length = 4096
    dfgs = {"relu": K.relu(), "vadd": K.vadd(),
            "fft_butterfly": K.fft_butterfly(), "axpby": K.axpby(3, 5),
            "scale_add": K.scale_add(4), "mac1": K.mac1(length)}
    eng, sim = (Engine(backend=b, cache=ArtifactCache(memory_only=True))
                for b in ("cuda", "sim"))
    arts = {c: eng.compile(g) for c, g in dfgs.items()}
    sim_arts = {c: sim.compile(g) for c, g in dfgs.items()}
    rng = np.random.default_rng(8)
    reqs = [(c, {k: rng.integers(-2 ** 31, 2 ** 31, length, dtype=np.int64)
                 .astype(np.int32) for k in g.inputs})
            for _ in range(8) for c, g in dfgs.items()]
    launches, plain = fr.launches, fr.plain_calls
    handles = [(c, ins, eng.submit(arts[c], ins)) for c, ins in reqs]
    eng.flush()
    for c, ins in reqs:
        sim.submit(sim_arts[c], ins)
    sim.flush()
    for c, ins, h in handles:
        got, want = h.result(), execute(dfgs[c], ins)
        for o in want:
            np.testing.assert_array_equal(got[o], want[o])
    assert eng.tally == sim.tally
    assert (eng.stats.config_cycles_paid, eng.stats.config_cycles_naive) \
        == (sim.stats.config_cycles_paid, sim.stats.config_cycles_naive)
    A, B = (rng.integers(-1000, 1000, (250, 250)).astype(np.int32)
            for _ in range(2))
    x = rng.integers(-1000, 1000, 250).astype(np.int32)
    y = np.zeros(250, dtype=np.int32)
    clients.run_gesummv(eng, 2, 3, A, B, x, y)
    np.testing.assert_array_equal(y, _wrap32(
        2 * (A.astype(np.int64) @ x) + 3 * (B.astype(np.int64) @ x)))
    assert fr.launches > launches and fr.plain_calls == plain
    assert eng.stats.lane_batch_failures == 0


def test_ops_send_numpy_inputs_to_each_kernel_on_the_card(cuda):
    """``kernels.ops`` with numpy inputs and no device runs on the card:
    a float32 product on the SGEMM, bfloat16 ones on ``wgmma`` (aligned)
    and ``wgmma_realign`` (A one element off alignment, and an LM head's
    N % 8 = 3 with a bfloat16 result), attention, the 3x3 convolution and
    ``fabric_elementwise`` on their kernels; no plain version; each result
    within its tolerance of the plain version's (max|C| relative for the
    products, as at their realistic widths)."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(9)
    a, b = (rng.standard_normal(s).astype(np.float32)
            for s in ((200, 136), (136, 264)))
    q, k, v = (rng.standard_normal((4, 300, 64)).astype(np.float32)
               for _ in range(3))
    img, kern = (rng.standard_normal(s).astype(np.float32)
                 for s in ((300, 517), (3, 3)))
    xs = rng.integers(-2 ** 31, 2 ** 31, 5000, dtype=np.int64).astype(
        np.int32)
    a16, b16 = (torch.from_numpy(t).to(cuda, BF16) for t in (a, b))
    a_off = _offset(a16, 1)
    b_head = _normal(rng, (136, 259), cuda, BF16)
    mods = (sm, fa, sc, fs)

    def counts():
        return ([sm.sgemm_launches, sm.wgmma_launches,
                 sm.wgmma_realign_launches, fa.launches, sc.launches,
                 fs.launches] + [m.plain_calls for m in mods])
    before = counts()
    out = {"f32": ops.matmul(a, b), "bf16": ops.matmul(a16, b16),
           "off": ops.matmul(a_off, b16),
           "head": ops.matmul(a16, b_head, out_dtype=BF16),
           "attn": ops.attention(q, k, v, causal=True),
           "conv": ops.conv2d_3x3(img, kern),
           "relu": ops.fabric_elementwise(K.relu(), {"x": xs})["out"]}
    torch.cuda.synchronize()
    assert [n - m for n, m in zip(counts(), before)] == [1, 1, 2, 1, 1, 1] \
        + [0] * len(mods)
    assert all(t.device.type == "cuda" for t in out.values())
    for key, x, y, rel, rtol in (
            ("f32", torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda),
             1e-5, 0.0),
            ("bf16", a16, b16, 1e-4, 0.0), ("off", a_off, b16, 1e-4, 0.0),
            ("head", a16, b_head, 1e-4, 2 ** -7)):
        want = sm.matmul_plain(x, y, out[key].dtype).float()
        torch.testing.assert_close(out[key].float(), want, rtol=rtol,
                                   atol=rel * float(want.abs().max()))
    torch.testing.assert_close(out["attn"], fa.attention_plain(
        *(torch.from_numpy(t).to(cuda) for t in (q, k, v)), True),
        atol=3e-5, rtol=3e-5)
    assert torch.equal(out["conv"], sc.conv_plain(
        *(torch.from_numpy(t).to(cuda) for t in (img, kern))))
    assert torch.equal(out["relu"].cpu(), torch.from_numpy(
        np.maximum(xs, 0)))


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


def test_cuda_server_serves_the_model_mix_against_its_oracles(cuda):
    """``Server`` on the card over the model-layer mix (the SSM classes,
    which need loop state, left out by name): every answer equal to its
    class's oracle, the lane kernel launched and its plain version
    never."""
    from repro_torch.engine import ArtifactCache, Engine
    from repro_torch.serve import (ServeConfig, Server, request_inputs,
                                   serve_classes)
    from repro_torch.workloads import MODEL_CLASSES
    length = 512
    eng = Engine(backend="cuda", cache=ArtifactCache(memory_only=True))
    skipped = {}
    classes = serve_classes(eng, length, mix="model", skipped=skipped)
    assert set(skipped) == {"ssm_scan", "ssm_relax"}
    rng = np.random.default_rng(12)
    launches, plain = fr.launches, fr.plain_calls
    with Server(eng, ServeConfig(max_wait_us=500.0)) as srv:
        tickets = [(label, srv.submit(art, request_inputs(
            art, length, rng, label=label)))
            for _ in range(2) for label, art in sorted(classes.items())]
        for label, tk in tickets:
            out = tk.result(timeout=120)
            for i, want in enumerate(MODEL_CLASSES[label].oracle(
                    **tk.inputs)):
                np.testing.assert_array_equal(np.ravel(out[f"out{i}"]),
                                              np.ravel(want))
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
    before = (sm.wgmma_launches, sm.wgmma_realign_launches)
    got = sm.matmul_kernel(a, b, out_dtype)
    want = sm.matmul_plain(a, b, out_dtype)
    torch.cuda.synchronize()
    assert (sm.wgmma_launches, sm.wgmma_realign_launches) == (before[0] + 1,
                                                              before[1])
    tol = 5e-2 if out_dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_stream_matmul_misaligned_a_takes_wgmma_realign(cuda):
    rng = np.random.default_rng(3)
    m, k, n = 100, 64, 128
    a = _normal(rng, (m * k + 1,), cuda, torch.bfloat16)[1:].view(m, k)
    b = _normal(rng, (k, n), cuda, torch.bfloat16)
    assert a.is_contiguous() and a.data_ptr() % 16 == 2
    assert sm.route(a, b) == "wgmma_realign"
    before = (sm.wgmma_launches, sm.wgmma_realign_launches)
    got = sm.matmul_kernel(a, b)
    want = sm.matmul_plain(a, b)
    torch.cuda.synchronize()
    assert (sm.wgmma_launches, sm.wgmma_realign_launches) == (before[0],
                                                              before[1] + 1)
    torch.testing.assert_close(got, want, atol=5e-2, rtol=5e-2)


# the realign route's cases: every element offset of A's and of B's base,
# every K % 8 and N % 8 (two k stages, two column tiles), ragged M, N, K
REALIGN_CASES = ([(130, 72, 264, off, 0) for off in range(1, 8)]
                 + [(70, 136, 300, 0, off) for off in range(8)]
                 + [(100, 64 + k8, 96, 3, 0) for k8 in range(1, 8)]
                 + [(129, 40, 256 + n8, 0, 5) for n8 in range(1, 8)]
                 + [(1, 1, 1, 1, 1), (257, 65, 1, 7, 2), (1, 130, 257, 0, 0),
                    (200, 7, 513, 6, 3), (300, 520, 1000, 1, 0),
                    (70000, 9, 16, 1, 0)])   # A's copy past 65,535 grid rows


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,a_off,b_off", REALIGN_CASES)
def test_stream_matmul_realign_route_matches_plain(cuda, m, k, n, a_off,
                                                   b_off, out_dtype):
    """Within 1e-4 of max|C| of the plain version (sums in another order),
    and one bf16 rounding more for a bf16 result; the realign counter moves
    and no other route's does."""
    rng = np.random.default_rng(m * k + n + a_off + 8 * b_off)
    a = _offset(_normal(rng, (m, k), cuda, torch.bfloat16), a_off)
    b = _offset(_normal(rng, (k, n), cuda, torch.bfloat16), b_off)
    assert sm.route(a, b) == "wgmma_realign"
    before = (sm.wgmma_launches, sm.wgmma_realign_launches, sm.sgemm_launches)
    got = sm.matmul_kernel(a, b, out_dtype)
    want = sm.matmul_plain(a, b, out_dtype)
    torch.cuda.synchronize()
    assert (sm.wgmma_launches, sm.wgmma_realign_launches,
            sm.sgemm_launches) == (before[0], before[1] + 1, before[2])
    atol = 1e-4 * float(want.float().abs().max())
    rtol = 2 ** -7 if out_dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def test_stream_matmul_empty_k_on_the_realign_route_is_zeros(cuda):
    a = torch.ones((100, 0), dtype=torch.bfloat16, device=cuda)
    b = torch.ones((0, 300), dtype=torch.bfloat16, device=cuda)
    assert sm.route(a, b) == "wgmma_realign"
    got = sm.matmul_kernel(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros((100, 300), device=cuda))


def test_stream_matmul_cuda_side_refuses_the_retired_route_code(cuda):
    """Code 1, the retired mma.sync route, is refused (cudaErrorInvalid
    Value) and writes nothing."""
    from repro_torch.kernels import _build
    a = torch.ones((16, 12), dtype=torch.bfloat16, device=cuda)
    b = torch.ones((12, 16), dtype=torch.bfloat16, device=cuda)
    c = torch.full((16, 16), 7.0, device=cuda)
    assert 1 not in sm.ROUTES.values()
    rc = _build.load().strela_stream_matmul(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), 16, 16, 12, 1, 0, 1,
        None, 0, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 1 and bool((c == 7.0).all())


def test_stream_matmul_cuda_side_refuses_short_realign_scratch(cuda):
    """The realign route copies A (K % 8 != 0) into the caller's scratch,
    16 rows of 16 elements: one byte short, or a base off 16-byte
    alignment, is refused (cudaErrorInvalidValue) and writes nothing."""
    from repro_torch.kernels import _build
    lib = _build.load()
    a = torch.ones((16, 12), dtype=torch.bfloat16, device=cuda)
    b = torch.ones((12, 16), dtype=torch.bfloat16, device=cuda)
    c = torch.full((16, 16), 7.0, device=cuda)
    need = lib.strela_stream_matmul_scratch(a.data_ptr(), b.data_ptr(), 16,
                                            16, 12)
    assert need == 2 * 16 * 16
    scratch = torch.empty(need + 16, dtype=torch.uint8, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for ptr, n in ((scratch.data_ptr(), need - 1),
                   (scratch.data_ptr() + 8, need)):
        rc = lib.strela_stream_matmul(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), 16, 16, 12, 1, 0,
            sm.ROUTES["wgmma_realign"], ptr, n, stream)
        torch.cuda.synchronize()
        assert rc == 1 and bool((c == 7.0).all())
    rc = lib.strela_stream_matmul(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), 16, 16, 12, 1, 0,
        sm.ROUTES["wgmma_realign"], scratch.data_ptr(), need, stream)
    torch.cuda.synchronize()
    assert rc == 0 and bool((c == 12.0).all())


def test_stream_matmul_cuda_side_refuses_wgmma_on_misaligned_rows(cuda):
    a = torch.ones((16, 12), dtype=torch.bfloat16, device=cuda)
    b = torch.ones((12, 16), dtype=torch.bfloat16, device=cuda)
    launches = sm.wgmma_launches
    with pytest.raises(RuntimeError, match="wgmma"):
        sm._launch_route(a, b, torch.float32, "wgmma")
    assert sm.wgmma_launches == launches
    torch.testing.assert_close(sm._launch_route(a, b, torch.float32,
                                               "wgmma_realign"),
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


def _offload_fft(ar, ai, br, bi):
    wr, wi = 23170, -23170
    tr = br * wr - bi * wi
    ti = br * wi + bi * wr
    return ar + tr, ai + ti, ar - tr, ai - ti


@pytest.mark.parametrize("name,fn,n_in", [
    ("mac1", lambda a, b0: torch.sum(a * b0), 2),
    ("cond", _offload_cond, 1),
    ("big", _offload_big, 2),
    ("fft", _offload_fft, 4),
    ("epilogue", lambda d, y: torch.relu(3 * d + 2 * y), 2),
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


# the LM serving path: minicpm-2b serves batch 4,
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


# the MoE layer at granite-moe-3b-a800m's widths:
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


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


def test_dropless_moe_on_the_card_reads_nothing_back(cuda, monkeypatch):
    """granite's widths in bf16 at capacity factor E / k = 5, 2 x 512
    tokens: the dropless path's forward and backward run under
    ``set_sync_debug_mode("error")``, give the same bits twice, and match
    the capacity path at C = N. Tolerance: the two paths sum the products
    in other orders, so outputs and gradients (bf16, one rounding 2^-9)
    differ by a few roundings: a relative 2-norm gap under 1e-2."""
    import dataclasses
    from repro_torch.models import moe as M
    cfg, p = _granite_moe()
    spec = dataclasses.replace(cfg.moe, capacity_factor=5.0)
    assert M.dropless(spec, 1024)
    pc = {k: v.to(cuda).requires_grad_() for k, v in p.items()}
    x = _moe_input(cfg, 1024).view(2, 512, -1).to(cuda).requires_grad_()
    w = torch.randn(x.shape, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda, dtype=torch.bfloat16)

    def step():
        out, aux = M.moe_apply(pc, spec, cfg.d_ff, x)
        grads = torch.autograd.grad((out * w).float().sum() + aux,
                                    [x] + list(pc.values()))
        return [out, aux] + list(grads)

    step()                                   # warm: allocations
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    again = step()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    monkeypatch.setattr(M, "dropless", lambda spec, n: False)
    padded = step()
    assert first[0].dtype == torch.bfloat16
    assert pc["router"].dtype == torch.float32
    for got, want in zip(first, padded):
        assert _rel(got, want) < 1e-2


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


def _capture_routing(params, record):
    """A forward pre-hook on each layer's MoE module: ``route`` on the
    layer's input, kept on the host as (layer, probs, gate_idx)."""
    from repro_torch.models import moe as M
    for i, block in enumerate(params.layers):
        def hook(mod, args, i=i):
            probs, _, idx = M.route(mod, mod.spec, args[0])
            record.append((i, probs.cpu(), idx.cpu()))
        block.moe.register_forward_pre_hook(hook)


def _first_flips(cpu_rec, card_rec, n_rows, k):
    """Walk both runs' routing call by call (steps, then layers). A row
    whose chosen experts (as a set) differ is where the runs part: that
    row and every later one (the capacity's positions run by token) are
    compared no more from that step on. Returns each row's first step
    apart (None where never) and each flip's CPU top-k margin."""
    apart, margins = [None] * n_rows, []
    n_layers = 1 + max(rec[0] for rec in cpu_rec)
    for call, ((_, probs, ci), (_, _, gi)) in enumerate(zip(cpu_rec,
                                                            card_rec)):
        step = call // n_layers
        # a row's routing in this call depends on its own input only, so
        # every row not yet apart is checked before any is set apart
        flipped = [b for b in range(n_rows) if apart[b] is None and not
                   torch.equal(ci[b].sort().values, gi[b].sort().values)]
        for b in flipped:
            top = probs[b].sort(descending=True).values
            margins.append(float(top[k - 1] - top[k]))
        for r in range(min(flipped, default=n_rows), n_rows):
            if apart[r] is None:
                apart[r] = step
    return apart, margins


def test_granite_moe_at_full_width_decodes_like_the_cpu(cuda):
    """granite-moe-3b-a800m at full width cut to 2 layers, 8 prompt and 4
    greedy steps at batch 4 on the card and on the CPU from the same
    parameters (the card fed the CPU's tokens): each row's logits within
    the LM tolerance up to its first routing flip, and a flip only where
    the CPU's top-k margin is under 1e-4 (a bf16 rounding apart)."""
    import copy
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m"), n_layers=2)
    api = build_model(cfg)
    cpu_params = api.init_params(torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab, (4, 8)).astype(np.int32))
    runs, recs, fed = {}, {}, []
    for label, params in (("cpu", cpu_params),
                          ("card", copy.deepcopy(cpu_params).to(cuda))):
        recs[label], steps, logits = [], [], None
        _capture_routing(params, recs[label])
        dev = params.embed.device
        state = T.init_caches(cfg, 4, 12, device=dev)
        with torch.inference_mode():
            for t in range(12):
                if t < 8:
                    tok = prompt[:, t:t + 1]
                elif label == "cpu":
                    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
                    fed.append(tok)
                else:
                    tok = fed[t - 8]
                logits, state = api.decode_step(params, state, tok.to(dev),
                                                t)
                steps.append(logits.cpu().float())
        runs[label] = steps
    apart, margins = _first_flips(recs["cpu"], recs["card"], 4,
                                  cfg.moe.top_k)
    assert all(m < 1e-4 for m in margins), margins
    compared = 0
    for t, (g, c) in enumerate(zip(runs["card"], runs["cpu"])):
        rows = [b for b in range(4) if apart[b] is None or t < apart[b]]
        compared += len(rows)
        torch.testing.assert_close(g[rows], c[rows], atol=3e-2, rtol=3e-2)
    assert compared > 0


def test_internvl2_prefill_at_full_width_launches_flash_per_layer(cuda):
    """internvl2-76b at full width cut to 2 layers (the whole model needs
    about 141 GB in bf16): ``api.prefill`` of 256 patches and 32 tokens at
    batch 2, one flash launch a layer at d = 128, no plain call, finite
    logits and caches over every position."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_arch("internvl2-76b"), n_layers=2)
    api = build_model(cfg)
    params = api.init_params(torch.Generator(cuda).manual_seed(0))
    gen = torch.Generator(cuda).manual_seed(15)
    patches = torch.randn(2, cfg.n_patches, cfg.d_model, generator=gen,
                          device=cuda) * 0.02
    toks = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32)).to(cuda)
    launches, plain = fa.launches, fa.plain_calls
    with torch.inference_mode():
        logits, state = api.prefill(params, {
            "tokens": toks, "patches": patches.to(cfg.torch_dtype)})
    torch.cuda.synchronize()
    assert (fa.launches - launches, fa.plain_calls - plain) == (2, 0)
    assert tuple(logits.shape) == (2, cfg.vocab_padded)
    assert bool(torch.isfinite(logits.float()).all())
    assert state[0].shape[2] == cfg.n_patches + 32


def test_llama4_scout_decode_at_full_width_launches_flash_per_step(cuda):
    """llama4-scout-17b-a16e at full width cut to 2 layers (the whole model
    needs about 216 GB in bf16), 16 experts with a shared one: 4 greedy
    decode steps at batch 4, one flash launch a layer and step, no plain
    call, finite logits and tokens in the vocabulary."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_arch("llama4-scout-17b-a16e"), n_layers=2)
    api = build_model(cfg)
    params = api.init_params(torch.Generator(cuda).manual_seed(0))
    state = T.init_caches(cfg, 4, 4, device=cuda)
    tok = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab, (4, 1)).astype(np.int32)).to(cuda)
    launches, plain = fa.launches, fa.plain_calls
    with torch.inference_mode():
        for t in range(4):
            logits, state = api.decode_step(params, state, tok, t)
            tok = torch.argmax(logits, -1)[:, None]
            assert 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab
    assert (fa.launches - launches, fa.plain_calls - plain) == (2 * 4, 0)
    assert bool(torch.isfinite(logits[:, :cfg.vocab].float()).all())


# the SSD layer and the hybrid: one layer at
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


@pytest.mark.parametrize("arch,n_layers,sites", [("mamba2-1.3b", 2, 0),
                                                 ("zamba2-2.7b", 6, 1)])
def test_ssm_and_hybrid_prefill_at_full_width_matches_the_cpu(
        cuda, arch, n_layers, sites):
    """``api.prefill`` of 256 tokens at batch 2 (the chunked form) at full
    width cut in depth, the same weights in float32 and bf16: float32 on
    the card within the LM tolerance of the CPU; bf16, whose GEMMs round
    otherwise on the card and the CPU, no farther from the float32 CPU run
    than twice the CPU's own bf16 run; a flash launch a shared-block site
    and no plain call on the card."""
    import copy
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    api, api32 = build_model(cfg), build_model(cfg32)
    bf = api.init_params(torch.Generator().manual_seed(0))
    f32 = copy.deepcopy(bf).float()
    f32.cfg = cfg32
    toks = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab, (2, 256)).astype(np.int32))
    out = {}
    for key, (a, params) in {
            ("cpu", "bf16"): (api, bf),
            ("card", "bf16"): (api, copy.deepcopy(bf).to(cuda)),
            ("cpu", "f32"): (api32, f32),
            ("card", "f32"): (api32, copy.deepcopy(f32).to(cuda))}.items():
        launches, plain = fa.launches, fa.plain_calls
        with torch.inference_mode():
            logits, _ = a.prefill(params, {
                "tokens": toks.to(params.embed.device)})
        out[key] = logits.cpu().float()[..., :cfg.vocab]
        if key[0] == "card":
            assert (fa.launches - launches, fa.plain_calls - plain) == (
                sites, 0)
    torch.testing.assert_close(out["card", "f32"], out["cpu", "f32"],
                               atol=3e-2, rtol=3e-2)
    dist = {dev: float((out[dev, "bf16"] - out["cpu", "f32"]).abs().max())
            for dev in ("cpu", "card")}
    assert dist["card"] <= 2 * dist["cpu"], dist


# the Whisper encoder-decoder: whisper-base at
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


def _whisper_runs(api, params, frames, toks):
    """Reduced whisper-base on ``params``' device: the encoder's output,
    the decoder's logits, the loss, ``api.prefill``'s logits over 8 tokens
    and 12 decode steps, in float32 on the host."""
    from repro_torch.models import encdec as E
    cfg, dev = api.cfg, params.embed.device
    f, t = frames.to(dev, params.embed.dtype), toks.to(dev)
    with torch.inference_mode():
        enc = E.encode(params, cfg, f)
        logits = E.decode(params, cfg, t, enc)[0]
        loss = api.loss(params, {"tokens": t[:, :8], "targets": t[:, 1:9],
                                 "frames": f})[0]
        pre, _ = api.prefill(params, {"tokens": t[:, :8], "frames": f})
        state = (enc, E.init_caches(cfg, 2, 12, device=dev))
        steps = [api.decode_step(params, state, t[:, i:i + 1], i)[0]
                 for i in range(12)]
    return [x.cpu().float() for x in [enc, logits, loss, pre] + steps]


def _whisper_inputs(cfg):
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.encdec.enc_len, cfg.d_model)).astype(np.float32) * 0.02)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)).astype(
        np.int32))
    return frames, toks


def test_reduced_whisper_on_the_card_matches_the_cpu(cuda):
    """whisper-base reduced, float32, from the same parameters on the card
    and on the CPU: the encoder and decoder's logits, the loss, prefill
    and decode steps within the LM's float32 tolerance (2e-4)."""
    import copy
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_arch("whisper-base").reduced(),
                              dtype="float32")
    api = build_model(cfg)
    cpu = api.init_params(torch.Generator().manual_seed(0))
    ins = _whisper_inputs(cfg)
    out = {label: _whisper_runs(api, params, *ins) for label, params in
           (("cpu", cpu), ("card", copy.deepcopy(cpu).to(cuda)))}
    for got, want in zip(out["card"], out["cpu"]):
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


def test_reduced_whisper_in_bf16_on_the_card_stays_near_float32(cuda):
    """The same reduced weights in bf16 and in float32 (the bf16 upcast):
    bf16 rounding differs between the card's and the CPU's GEMMs and adds
    up over layers, so each bf16 run is held to its distance from the
    float32 CPU run: the card's no more than twice the CPU's own, with the
    flash kernels launched and no plain call."""
    import copy
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    cfg = get_arch("whisper-base").reduced()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    api, api32 = build_model(cfg), build_model(cfg32)
    bf = api.init_params(torch.Generator().manual_seed(0))
    f32 = copy.deepcopy(bf).float()
    f32.cfg = cfg32
    ins = _whisper_inputs(cfg)

    def runs(a, params):
        # the vocabulary's columns: the padded ones hold -1e30 in each
        # dtype, which bf16 rounds otherwise
        return [x[..., :cfg.vocab] if x.dim() else x
                for x in _whisper_runs(a, params, *ins)]
    ref = runs(api32, f32)
    launches, plain = fa.launches, fa.plain_calls
    card = runs(api, copy.deepcopy(bf).to(cuda))
    assert fa.launches > launches and fa.plain_calls == plain
    dist = {dev: max(float((x - r).abs().max()) for x, r in zip(run, ref))
            for dev, run in (("cpu", runs(api, bf)), ("card", card))}
    assert dist["card"] <= 2 * dist["cpu"], dist


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


@pytest.mark.parametrize("arch,n_layers", [("mamba2-1.3b", 2),
                                           ("zamba2-2.7b", 6),
                                           ("whisper-base", None)])
def test_decode_step_makes_no_host_sync(cuda, arch, n_layers):
    """A decode step after ``serve_lm.generate`` under
    ``set_sync_debug_mode("error")`` (any operation that waits for the
    device raises): the SSD families at full width cut in depth, and
    whisper-base whole, whose cross-attention recomputes k and v from the
    encoder's output every step."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model
    cfg = get_arch(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    api = build_model(cfg)
    params = api.init_params(torch.Generator(cuda).manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32)).to(cuda)
    with torch.inference_mode():
        res = serve_lm.generate(api, params, prompt, 4)
        cur = torch.argmax(res["logits"], -1)[:, None]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, _ = api.decode_step(params, res["state"], cur, 32 + 4)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(logits[:, :cfg.vocab].float()).all())


# training: the flash backward kernels against
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


@pytest.mark.parametrize("off", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 80, 128])
def test_flash_bwd_preprocess_matches_plain_and_repeats(cuda, d, dtype, off):
    """D within 1e-5 of max|D| of the plain version, the same bits on a
    second run, and the same bits from a base off 16-byte alignment (the
    kernel reads it element by element in the same order of sums)."""
    rng = np.random.default_rng(d + off)
    rows = 1000 + d
    flat = [_normal(rng, (rows * d + off,), cuda, dtype) for _ in range(2)]
    o, do = (t[off:].view(rows, d) for t in flat)
    launches = fa.bwd_preprocess_launches
    got = fa.bwd_preprocess_kernel(o, do)
    again = fa.bwd_preprocess_kernel(o, do)
    want = (do.float() * o.float()).sum(-1)
    torch.cuda.synchronize()
    assert fa.bwd_preprocess_launches == launches + 2
    assert got.shape == (rows,) and got.dtype == torch.float32
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    if off:
        aligned = fa.bwd_preprocess_kernel(o.clone(), do.clone())
        assert torch.equal(got, aligned)


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


# the bf16 tensor-core route (flash_kernel_tc, flash_bwd_dq_kernel_tc,
# flash_bwd_dkdv_kernel_tc) at the benchmark cells' attention shapes
# (minicpm-2b at 4,096 and at 4 x 512, granite at 2 x 2,048 over its 24
# heads) and whisper-base's encoder: today's bf16 tolerances, lse within
# 1e-5, two runs bit-identical, each call counted on the route
TC_SHAPES = [(36, 4096, 4096, True), (48, 2048, 2048, True),
             (144, 512, 512, True), (32, 1500, 1500, False)]


@pytest.mark.parametrize("h,sq,sk,causal", TC_SHAPES)
def test_flash_bf16_route_at_the_cells_shapes(cuda, h, sq, sk, causal):
    from repro_torch.kernels import ref
    rng = np.random.default_rng(h + sq + sk)
    q, do = (_normal(rng, (h, sq, 64), cuda, torch.bfloat16)
             for _ in range(2))
    k, v = (_normal(rng, (h, sk, 64), cuda, torch.bfloat16)
            for _ in range(2))
    before = (fa.tc_launches, fa.bwd_tc_launches)
    o, lse = fa.attention_lse_kernel(q, k, v, causal)
    o2, lse2 = fa.attention_lse_kernel(q, k, v, causal)
    got = fa.attention_backward_kernel(q, k, v, o, lse, do, causal)
    again = fa.attention_backward_kernel(q, k, v, o, lse, do, causal)
    assert (fa.tc_launches - before[0], fa.bwd_tc_launches - before[1]) \
        == (2, 2)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o_p, lse_p = ref.flash_attention_lse(q, k, v, causal)
    torch.testing.assert_close(o.float(), o_p.float(), atol=2 ** -7,
                               rtol=2 ** -7)
    torch.testing.assert_close(lse, lse_p, atol=1e-5, rtol=0)
    del o_p, lse_p
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention(*leaves, causal=causal),
                               leaves, do)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        assert float((a.float() - w.float()).abs().max()) <= \
            2e-2 * float(w.float().abs().max())


# a share of output and gradient elements equal to the float32 route's
# rounded to bfloat16 (repro_torch.bench_kernels.route_agreement): the
# route's three pieces of P and dS reach it (0.9963 at the least on the
# H100, on O at 4,096 keys), one piece (plain bf16 flash, 0.57-0.60) does
# not. Two pieces (0.994-0.998) fall within the float32 routes' own spread
# here (plain float32 PyTorch against the float32 route reads
# 0.9947-0.9999), so only the CPU emulation
# (tests/test_torch_flash_bf16_split.py) sees the lo piece.
TC_AGREE = 0.99


@pytest.mark.parametrize("h,sq,sk,d,causal", [
    (8, 4096, 4096, 64, True), (8, 4096, 4096, 128, True),
    (16, 1500, 1500, 64, False), (32, 512, 512, 64, True)])
def test_flash_bf16_route_agrees_with_the_float32_route(cuda, h, sq, sk, d,
                                                        causal):
    """Bit for bit after rounding, on the same bfloat16 inputs, lse and D:
    the tolerances above hold plain bf16 flash too, this share does not."""
    from repro_torch.bench_kernels import route_agreement
    rng = np.random.default_rng(h + sq + d)
    q, do = (_normal(rng, (h, sq, d), cuda, torch.bfloat16)
             for _ in range(2))
    k, v = (_normal(rng, (h, sk, d), cuda, torch.bfloat16)
            for _ in range(2))
    before = fa.bwd_dkdv_tc_launches, fa.bwd_dq_tc_launches
    agree = route_agreement(fa, q, k, v, do, causal, pieces=(1,))
    assert (fa.bwd_dkdv_tc_launches - before[0],
            fa.bwd_dq_tc_launches - before[1]) == (1, 1)
    assert min(agree["kernels"].values()) >= TC_AGREE, agree
    assert min(agree["plain_1"].values()) < TC_AGREE, agree


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.float32, 64, False), (torch.float32, 128, False),
    (torch.bfloat16, 16, False), (torch.bfloat16, 80, False)])
def test_flash_route_counts_follow_dtype_and_width(cuda, dtype, d, route):
    """bf16 at d = 64 and 128 takes the tensor-core kernels, one
    ``tc_launches`` a forward, one ``bwd_tc_launches`` a backward call and
    one launch of each backward kernel on the route; float32 and the other
    widths take today's kernels and count none."""
    rng = np.random.default_rng(d)
    q, k, v = (_normal(rng, (3, 70, d), cuda, dtype).requires_grad_()
               for _ in range(3))
    def counts():
        return (fa.launches, fa.tc_launches, fa.bwd_dkdv_launches,
                fa.bwd_tc_launches, fa.bwd_dkdv_tc_launches,
                fa.bwd_dq_tc_launches)
    before = counts()
    fa.flash_attention(q, k, v, True).float().square().sum().backward()
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(before, counts())] == [1, int(route), 1] \
        + [int(route)] * 3
    assert fa.tc_route(q, 70) == route


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


def _train_runs(arch, compress, cuda):
    """Two ``make_step`` steps of the reduced model in float32 from one set
    of parameters, with or without gradient compression, on the CPU and
    on the card: [(losses and gnorms, parameters after)] for each."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.convert import (lm_params_from_reference,
                                     lm_params_to_reference)
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim import grad_compress
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
        err = grad_compress.init_error(list(params.parameters())) \
            if compress else None
        step = train.make_step(api, opt, compress)
        pipe = TokenPipeline(DataCfg(cfg.vocab, 32, 2, seed=0))
        metrics = []
        for i in range(2):
            batch = train.make_batch(cfg, pipe, i, 2, dev)
            params, state, err, m = step(params, state, err, batch)
            metrics.append((float(m["loss"]), float(m["gnorm"])))
        runs.append((np.array(metrics),
                     [p.detach().cpu() for p in params.parameters()]))
    return runs


@pytest.mark.parametrize("arch", ["minicpm-2b", "whisper-base"])
def test_train_steps_on_the_card_match_the_cpu(cuda, arch):
    """Two ``make_step`` steps of the reduced model in float32 from one
    set of parameters: losses and gnorms within 1e-5 and 1e-4 relative,
    parameters within 2 x (lr_1 + lr_2) = 3.6e-4 (an entry with a near
    zero gradient may take Adam's sign-like step the other way), such
    entries under 0.1% of all."""
    _assert_train_runs_agree(_train_runs(arch, False, cuda))


@pytest.mark.parametrize("arch", ["minicpm-2b", "whisper-base"])
def test_compressed_train_steps_on_the_card_match_the_cpu(cuda, arch):
    """The same with the trainer's gradient compression and its error
    feedback, and the same limits."""
    _assert_train_runs_agree(_train_runs(arch, True, cuda))


def _assert_train_runs_agree(runs):
    (mc, pc), (mg, pg) = runs
    np.testing.assert_allclose(mg[:, 0], mc[:, 0], rtol=1e-5)
    np.testing.assert_allclose(mg[:, 1], mc[:, 1], rtol=1e-4)
    diffs = [(a - b).abs() for a, b in zip(pc, pg)]
    assert max(float(d.max()) for d in diffs) <= 3.6e-4
    assert sum(int((d > 1e-6).sum()) for d in diffs) <= \
        1e-3 * sum(d.numel() for d in diffs)


def test_train_step_takes_the_bf16_route(cuda):
    """minicpm-2b's widths in bf16 cut to 2 layers, two
    ``launch.train.make_step`` steps of 1 x 128 tokens, the cells' own
    path: each step launches ``flash_kernel_tc`` and one backward call of
    ``flash_bwd_dkdv_kernel_tc`` and ``flash_bwd_dq_kernel_tc`` a layer,
    the float32 route's kernels (each counter's launches less its route's)
    and every plain version never. A model that hands the kernel float32
    (an upcast in ``models.layers._attend``) fails here."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.kernels import adamw as AK
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamW
    cfg = dataclasses.replace(get_arch("minicpm-2b"), n_layers=2)
    assert cfg.dtype == "bfloat16" and cfg.hd in fa.TC_HEAD_DIMS
    api = build_model(cfg)
    params = api.init_params(torch.Generator(cuda).manual_seed(0))
    opt = AdamW(lr=train.schedule("wsd", 3e-4, 2))
    state = opt.init(list(params.parameters()))
    step = train.make_step(api, opt, False)
    pipe = TokenPipeline(DataCfg(cfg.vocab, 128, 1, seed=0))

    def counts():
        return (fa.tc_launches, fa.bwd_tc_launches, fa.bwd_dkdv_tc_launches,
                fa.bwd_dq_tc_launches, fa.bwd_preprocess_launches,
                fa.launches - fa.tc_launches,
                fa.bwd_dkdv_launches - fa.bwd_dkdv_tc_launches,
                fa.bwd_dq_launches - fa.bwd_dq_tc_launches,
                fa.plain_calls, fa.backward_plain_calls, AK.plain_calls)
    for i in range(2):
        before = counts()
        params, state, _, m = step(params, state, None, train.make_batch(
            cfg, pipe, i, 1, cuda))
        torch.cuda.synchronize()
        assert [b - a for a, b in zip(before, counts())] == \
            [cfg.n_layers] * 5 + [0] * 6
        assert bool(torch.isfinite(m["loss"]))


@pytest.fixture
def nccl_rank(cuda):
    """The trainer's one-rank NCCL group, destroyed after the test."""
    import torch.distributed as dist
    yield cuda
    if dist.is_initialized():
        dist.destroy_process_group()


def test_sharded_trainer_on_one_nccl_rank_equals_the_unsharded(nccl_rank,
                                                               monkeypatch):
    """``--model-axis 1``: every parameter a DTensor on a (1, 1) ("data",
    "model") mesh of one NCCL rank, the same losses bit for bit as the
    trainer with no mesh, the flash kernels launched per layer and step,
    no plain call."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import train
    from repro_torch.runtime import partition as PT
    args = ["--arch", "minicpm-2b", "--reduced", "--steps", "3", "--batch",
            "4", "--seq", "64", "--log-every", "1", "--device", "cuda"]
    want = train.main(args)
    placed, place = [], PT.place_model
    monkeypatch.setattr(PT, "place_model", lambda *a: placed.append(
        place(*a)) or placed[-1])
    fa.launches = fa.plain_calls = fa.backward_plain_calls = 0
    fa.bwd_preprocess_launches = fa.bwd_dkdv_launches = \
        fa.bwd_dq_launches = 0
    got = train.main(args + ["--model-axis", "1"])
    assert got == want
    (model,) = placed
    mesh = next(model.parameters()).device_mesh
    assert all(isinstance(p, DTensor) for p in model.parameters())
    assert tuple(mesh.mesh.shape) == (1, 1)
    assert tuple(mesh.mesh_dim_names) == ("data", "model")
    assert dist.get_backend() == "nccl"
    assert [fa.launches, fa.bwd_preprocess_launches, fa.bwd_dkdv_launches,
            fa.bwd_dq_launches] == [2 * 3] * 4
    assert (fa.plain_calls, fa.backward_plain_calls) == (0, 0)


def test_elastic_resume_on_one_nccl_rank_is_bit_equal(nccl_rank, tmp_path):
    """A run's step-1 checkpoint, restored with ``elastic_remesh`` onto a
    fresh one-rank mesh, continues to a step 2 and a step-2 checkpoint
    bit-equal to the uninterrupted run's."""
    import shutil
    from repro_torch.launch import train
    args = ["--arch", "minicpm-2b", "--reduced", "--steps", "3", "--batch",
            "4", "--seq", "64", "--log-every", "1", "--device", "cuda",
            "--model-axis", "1", "--save-every", "1"]
    whole = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    shutil.copytree(tmp_path / "a" / "step_00000001",
                    tmp_path / "b" / "step_00000001")
    resumed = train.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert resumed == whole[2:]
    blobs = [(tmp_path / d / "step_00000002" / "data.msgpack.zst"
              ).read_bytes() for d in ("a", "b")]
    assert blobs[0] == blobs[1]


# ---------------------------------------------------------------------------
# the flash kernels as registered operators, and the dry run's count
# against a real step on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_flash_operators_equal_the_direct_launches_bit_for_bit(cuda, d,
                                                              dtype, causal):
    """``strela::flash_fwd``/``flash_bwd``/``flash_attn`` on CUDA tensors
    launch the kernels the wrappers launch: o, lse, dq, dk, dv and the
    serving output bit-equal, and each launch counted once."""
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.standard_normal((6, 130, d)).astype(
        np.float32)).to(cuda, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((6, 200, d)).astype(
        np.float32)).to(cuda, dtype) for _ in range(2))
    do = torch.from_numpy(rng.standard_normal((6, 130, d)).astype(
        np.float32)).to(cuda, dtype)
    o1, lse1 = fa.attention_lse_kernel(q, k, v, causal)
    g1 = fa.attention_backward_kernel(q, k, v, o1, lse1, do, causal)
    a1 = fa.attention_kernel(q, k, v, causal)
    before = (fa.launches, fa.bwd_preprocess_launches, fa.bwd_dkdv_launches,
              fa.bwd_dq_launches, fa.plain_calls, fa.backward_plain_calls)
    o2, lse2 = torch.ops.strela.flash_fwd(q, k, v, causal)
    g2 = torch.ops.strela.flash_bwd(q, k, v, o1, lse1, do, causal)
    a2 = torch.ops.strela.flash_attn(q, k, v, causal)
    with torch.no_grad():
        a3 = fa.flash_attention(q, k, v, causal)
    assert (fa.launches, fa.bwd_preprocess_launches, fa.bwd_dkdv_launches,
            fa.bwd_dq_launches, fa.plain_calls, fa.backward_plain_calls) == (
        before[0] + 3, before[1] + 1, before[2] + 1, before[3] + 1,
        before[4], before[5])
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    for x, y in zip(g1, g2):
        assert x.dtype == dtype and torch.equal(x, y)
    assert torch.equal(a1, a2) and torch.equal(a1, a3)


def test_dry_run_flops_equal_a_real_step_on_the_card(cuda):
    """Phase 20 (b)'s equality at reduced size: the dry run's step under
    ``FakeTensorMode`` on the card and the same step on real CUDA tensors
    under ``OpCosts`` count the same FLOPs, through one
    ``strela::flash_fwd`` and one ``flash_bwd`` a layer, the kernels
    launched and no plain version run."""
    from repro_torch.configs.base import ShapeCfg, get_arch
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.launch import dryrun, train
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.roofline.op_costs import OpCosts
    cfg = get_arch("minicpm-2b").reduced()
    counts = (fa.launches, fa.bwd_dq_launches, fa.plain_calls,
              fa.backward_plain_calls)
    fake = dryrun.trace_cell(cfg, ShapeCfg("t", 64, 4, "train"), None,
                             "cuda")["costs"]
    # the fake step reaches no kernel and no plain version
    assert (fa.launches, fa.bwd_dq_launches, fa.plain_calls,
            fa.backward_plain_calls) == counts
    api = build_model(cfg)
    params = api.init_params(torch.Generator(cuda).manual_seed(0))
    opt = AdamW(lr=cosine_schedule(3e-4, 100, 10000))
    state = opt.init(list(params.parameters()))
    batch = train.make_batch(cfg, TokenPipeline(DataCfg(cfg.vocab, 64, 4)),
                             0, 4, cuda)
    before = (fa.launches, fa.bwd_dq_launches, fa.plain_calls,
              fa.backward_plain_calls)
    with OpCosts({"params": params, "state": state, "batch": batch}) as real:
        _, _, metrics = dryrun.make_train_step(api, opt)(params, state, batch)
    torch.cuda.synchronize()
    n = cfg.n_layers
    assert real.flops() == fake.flops() > 0
    for c in (real, fake):
        assert (c.calls["strela::flash_fwd"],
                c.calls["strela::flash_bwd"]) == (n, n)
    assert (fa.launches, fa.bwd_dq_launches, fa.plain_calls,
            fa.backward_plain_calls) == (before[0] + n, before[1] + n,
                                         before[2], before[3])
    assert bool(torch.isfinite(metrics["loss"]))


def test_dry_run_peak_tracks_the_allocator_on_the_card(cuda):
    """minicpm-2b's widths cut to 2 layers, batch 4 x 512: the dry run's
    step for real under ``OpCosts``, whose tracker of live storages (the
    dry run's peak memory) reads within 20% of what the CUDA allocator
    reports for the same step."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.launch import dryrun, train
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.roofline.op_costs import OpCosts
    cfg = dataclasses.replace(get_arch("minicpm-2b"), n_layers=2)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    api = build_model(cfg)
    params = api.init_params(torch.Generator(cuda).manual_seed(0))
    opt = AdamW(lr=cosine_schedule(3e-4, 100, 10000))
    state = opt.init(list(params.parameters()))
    batch = train.make_batch(cfg, TokenPipeline(DataCfg(cfg.vocab, 512, 4)),
                             0, 4, cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with OpCosts({"params": params, "state": state, "batch": batch}) as real:
        dryrun.make_train_step(api, opt)(params, state, batch)
    torch.cuda.synchronize()
    ratio = real.peak_bytes / (torch.cuda.max_memory_allocated() - before)
    assert abs(ratio - 1) <= 0.20, ratio
