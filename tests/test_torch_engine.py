"""The port's ``Engine`` against the reference ``Engine(backend="sim")`` on
the same request streams: outputs, ``Tally``, ``EngineStats`` and config
words must all be equal. The port's ``"cuda"`` backend runs here with
``device="cpu"``, where its kernels take their plain PyTorch versions."""
import dataclasses

import numpy as np
import pytest

from repro.core import kernels_lib as RK
from repro.engine import ArtifactCache as RCache
from repro.engine import Engine as REngine
from repro.engine import clients as rclients
from repro_torch.core import kernels_lib as K
from repro_torch.engine import ArtifactCache, ArtifactError, Engine, clients
from repro_torch.kernels.fabric_reduce import run_dfg

# the 13 capable kernels of the reference parity suite, in both packages
PARITY = {
    "fft": lambda m, n: m.fft_butterfly(),
    "relu": lambda m, n: m.relu(),
    "mac1": lambda m, n: m.mac1(n),
    "mac3": lambda m, n: m.mac3(n),
    "mac2x": lambda m, n: m.mac2x(n),
    "axpby": lambda m, n: m.axpby(3, 5),
    "scale": lambda m, n: m.scale(7),
    "scale_add": lambda m, n: m.scale_add(4),
    "vadd": lambda m, n: m.vadd(),
    "conv2d_row3": lambda m, n: m.conv2d_row3(1, -2, 3),
    "conv2d_row": lambda m, n: m.conv2d_row(1, -2, 3),
    "outer_row": lambda m, n: m.outer_row(2, -3),
    "outer_row2": lambda m, n: m.outer_row2(2, -3, 5, 1),
}


def _engines():
    """(port cuda on the CPU, port sim, reference sim), memory caches."""
    return (Engine(backend="cuda", device="cpu",
                   cache=ArtifactCache(memory_only=True)),
            Engine(backend="sim", cache=ArtifactCache(memory_only=True)),
            REngine(backend="sim", cache=RCache(memory_only=True)))


def _assert_same_accounting(port, ref):
    # the two packages' Tally classes differ: compare their fields
    assert dataclasses.asdict(port.tally) == dataclasses.asdict(ref.tally)
    p, r = dataclasses.asdict(port.stats), dataclasses.asdict(ref.stats)
    for k in ("requests", "flushes", "config_cycles_paid",
              "config_cycles_naive"):
        assert p[k] == r[k], k


@pytest.mark.parametrize("name", sorted(PARITY))
def test_parity_kernels_match_reference_sim(name):
    length = 16
    rng = np.random.default_rng(len(name))
    g_ref = PARITY[name](RK, length)
    ins = {k: rng.integers(-2 ** 31, 2 ** 31, length, dtype=np.int64)
           .astype(np.int32) for k in g_ref.inputs}
    ref = REngine(backend="sim", cache=RCache(memory_only=True))
    art_r = ref.compile(g_ref)
    want = ref.run(art_r, dict(ins))
    cuda, sim, _ = _engines()
    for eng in (cuda, sim):
        art = eng.compile(PARITY[name](K, length))
        got = eng.run(art, dict(ins))
        assert set(got) == set(want)
        for o in want:
            np.testing.assert_array_equal(got[o], want[o], err_msg=o)
        _assert_same_accounting(eng, ref)
        assert dataclasses.asdict(eng.stats) == dataclasses.asdict(ref.stats)
        assert list(art.config_words.values()) == \
            list(art_r.config_words.values())
    # the port's sim artifact is keyed exactly like the reference's
    assert sim.compile(PARITY[name](K, length)).config_words == \
        art_r.config_words


@pytest.mark.parametrize("name", ["mac3", "fft", "relu"])
def test_lane_batched_flush_matches_reference_sim(name):
    length = 40
    rng = np.random.default_rng(9)
    cuda, sim, ref = _engines()
    batch = [{k: rng.integers(-999, 999, length).astype(np.int32)
              for k in PARITY[name](RK, length).inputs} for _ in range(5)]
    results = []
    for eng, mod in ((cuda, K), (sim, K), (ref, RK)):
        art = eng.compile(PARITY[name](mod, length))
        hs = [eng.submit(art, dict(ins)) for ins in batch]
        eng.flush()
        results.append([h.result() for h in hs])
    for got in results[:2]:
        for g, w in zip(got, results[2]):
            for o in w:
                np.testing.assert_array_equal(g[o], w[o])
    assert cuda.stats.lane_batches == 1 and cuda.stats.lane_requests == 5
    assert cuda.stats.lane_batch_failures == 0
    _assert_same_accounting(cuda, ref)
    _assert_same_accounting(sim, ref)


def test_failed_lane_grid_retries_each_request_through_the_kernel(
        monkeypatch):
    """A lane grid that raises falls back to per-request dispatch, and
    that dispatch still goes through the kernel wrapper on the engine's
    device, never a path of its own."""
    cuda, _, ref = _engines()
    assert cuda._value_fn.func is run_dfg
    assert cuda._value_fn.keywords == {"device": cuda.device}

    def broken(batch):
        raise RuntimeError("grid failed")

    monkeypatch.setattr(cuda, "_run_lanes", broken)
    xs = [np.arange(-8, 8, dtype=np.int32) * k for k in range(3)]
    art, art_r = cuda.compile(K.relu()), ref.compile(RK.relu())
    hs = [cuda.submit(art, {"x": x}) for x in xs]
    cuda.flush()
    for h, x in zip(hs, xs):
        np.testing.assert_array_equal(h.result()["out"],
                                      ref.run(art_r, {"x": x})["out"])
    assert cuda.stats.lane_batch_failures == 1
    assert cuda.stats.lane_batches == 0 and cuda.stats.requests == 3


def test_multi_shot_plan_matches_reference_sim():
    cuda, sim, ref = _engines()
    rng = np.random.default_rng(4)
    x, y = (rng.integers(-2 ** 31, 2 ** 31, 48, dtype=np.int64)
            .astype(np.int32) for _ in range(2))
    art_r = ref.compile(RK.axpby(3, 5), pe_limit=1)
    want = ref.run(art_r, {"x": x, "y": y})
    for eng in (cuda, sim):
        art = eng.compile(K.axpby(3, 5), pe_limit=1)
        assert art.n_shots == art_r.n_shots > 1
        assert list(art.config_words.values()) == \
            list(art_r.config_words.values())
        got = eng.run(art, {"x": x, "y": y})
        np.testing.assert_array_equal(got["out"], want["out"])
        _assert_same_accounting(eng, ref)


@pytest.mark.parametrize("client", ["gemm", "gesummv", "2mm"])
def test_clients_match_reference_sim_and_numpy(client):
    rng = np.random.default_rng(17)

    def mat(*shape):
        return rng.integers(-9, 9, shape).astype(np.int32)

    cuda, sim, ref = _engines()
    outs = []
    if client == "gemm":
        A, B, C = mat(5, 8), mat(8, 7), mat(5, 7)
        want = (3 * (A.astype(np.int64) @ B) + 2 * C).astype(np.int32)
        for eng, mod in ((cuda, clients), (sim, clients), (ref, rclients)):
            Cx = C.copy()
            mod.run_gemm(eng, 3, A, B, 2, Cx)
            outs.append(Cx)
    elif client == "gesummv":
        A, B, x = mat(6, 6), mat(6, 6), mat(6)
        want = (2 * (A.astype(np.int64) @ x)
                + 3 * (B.astype(np.int64) @ x)).astype(np.int32)
        for eng, mod in ((cuda, clients), (sim, clients), (ref, rclients)):
            y = np.zeros(6, np.int32)
            mod.run_gesummv(eng, 2, 3, A, B, x, y)
            outs.append(y)
    else:
        A, B, C, Dm = mat(4, 6), mat(6, 5), mat(5, 4), mat(4, 4)
        want = (2 * (A.astype(np.int64) @ B @ C) + 3 * Dm).astype(np.int32)
        for eng, mod in ((cuda, clients), (sim, clients), (ref, rclients)):
            Dx = Dm.copy()
            mod.run_2mm(eng, 2, 3, A, B, C, Dx)
            outs.append(Dx)
    for got in outs:
        np.testing.assert_array_equal(got, want)
    assert cuda.stats.lane_batches > 0
    assert cuda.stats.lane_batch_failures == 0
    _assert_same_accounting(cuda, ref)
    _assert_same_accounting(sim, ref)


def test_compile_of_a_callable_names_the_missing_frontend():
    """The torch frontend is ported: a callable compiles through it. What
    a callable still needs (the stream length) and what compile never
    takes are refused by name."""
    eng = Engine(backend="sim", cache=ArtifactCache(memory_only=True))
    art = eng.compile(lambda x: x + 1, 16)
    assert art.length == 16 and art.out_shapes == [(16,)]
    x = np.arange(16, dtype=np.int32)
    np.testing.assert_array_equal(eng.run(art, {"x": x})["out0"], x + 1)
    with pytest.raises(ArtifactError, match="requires the stream length"):
        eng.compile(lambda x: x + 1)
    with pytest.raises(ArtifactError, match="takes a DFG"):
        eng.compile(3)


def test_artifacts_pickle_the_port_modules_only():
    art = Engine(backend="cuda", device="cpu",
                 cache=ArtifactCache(memory_only=True)).compile(K.mac3(8))
    blob = art.to_bytes()
    assert b"repro_torch.core" in blob and b"\x8crepro.core" not in blob
    assert b"repro.core" not in blob.replace(b"repro_torch.core", b"")


def test_cache_root_never_shares_the_reference_root(monkeypatch, tmp_path):
    from repro.engine import cache as rcache
    from repro_torch.engine import cache
    monkeypatch.delenv("STRELA_CACHE_DIR", raising=False)
    assert cache.default_cache_root() != rcache.default_cache_root()
    assert "strela_torch" in cache.default_cache_root()
    monkeypatch.setenv("STRELA_CACHE_DIR", str(tmp_path))
    assert cache.default_cache_root() == str(tmp_path / "torch")
    assert rcache.default_cache_root() == str(tmp_path)
    monkeypatch.setenv("STRELA_CACHE", "0")
    assert cache.default_cache().memory_only
    monkeypatch.setenv("STRELA_CACHE", "1")
    c = cache.default_cache()
    assert not c.memory_only and c.root == str(tmp_path / "torch")
    art = Engine(backend="sim", cache=c).compile(K.relu())
    assert (tmp_path / "torch" / f"{art.key}.pkl").exists()
    assert not list(tmp_path.glob("*.pkl"))
