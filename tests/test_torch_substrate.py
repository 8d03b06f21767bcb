"""The trainer's substrate in the port against the JAX reference on the
CPU: AdamW and its schedules (``repro_torch.optim.adamw``), gradient
compression (``optim.grad_compress``), checkpoints
(``repro_torch.checkpoint``, the reference's on-disk format, read and
written by both packages), the trainer's half of the fault-tolerance
runtime, the reverse parameter conversion and the trainer's command line
(``repro_torch.launch.train``, in subprocesses beside the reference's).
Mirrors ``tests/test_substrate.py``'s optimizer, compression,
checkpoint and fault-tolerance tests, then one test per numeric
contract. Inputs are numpy arrays from a seed, handed to both packages.

Tolerances: AdamW, clipping, wsd and the compressor equal the reference
bit for bit in float32 (and bfloat16 parameters); ``torch.pow`` and
``torch.cos`` in float32 may round 1 ulp away from XLA's, and the
arithmetic after them can double that, so the bias corrections and the
cosine schedule are held within 2 ulp, and bit-equal where they agree."""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:
    from hypothesis_stub import given, settings, st

from repro.checkpoint.ckpt import Checkpointer as RefCheckpointer
from repro.configs.base import get_arch as ref_arch
from repro.models.api import build_model as ref_build
from repro.optim import grad_compress as ref_gc
from repro.optim.adamw import AdamW as RefAdamW
from repro.optim.adamw import clip_by_global_norm as ref_clip
from repro.optim.adamw import cosine_schedule as ref_cosine
from repro.optim.adamw import wsd_schedule as ref_wsd
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import ckpt as C
from repro_torch.configs.base import get_arch
from repro_torch.convert import (lm_params_from_reference,
                                 lm_params_to_reference,
                                 opt_state_from_reference,
                                 opt_state_to_reference)
from repro_torch.launch import train
from repro_torch.optim import grad_compress
from repro_torch.optim.adamw import (AdamW, AdamWState, clip_by_global_norm,
                                     cosine_schedule, wsd_schedule)
from repro_torch.runtime.fault_tolerance import (HealthMonitor, Heartbeat,
                                                 StragglerDetector,
                                                 TrainSupervisor)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(7, 5), (33,), (4, 3, 2)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
          (jnp.float32, torch.float32)]


def _f32(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _pair(arrays):
    """The same values as a reference dict of jax arrays and a port list
    of tensors, in each leaf's dtype (bfloat16 for the second)."""
    ref = {f"p{i}": jnp.asarray(a, jd)
           for i, (a, (jd, _)) in enumerate(zip(arrays, DTYPES))}
    port = [torch.from_numpy(_f32(ref[f"p{i}"])).to(td)
            for i, (_, td) in enumerate(DTYPES)]
    return ref, port


# ---------------------------------------------------------------------------
# optimizer + schedules (tests/test_substrate.py's, then the contracts)
# ---------------------------------------------------------------------------

def test_adamw_converges_on_quadratic():
    opt = AdamW(lr=lambda s: torch.tensor(0.1), weight_decay=0.0)
    params = [torch.tensor([5.0, -3.0])]
    state = opt.init(params)
    for _ in range(200):
        params, state = opt.update([2 * params[0]], state, params)
    assert float(params[0].abs().max()) < 1e-2


def test_wsd_schedule_shape():
    lr = wsd_schedule(1.0, warmup=10, stable=50, decay=20)
    assert float(lr(torch.tensor(5))) == pytest.approx(0.5)
    assert float(lr(torch.tensor(30))) == pytest.approx(1.0)
    assert float(lr(torch.tensor(80))) < 0.05          # deep in decay
    cos = cosine_schedule(1.0, warmup=10, total=100)
    assert float(cos(torch.tensor(100))) == pytest.approx(0.1, abs=0.02)


def test_clip_by_global_norm():
    clipped, norm = clip_by_global_norm([torch.tensor([3.0, 4.0])], 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(torch.linalg.norm(clipped[0])) == pytest.approx(1.0,
                                                                 abs=1e-5)


def test_adamw_and_clipping_equal_the_reference_bit_for_bit():
    """Twelve steps of clip + update under the cosine schedule, float32
    and bfloat16 leaves: parameters, moments, norms and clipped
    gradients equal the reference's bits."""
    rng = np.random.default_rng(0)
    rp, tp = _pair([rng.standard_normal(s).astype(np.float32)
                    for s in SHAPES])
    ropt = RefAdamW(lr=ref_cosine(1e-2, 3, 20))
    popt = AdamW(lr=cosine_schedule(1e-2, 3, 20))
    rs, ps = ropt.init(rp), popt.init(tp)
    for _ in range(12):
        rg, tg = _pair([rng.standard_normal(s).astype(np.float32)
                        for s in SHAPES])
        rg, rnorm = ref_clip(rg, 1.0)
        tg, tnorm = clip_by_global_norm(tg, 1.0)
        assert float(rnorm) == float(tnorm)
        rp, rs = ropt.update(rg, rs, rp)
        tp, ps = popt.update(tg, ps, tp)
        for i, t in enumerate(tp):
            assert t.dtype == tg[i].dtype
            assert np.array_equal(_f32(rg[f"p{i}"]), tg[i].float().numpy())
            assert np.array_equal(_f32(rp[f"p{i}"]), t.float().numpy())
            assert np.array_equal(np.asarray(rs.mu[f"p{i}"]),
                                  ps.mu[i].numpy())
            assert np.array_equal(np.asarray(rs.nu[f"p{i}"]),
                                  ps.nu[i].numpy())
    assert int(ps.count) == int(rs.count) == 12


def test_adamw_count_is_incremented_before_use():
    seen = []
    opt = AdamW(lr=lambda c: seen.append(int(c)) or torch.tensor(1e-3))
    params = [torch.ones(3)]
    state = opt.init(params)
    assert state.count.dtype == torch.int32 and int(state.count) == 0
    params, state = opt.update([torch.ones(3)], state, params)
    params, state = opt.update([torch.ones(3)], state, params)
    assert seen == [1, 2] and int(state.count) == 2
    # a first step from zero moments is lr * sign(g) (+ decay): finite,
    # where b1c = 0 at count 0 would divide by zero
    assert torch.isfinite(params[0]).all()


def test_bias_corrections_are_float32_like_the_reference():
    """``1 - b ** count`` in float32, as JAX's weakly typed floats make
    it: bit-equal to XLA's over the first 5 counts and within 2 ulp to
    5000 (``torch.pow`` and XLA's pow round apart at a few counts, the
    first at 6 for b2 and 31 for b1); the same sum in Python doubles
    differs already at count 1."""
    opt = AdamW(lr=lambda c: c)
    counts = np.arange(1, 5001, dtype=np.int32)
    b1c, b2c = opt.bias_corrections(torch.from_numpy(counts))
    assert b1c.dtype == b2c.dtype == torch.float32
    for b, got in ((0.9, b1c.numpy()), (0.95, b2c.numpy())):
        want = np.asarray(1 - b ** jnp.asarray(counts).astype(jnp.float32))
        assert np.array_equal(got[:5], want[:5])
        ulp = np.abs(got.view(np.int32) - want.view(np.int32))
        assert ulp.max() <= 2 and (ulp == 0).mean() > 0.95
        doubles = (1 - np.power(b, counts.astype(np.float64))).astype(
            np.float32)
        assert doubles[0] != want[0]


@pytest.mark.parametrize("kind", ["wsd", "cosine"])
def test_schedules_are_float32_like_the_reference(kind):
    """``lr(count)`` in float32 for a run of 100 steps as
    ``launch/train.py`` sets it: wsd equal bit for bit, cosine within 2
    ulp (``torch.cos`` against XLA's, then three float32 products), at
    every count to 200."""
    port = train.schedule(kind, 3e-4, 100)
    ref = (ref_wsd(3e-4, 5, 70, 25) if kind == "wsd"
           else ref_cosine(3e-4, 5, 100))
    steps = np.arange(0, 200, dtype=np.int32)
    got = np.array([port(torch.tensor(s)).item() for s in steps], np.float32)
    assert port(torch.tensor(7)).dtype == torch.float32
    want = np.array([float(ref(jnp.asarray(s))) for s in steps], np.float32)
    ulp = np.abs(got.view(np.int32) - want.view(np.int32))
    assert ulp.max() <= (0 if kind == "wsd" else 2), ulp.max()
    assert (ulp == 0).mean() > 0.95


def test_weight_decay_applies_to_every_leaf():
    """Zero gradients: every leaf, a norm's ones and an embedding's rows
    included, takes the decay alone, p - lr * wd * p in float32."""
    params = [torch.ones(8), torch.full((5, 4), 0.5), torch.tensor(2.0)]
    want = [(p - 0.01 * (0.1 * p)) for p in params]
    opt = AdamW(lr=lambda c: torch.tensor(0.01))
    state = opt.init(params)
    params, state = opt.update([torch.zeros_like(p) for p in params], state,
                               params)
    for got, w in zip(params, want):
        assert torch.equal(got, w)


def test_bfloat16_parameters_keep_no_master_copy():
    """The step is float32 and cast back to the parameter's dtype; the
    state holds the two float32 moments and the count, nothing else."""
    p = torch.tensor([1.0, -0.5, 0.25], dtype=torch.bfloat16)
    g = torch.tensor([0.3, -0.2, 0.1], dtype=torch.bfloat16)
    opt = AdamW(lr=lambda c: torch.tensor(1e-3))
    state = opt.init([p])
    assert isinstance(state, AdamWState) and state._fields == ("mu", "nu",
                                                                "count")
    pf, gf = p.float(), g.float()
    m, v = 0.1 * gf, 0.05 * gf * gf
    b1c, b2c = opt.bias_corrections(torch.tensor(1))
    step = (m / b1c) / (torch.sqrt(v / b2c) + 1e-8) + 0.1 * pf
    want = (pf - torch.tensor(1e-3) * step).to(torch.bfloat16)
    (out,), state = opt.update([g], state, [p])
    assert out is p and p.dtype == torch.bfloat16 and torch.equal(p, want)
    assert state.mu[0].dtype == state.nu[0].dtype == torch.float32


def test_clip_scales_down_only_and_casts_back():
    small = [torch.tensor([0.3, 0.4], dtype=torch.bfloat16)]
    out, norm = clip_by_global_norm(small, 1.0)
    assert torch.equal(out[0], small[0]) and out[0].dtype == torch.bfloat16
    big = [torch.tensor([30.0, 40.0]), torch.tensor([0.0])]
    out, norm = clip_by_global_norm(big, 1.0)
    rout, rnorm = ref_clip([jnp.asarray([30.0, 40.0]), jnp.asarray([0.0])],
                           1.0)
    assert float(norm) == float(rnorm) == 50.0
    assert np.array_equal(out[0].numpy(), np.asarray(rout[0]))


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_grad_compress_roundtrip_bound():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal(5000).astype(np.float32))
    g_hat, new_err = grad_compress.compress_decompress(g, torch.zeros(5000))
    # per-block error bounded by scale/2 = max|g|/254
    assert float(new_err.abs().max()) <= float(g.abs().max()) / 254 + 1e-6


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 4000))
def test_property_error_feedback_preserves_signal(n):
    """Over repeated steps with a constant gradient, the error-feedback
    compressor must transmit the true mean (no bias accumulation)."""
    rng = np.random.default_rng(n)
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    err, acc = torch.zeros(n), torch.zeros(n)
    for _ in range(20):
        g_hat, err = grad_compress.compress_decompress(g, err)
        acc = acc + g_hat
    np.testing.assert_allclose((acc / 20).numpy(), g.numpy(),
                               atol=float(g.abs().max()) / 64 + 1e-5)


@pytest.mark.parametrize("n", [1, 5, 1023, 1024, 1025, 5000, 70000])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_grad_compress_equals_the_reference_bit_for_bit(n, scale):
    rng = np.random.default_rng(n)
    g = (rng.standard_normal(n) * scale).astype(np.float32)
    e = (rng.standard_normal(n) * scale * 0.01).astype(np.float32)
    rh, re = ref_gc.compress_decompress(jnp.asarray(g), jnp.asarray(e))
    th, te = grad_compress.compress_decompress(torch.from_numpy(g),
                                               torch.from_numpy(e))
    assert np.array_equal(np.asarray(rh), th.numpy())
    assert np.array_equal(np.asarray(re), te.numpy())


def test_grad_compress_rounds_half_to_even_and_clamps():
    """A block whose max is 127 has scale 1 (1 + 1e-12 rounds to 1 in
    float32): 2.5 and -2.5 round to 2 and -2, 3.5 to 4, as jnp.round."""
    g = torch.tensor([127.0, 2.5, 3.5, -2.5, 0.5])
    q, scale = grad_compress._quantize(g)
    assert float(scale[0, 0]) == 1.0 and q.dtype == torch.int8
    assert q[0, :5].tolist() == [127, 2, 4, -2, 0]
    assert q.shape == (1, grad_compress.BLOCK) and not q[0, 5:].any()


def test_grad_compress_apply_keeps_dtypes_and_feeds_back():
    grads = [torch.tensor([0.1, -0.2], dtype=torch.bfloat16),
             torch.linspace(-1, 1, 3000)]
    errs = grad_compress.init_error(grads)
    assert all(e.dtype == torch.float32 and e.shape == g.shape
               for e, g in zip(errs, grads))
    out, errs2 = grad_compress.apply(grads, errs)
    assert [o.dtype for o in out] == [torch.bfloat16, torch.float32]
    # the error is taken against the float32 g_hat, before the cast back
    for g, o, e in zip(grads, out, errs2):
        assert torch.equal(o, (g.float() - e).to(g.dtype))


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4).to(
                torch.bfloat16),
                       "b": torch.tensor([1.5, -2.5])},
            "step_count": torch.tensor(7, dtype=torch.int32),
            "opt": AdamWState([torch.ones(2)], [torch.zeros(2)],
                              torch.tensor(3, dtype=torch.int32))}


def test_checkpoint_roundtrip_bf16(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(7, tree, extra={"note": "x"})
    restored, step, extra = ck.restore(tree)
    assert step == 7 and extra["note"] == "x"
    assert restored["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])
    assert torch.equal(restored["params"]["b"], tree["params"]["b"])
    assert tuple(restored["opt"]) == tuple(restored["opt"][:3])
    assert int(restored["opt"][2]) == 3


def test_checkpoint_gc_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.zeros(3)})
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]


def test_checkpoint_async_writes_a_snapshot(tmp_path):
    """The host copy is made on the caller's thread: an in-place update
    right after ``save_async`` does not reach the file."""
    ck = Checkpointer(str(tmp_path))
    x = torch.ones(4)
    ck.save_async(5, {"x": x})
    x.add_(1.0)
    ck.wait()
    restored, step, _ = ck.restore({"x": torch.zeros(4)})
    assert step == 5 and torch.equal(restored["x"], torch.ones(4))


def _ref_tree():
    return {"params": {"w": jnp.asarray(np.arange(12.0).reshape(3, 4),
                                        jnp.bfloat16),
                       "b": jnp.asarray([1.5, -2.5], jnp.float32)},
            "step_count": jnp.asarray(7, jnp.int32),
            "opt": ([jnp.ones(2)], [jnp.zeros(2)],
                    jnp.asarray(3, jnp.int32))}


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    Checkpointer(str(tmp_path)).save(9, _tree(), extra={"k": 1})
    restored, step, extra = RefCheckpointer(str(tmp_path)).restore(
        _ref_tree())
    assert step == 9 and extra == {"k": 1}
    assert str(restored["params"]["w"].dtype) == "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(restored["params"]["w"], np.float32),
        np.arange(12.0).reshape(3, 4))
    np.testing.assert_array_equal(restored["opt"][0][0], np.ones(2))
    assert int(restored["step_count"]) == 7


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    RefCheckpointer(str(tmp_path)).save(4, _ref_tree())
    restored, step, _ = Checkpointer(str(tmp_path)).restore(_tree())
    assert step == 4
    assert restored["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["w"], _tree()["params"]["w"])
    assert torch.equal(restored["opt"][1][0], torch.zeros(2))
    # the files of both writers are the same bytes
    other = tmp_path / "port"
    Checkpointer(str(other)).save(4, restored)
    for name in ("data.msgpack.zst", "manifest.json"):
        assert (tmp_path / "step_00000004" / name).read_bytes() == \
            (other / "step_00000004" / name).read_bytes()


@pytest.mark.parametrize("n_keys,key_len,value_len", [
    (0, 1, 0), (1, 1, 0), (15, 31, 255), (16, 32, 256), (3, 255, 65535),
    (2, 256, 65536), (70000, 3, 1), (1, 70000, 3)])
def test_own_msgpack_codec_is_byte_identical(n_keys, key_len, value_len):
    """Every header width of the map, str and bin forms the format
    uses."""
    rng = np.random.default_rng(n_keys)
    payload = {f"{i:0{key_len}d}"[-key_len:] if key_len > 8
               else f"k{i}": rng.bytes(value_len) for i in range(n_keys)}
    blob = msgpack.packb(payload, use_bin_type=True)
    assert C.packb(payload) == blob
    assert C.unpackb(blob) == msgpack.unpackb(blob, raw=False)


def test_own_msgpack_codec_refuses_other_shapes():
    for other in ({"a": 1}, {"a": "text"}, [b"x"], {"a": b"x", "b": None}):
        with pytest.raises(ValueError, match="msgpack"):
            C.unpackb(msgpack.packb(other, use_bin_type=True))


def test_zstd_is_read_by_its_magic_bytes(tmp_path, monkeypatch):
    """Written without zstandard, the payload is plain msgpack and reads
    back; a compressed file where zstandard is missing raises by name."""
    monkeypatch.setattr(C, "_Z", None)
    ck = Checkpointer(str(tmp_path / "plain"))
    ck.save(1, {"x": torch.arange(3.0)})
    blob = (tmp_path / "plain" / "step_00000001" /
            "data.msgpack.zst").read_bytes()
    assert blob[:4] != C.ZSTD_MAGIC
    assert torch.equal(ck.restore({"x": torch.zeros(3)})[0]["x"],
                       torch.arange(3.0))
    monkeypatch.undo()
    Checkpointer(str(tmp_path / "z")).save(1, {"x": torch.arange(3.0)})
    monkeypatch.setattr(C, "_ZD", None)
    with pytest.raises(RuntimeError, match="zstandard"):
        Checkpointer(str(tmp_path / "z")).restore({"x": torch.zeros(3)})


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_heartbeat_and_monitor(tmp_path):
    d = str(tmp_path)
    for h in range(3):
        Heartbeat(d, h).beat(step=100)
    Heartbeat(d, 3).beat(step=50)      # lagging host
    mon = HealthMonitor(d, timeout_s=1e9, step_lag=5)
    assert mon.stalled() == [3]


def test_straggler_detector():
    det = StragglerDetector(factor=2.0)
    for s in range(20):
        assert not det.record(s, 1.0)
    assert det.record(20, 5.0)
    assert det.events and det.events[0]["step"] == 20


def test_supervisor_builds_the_state_only_on_a_save_step(tmp_path):
    ck = Checkpointer(str(tmp_path))
    sup = TrainSupervisor(ck, str(tmp_path / "hb"), save_every=2)
    calls = []

    def state():
        calls.append(1)
        return {"x": torch.full((2,), float(len(calls)))}
    for step in range(5):
        info = sup.on_step(step, state)
        assert info.get("saved", False) == (step in (2, 4))
    ck.wait()
    assert len(calls) == 2 and ck.all_steps() == [2, 4]
    restored, step, _ = sup.resume_or_init({"x": torch.zeros(2)})
    assert step == 4 and torch.equal(restored["x"], torch.full((2,), 2.0))
    assert HealthMonitor(str(tmp_path / "hb")).read()[0]["step"] == 4


# ---------------------------------------------------------------------------
# the reverse conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["minicpm-2b", "zamba2-2.7b",
                                  "whisper-base"])
def test_params_and_opt_state_cross_to_the_reference_layout(arch):
    from repro.checkpoint.ckpt import _flatten as ref_flatten
    rcfg, pcfg = ref_arch(arch).reduced(), get_arch(arch).reduced()
    rp = jax.device_get(ref_build(rcfg).init_params(jax.random.PRNGKey(0)))
    model = lm_params_from_reference(rp, pcfg, "cpu")
    back = lm_params_to_reference(model, pcfg)
    want, got = ref_flatten(rp), C._flatten(back)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape
        assert C.DTYPE_NAMES[got[k].dtype] == (
            "<bf16>" if str(w.dtype) == "bfloat16" else str(w.dtype))
        assert np.array_equal(got[k].float().numpy(), w.astype(np.float32))
    # a copy: training the model leaves the tree as it was
    before = C._flatten(back)["embed"].clone()
    with torch.no_grad():
        model.embed.add_(1.0)
    assert torch.equal(C._flatten(back)["embed"], before)

    opt = AdamW(lr=lambda c: torch.tensor(1e-3))
    leaves = list(model.parameters())
    state = opt.init(leaves)
    for i, (m, v) in enumerate(zip(state.mu, state.nu)):
        m.fill_(i)
        v.fill_(2 * i)
    ref_state = opt_state_to_reference(state, model)
    ropt = RefAdamW(lr=lambda c: c).init(rp)
    assert C._flatten(ref_state.mu).keys() == ref_flatten(ropt.mu).keys()
    again = opt_state_from_reference(tuple(ref_state), model, "cpu")
    for a, b in zip(again.mu + again.nu, state.mu + state.nu):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert again.count.dtype == torch.int32


# ---------------------------------------------------------------------------
# the trainer's command line, beside the reference's
# ---------------------------------------------------------------------------

def _run(module, args, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", module, *args],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _losses(stdout):
    return [float(line.split("loss")[1].split()[0])
            for line in stdout.splitlines()
            if line.startswith("[train] step")]


ARGS = ["--arch", "minicpm-2b", "--reduced", "--batch", "4", "--seq", "64",
        "--save-every", "2", "--log-every", "1"]


def test_training_loss_decreases(tmp_path):
    """``tests/test_system.py``'s run of the reference, on the port."""
    out = _run("repro_torch.launch.train",
               ["--arch", "minicpm-2b", "--reduced", "--steps", "25",
                "--batch", "4", "--seq", "64", "--log-every", "5",
                "--ckpt-dir", str(tmp_path), "--device", "cpu"], tmp_path)
    line = [ln for ln in out.splitlines() if "done:" in ln][0]
    first = float(line.split("first loss")[1].split()[0])
    last = float(line.split()[-1])
    assert last < first, line
    # the supervisor's heartbeat (no save: 25 steps, a save every 100)
    assert os.listdir(tmp_path / "hb") == ["host_00000.hb"]


def test_checkpoints_cross_between_the_two_trainers(tmp_path):
    """The reference trains 6 steps, checkpointing at steps 2 and 4. The
    port resumes its step-2 checkpoint alone and continues at step 3:
    steps 3-5 within bfloat16 tolerance of the reference's (2e-3
    relative: the model is bfloat16 and the two packages round its ops
    apart). The port's step-4 checkpoint then restores through the
    reference's ``Checkpointer`` into the reference trainer's state, and
    the reference's step 5 from it matches its own uninterrupted step 5.
    (That last part runs in-process: the reference's ``train.py`` cannot
    resume any checkpoint, its own included, since ``restore`` hands its
    ``AdamWState`` back as a plain tuple that ``device_put`` refuses.)"""
    ref_dir, port_dir = tmp_path / "r", tmp_path / "p"
    ref_out = _run("repro.launch.train",
                   ARGS + ["--steps", "6", "--ckpt-dir", str(ref_dir)],
                   tmp_path)
    want = _losses(ref_out)
    assert len(want) == 6
    shutil.copytree(ref_dir / "step_00000002", port_dir / "step_00000002")
    out = _run("repro_torch.launch.train",
               ARGS + ["--steps", "6", "--ckpt-dir", str(port_dir),
                       "--device", "cpu"], tmp_path)
    assert "[train] resumed from step 2; continuing at step 3" in out
    np.testing.assert_allclose(_losses(out), want[3:], rtol=2e-3)
    manifests = [json.load(open(d / "step_00000004" / "manifest.json"))
                 for d in (ref_dir, port_dir)]
    assert manifests[0]["tensors"] == manifests[1]["tensors"]

    from repro.data.pipeline import DataCfg, TokenPipeline
    from repro.launch.train import make_step
    from repro.optim.adamw import AdamWState as RefState
    cfg = ref_arch("minicpm-2b").reduced()
    api = ref_build(cfg)
    opt = RefAdamW(lr=ref_wsd(3e-4, warmup=5, stable=4, decay=1))
    params = api.init_params(jax.random.PRNGKey(0))
    restored, step, _ = RefCheckpointer(str(port_dir)).restore(
        {"params": params, "opt": opt.init(params)}, 4)
    assert step == 4 and int(restored["opt"][2]) == 5
    batch = TokenPipeline(DataCfg(cfg.vocab, 64, 4, seed=0)).batch(5)
    _, _, _, m = make_step(api, opt, False)(
        restored["params"], RefState(*restored["opt"]), None,
        {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), want[5], rtol=2e-3)


def test_trainer_refuses_a_model_axis_and_a_missing_card():
    """A model axis that does not divide the world (2 ranks of torch's
    fake process group) raises and names both numbers; without a card
    and without ``--device cpu`` the trainer raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(ValueError, match=r"model axis of 3 .* world "
                                             r"size 2"):
            train.main(["--arch", "minicpm-2b", "--reduced", "--model-axis",
                        "3", "--device", "cpu"])
    finally:
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train.main(["--arch", "minicpm-2b", "--reduced"])


def test_trainer_rate_leaves_out_the_first_step(monkeypatch, capsys):
    """The ``s/step`` of a logged line counts the steps since the first
    logged step's loss was read (a read that synchronises), so step 0's
    warm-up stays out of it: here step 0 takes 100 s of a made-up clock
    and every later step 1 s, and each rate reads 1.00."""
    import types
    now = [0.0]
    monkeypatch.setattr(train, "time", types.SimpleNamespace(
        perf_counter=lambda: now[0]))

    def advance(step, metrics):
        now[0] += 100.0 if step == 0 else 1.0
    train.main(["--arch", "minicpm-2b", "--reduced", "--steps", "11",
                "--batch", "2", "--seq", "16", "--log-every", "5",
                "--device", "cpu"], on_step=advance)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[train] step")]
    assert len(lines) == 3 and "s/step" not in lines[0]
    assert [ln.split("(")[-1] for ln in lines[1:]] == ["1.00s/step)"] * 2
