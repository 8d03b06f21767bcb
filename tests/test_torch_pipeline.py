"""``repro_torch.runtime.pipeline``: the GPipe schedule on a (4,) ('pod',)
mesh of four ``gloo`` ranks equals the serial loop, forward and every
gradient, on every stage (the reference's ``tests/test_pipeline.py``: L =
8, D = 16, B = 12, 6 microbatches, ``tanh(h @ w + b)``); and the serial
loop equals the reference's ``lax.scan`` on the same numpy parameters."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import torch_mesh_workers as W
from repro.runtime.pipeline import pipeline_forward as ref_pipeline
from repro_torch.runtime.pipeline import pipeline_forward

L, D, B = 8, 16, 12


def _inputs():
    rng = np.random.default_rng(0)
    return {"w": (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32),
            "b": (rng.standard_normal((L, D)) * 0.1).astype(np.float32),
            "x": rng.standard_normal((B, D)).astype(np.float32)}


@pytest.fixture(scope="module")
def piped(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    np.savez(d / "pipe_in.npz", **_inputs())
    W.spawn("pipeline_four_stages", 4, d, timeout=240)
    with open(d / "pipe.json") as f:
        return json.load(f)


def test_four_stages_equal_the_serial_loop_forward_and_backward(piped):
    assert len(piped["stages"]) == 4
    for errs in piped["stages"]:
        assert errs["forward"] < 1e-5, errs
        assert len(errs["grads"]) == 3 and max(errs["grads"]) < 1e-5, errs


def test_the_serial_loop_equals_the_reference_scan(piped):
    data = _inputs()
    p = {k: jnp.asarray(data[k]) for k in ("w", "b")}

    def layer(lp, h):
        return jnp.tanh(h @ lp["w"] + lp["b"])
    want = ref_pipeline(layer, p, jnp.asarray(data["x"]), 6)   # no mesh
    ref_scan, _ = lax.scan(lambda h, lp: (layer(lp, h), None),
                           jnp.asarray(data["x"]), p)
    got = pipeline_forward(
        lambda lp, h: torch.tanh(h @ lp["w"] + lp["b"]),
        {k: torch.from_numpy(data[k]) for k in ("w", "b")},
        torch.from_numpy(data["x"]), 6)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-6
    assert np.abs(got.numpy() - np.asarray(ref_scan)).max() < 1e-6
    # the spawned ranks' serial loop is this one
    assert np.array_equal(np.asarray(piped["serial"], np.float32),
                          got.numpy())


def test_outside_a_mesh_the_serial_loop_takes_any_batch():
    """Outside a mesh the serial loop runs whatever the microbatches."""
    x = torch.zeros(5, D)
    p = {k: torch.from_numpy(v) for k, v in _inputs().items() if k != "x"}
    assert pipeline_forward(lambda lp, h: h, p, x, 3).shape == (5, D)
