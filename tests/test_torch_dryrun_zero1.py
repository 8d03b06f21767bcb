"""The dry run's ZeRO-1 train step on a (2, 2) ``gloo`` mesh of four
ranks on the CPU (``torch_mesh_workers.dryrun_zero1_four_ranks``), on
real tensors: each rank's gradients reduce-scattered into the moments'
``zero1_specs`` placements (a layer stack is one moment), AdamW on its
shards, the updated shards gathered back into the parameters.

Two steps of it, for a dense, an MoE and an encoder-decoder arch, hold
to two steps of the trainer on the same batch (float32):

* against the one-device step on the whole batch: losses within 1e-5 and
  gradient norms within 1e-4 relative, the first step's moments within
  1e-5 of their largest magnitude (measured: at most 2.2e-6), and the
  parameters as ``torch_mesh_workers.same_training`` holds the trainer's
  own mesh runs: within 3.6e-4, at most 0.1% of entries past 1e-6
  (measured: 3.2e-4, 0.008%). The few entries past 1e-6 have gradients
  near AdamW's eps (1e-8), where ``m / (sqrt(v) + eps)`` turns a
  summation-order difference into one of up to the learning rate;
* against the trainer's mesh step (``launch.train.make_step`` with the
  mesh, moments placed like the parameters) on the same rows: the
  parameters within 1e-5 (measured: at most 2.2e-6)."""
import json

import numpy as np
import pytest

import torch_mesh_workers as W

TOL = 1e-5


@pytest.fixture(scope="module")
def zero1(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero1")
    W.spawn("dryrun_zero1_four_ranks", 4, d, timeout=300)
    with open(d / "zero1.json") as f:
        return json.load(f)


@pytest.mark.parametrize("arch", W.ZERO1_ARCHS)
def test_zero1_step_on_a_mesh_equals_the_one_device_trainer(zero1, arch):
    got = zero1[arch]
    losses = np.array(got["losses"])
    gnorms = np.array(got["gnorms"])
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=TOL)
    np.testing.assert_allclose(gnorms[:, 0], gnorms[:, 1], rtol=1e-4)
    assert got["moment_err"] <= TOL, got
    assert got["param_err"] <= 3.6e-4, got
    assert got["param_past"] <= 1e-3 * got["param_n"], got
    assert got["count"] == W.ZERO1_STEPS
    assert 0 < got["stacked"] < got["groups"], got


@pytest.mark.parametrize("arch", W.ZERO1_ARCHS)
def test_zero1_step_on_a_mesh_equals_the_trainers_mesh_step(zero1, arch):
    assert zero1[arch]["mesh_err"] <= TOL, zero1[arch]
