"""The port's trainer on ("data", "model") meshes of ``gloo`` ranks on the
CPU (``launch.train --model-axis``), against the same trainer on a (1, 1)
mesh, which equals the one-device trainer with no mesh bit for bit.

One spawn of two ranks runs every case (``torch_mesh_workers.
trainer_two_ranks``): minicpm-2b on (2, 1) and (1, 2) with and without
``--grad-compression``, every other family on (1, 2) (granite-moe with
both MoE impls, mamba2, zamba2, whisper, internvl2), then on one rank
the (1, 1) baselines and the trainer with no mesh. Reduced configs in
float32, seq 32, batch 4, 3 steps. Limits: losses within 1e-5 and the
gradient norm within 1e-4 relative; the parameters after 3 steps within
3.6e-4 with at most 0.1% of entries past 1e-6."""
import pytest

import torch_mesh_workers as W


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_train")
    W.spawn("trainer_two_ranks", 2, d, timeout=300)
    return d


@pytest.mark.parametrize("extra", [[], ["--grad-compression"]],
                         ids=["plain", "compressed"])
def test_one_rank_mesh_is_the_one_device_trainer_bit_for_bit(runs, extra):
    W.same_training(runs, W.tag("minicpm-2b", extra, "1x1"),
                    W.tag("minicpm-2b", extra, "nomesh"), exact=True)


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
@pytest.mark.parametrize("extra", [[], ["--grad-compression"]],
                         ids=["plain", "compressed"])
def test_minicpm_on_a_mesh_equals_one_rank(runs, mesh, extra):
    W.same_training(runs, W.tag("minicpm-2b", extra, mesh),
                    W.tag("minicpm-2b", extra, "1x1"))


@pytest.mark.parametrize("arch,extra", W.FAMILIES,
                         ids=[W.tag(a, e, "") for a, e in W.FAMILIES])
def test_every_family_on_a_model_axis_of_two_equals_one_rank(runs, arch,
                                                              extra):
    W.same_training(runs, W.tag(arch, extra, "1x2"),
                    W.tag(arch, extra, "1x1"))
