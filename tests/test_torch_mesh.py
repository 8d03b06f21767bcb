"""The port on ``gloo`` meshes of four ranks on the CPU: parameters placed
by ``runtime.partition.place_model``, the trainer on (2, 2) against (1,
1), a (2, 2) checkpoint restored with ``elastic_remesh`` onto (4, 1) and
(1, 1), the MoE layer's expert-parallel path against its global path and
the reference's ``moe_apply``, and attention split by heads (evenly and
not) and by query rows.

One spawn runs every case (``torch_mesh_workers.mesh_four_ranks``); the
reference computes here, on the parameters written for the ranks."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_workers as W
from repro.configs.base import MoESpec as RefMoESpec
from repro.models.moe import moe_apply as ref_moe_apply
from repro.models.moe import moe_init as ref_moe_init


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    spec = RefMoESpec(n_experts=4, top_k=2, capacity_factor=8.0)
    p = ref_moe_init(jax.random.PRNGKey(0), 32, 64, spec, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 32), jnp.float32)
    w = np.random.default_rng(2).standard_normal((4, 8, 32)).astype(
        np.float32)
    np.savez(d / "moe_in.npz", x=np.asarray(x), w=w,
             **{k: np.asarray(v) for k, v in p.items()})
    W.spawn("mesh_four_ranks", 4, d, timeout=300)
    with open(d / "mesh.json") as f:
        out = json.load(f)
    ref_y, ref_aux = ref_moe_apply(p, spec, 64, x, "gspmd")
    out["ref"] = {"y": np.asarray(ref_y), "aux": float(ref_aux)}
    out["dir"] = d
    return out


def test_place_model_gives_every_parameter_its_spec(mesh):
    assert len(mesh["placed"]) == 10
    assert all(mesh["placed"].values()), mesh["placed"]


@pytest.mark.parametrize("extra", [[], ["--grad-compression"]],
                         ids=["plain", "compressed"])
def test_minicpm_on_two_by_two_equals_one_rank(mesh, extra):
    W.same_training(mesh["dir"], W.tag("minicpm-2b", extra, "2x2"),
                    W.tag("minicpm-2b", extra, "1x1"))


@pytest.mark.parametrize("onto", ["4x1", "1x1"])
def test_a_two_by_two_checkpoint_remeshes_bit_for_bit(mesh, onto):
    got = mesh["remesh"][onto]
    assert got["mesh"] == [int(n) for n in onto.split("x")]
    assert got["placements"] and got["exact"], got


@pytest.mark.parametrize("onto", ["4x1", "1x1"])
def test_a_resume_on_another_mesh_continues_the_run(mesh, onto):
    """Resumed at step 2 from the (2, 2) run's step 1, the run's step 2
    equals the uninterrupted (2, 2) run's within the trainer's limits."""
    d = mesh["dir"]
    got, gflat = W.read_run(d, f"resume_{onto}")
    want, wflat = W.read_run(d, W.tag("minicpm-2b", [], "2x2"))
    np.testing.assert_allclose(got["losses"], want["losses"][2:],
                               rtol=1e-5)
    np.testing.assert_allclose(got["gnorms"], want["gnorms"][2:],
                               rtol=1e-4)
    for k in wflat:
        if k.startswith("params/"):
            np.testing.assert_allclose(gflat[k].numpy(), wflat[k].numpy(),
                                       atol=3.6e-4, err_msg=k)


def test_elastic_remesh_roundtrip_on_a_one_rank_mesh(mesh):
    """The reference's test on a (1,) ('data',) mesh, a None leaf kept."""
    assert mesh["roundtrip"]


def test_expert_parallel_moe_equals_the_global_path_and_the_reference(mesh):
    moe, ref = mesh["moe"], mesh["ref"]
    ep, glob = np.asarray(moe["shard_map"]["y"]), np.asarray(
        moe["gspmd"]["y"])
    assert ep.shape == glob.shape == ref["y"].shape == (4, 8, 32)
    assert np.abs(ep - glob).max() < 1e-4
    assert np.abs(glob - ref["y"]).max() < 1e-4
    assert np.abs(ep - ref["y"]).max() < 1e-4
    # the global path keeps the global batch's aux loss
    assert abs(moe["gspmd"]["aux"] - ref["aux"]) < 1e-6
    for k, g in moe["gspmd"]["grads"].items():
        np.testing.assert_allclose(moe["shard_map"]["grads"][k], g,
                                   atol=1e-4, err_msg=k)


def test_the_global_moe_on_a_mesh_drops_the_pairs_one_device_drops(mesh):
    """Capacity factor 0.5 (C = 8 of 64 routed pairs an expert would
    need): the 2 x 2 mesh's global path equals the one-device layer,
    dropped pairs and aux loss included."""
    drops = mesh["moe"]["drops"]
    assert drops["zero_rows"] > 0          # some token lost both experts
    assert drops["y"] < 1e-6 and drops["aux"] < 1e-7, drops


@pytest.mark.parametrize("case,split", [
    ("heads_1x4", "heads"), ("uneven_2x2", "heads"), ("rows_1x4", "rows"),
    ("rows_noncausal_1x4", "rows")])
def test_attention_on_a_mesh_equals_one_device(mesh, case, split):
    """The output and every gradient within 1e-5 of the one-device
    call's largest entry (float32 sums in another order)."""
    got = mesh["attention"][case]
    assert got["split"] == split
    assert got["out"] < 1e-5 and got["grads"] < 1e-5, got


def test_compat_make_mesh_defaults_to_the_card():
    """``compat_make_mesh`` builds its mesh on the card unless the caller
    asks for the CPU, as ``make_production_mesh`` and ``make_local_mesh``
    do; the CPU callers among the mesh jobs name ``"cpu"`` themselves."""
    import inspect

    from repro_torch.launch import mesh as M
    for fn, arg in ((M.compat_make_mesh, "device_type"),
                    (M.make_production_mesh, "device_type"),
                    (M.make_local_mesh, "device")):
        assert inspect.signature(fn).parameters[arg].default == "cuda"
    calls = [line for line in inspect.getsource(W).splitlines()
             if "compat_make_mesh((" in line]
    assert len(calls) == 2 and all('), "cpu")' in c for c in calls)
