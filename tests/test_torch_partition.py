"""``repro_torch.runtime.partition`` and ``repro_torch.launch.mesh``
against ``repro.runtime.partition`` and ``repro.launch.mesh``: the spec
arithmetic equal entry by entry on the reference's own shape trees (every
arch, full and reduced, and every shape in ``SHAPES``), the port's
per-layer specs equal to the reference leaf's less its stack entry, the
placements of a spec on a mesh, and the meshes' shapes on torch's fake
process group. No process is spawned here."""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import all_archs as ref_archs
from repro.models.api import build_model as ref_build
from repro.runtime import partition as RPT
from repro_torch.configs.base import SHAPES, get_arch
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import mesh as M
from repro_torch.runtime import partition as PT
from repro_torch.runtime.partition import P

STACKED = ("layers", "enc_layers", "dec_layers")
ARCHS = sorted(ref_archs())


def _norm(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def _same_tree(got, want, where=""):
    """Equal structure, and equal specs entry by entry at the leaves."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (tuple, list)) and not isinstance(want, JP):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{where}#{i}")
    else:
        assert isinstance(got, P), (where, got)
        assert _norm(got) == _norm(want), (where, got, want)


def _ref_cfg(name, reduced):
    cfg = ref_archs()[name]
    return cfg.reduced() if reduced else cfg


def _shapes(name, reduced):
    api = ref_build(_ref_cfg(name, reduced))
    return jax.eval_shape(api.init_params, jax.random.PRNGKey(0))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_equal_the_reference(arch, reduced):
    sds = _shapes(arch, reduced)
    _same_tree(PT.param_specs(sds, STACKED), RPT.param_specs(sds, STACKED))
    _same_tree(PT.zero1_specs(sds, stacked_prefixes=STACKED),
               RPT.zero1_specs(sds, stacked_prefixes=STACKED))
    # the reference's defaults too
    _same_tree(PT.param_specs(sds), RPT.param_specs(sds))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_and_batch_specs_equal_the_reference(arch):
    for reduced in (False, True):
        api = ref_build(_ref_cfg(arch, reduced))
        cfg = get_arch(arch).reduced() if reduced else get_arch(arch)
        for name, ref_shape in REF_SHAPES.items():
            shape = SHAPES[name]
            assert (shape.seq_len, shape.global_batch, shape.kind) == (
                ref_shape.seq_len, ref_shape.global_batch, ref_shape.kind)
            state = api.state_specs(ref_shape)
            _same_tree(PT.decode_state_specs(cfg, shape, state),
                       RPT.decode_state_specs(api.cfg, ref_shape, state),
                       f"{arch}/{name}")
            batch = api.input_specs(ref_shape)
            for gb in (1, 2, ref_shape.global_batch):
                _same_tree(PT.batch_specs(batch, gb),
                           RPT.batch_specs(batch, gb), f"{arch}/{name}/{gb}")


def test_fix_spec_repairs_indivisible_dims():
    # the reference's own cases (tests/test_substrate.py)
    spec = PT.fix_spec(P("model", None, None), (40, 1536, 512))
    assert spec == P(None, "model", None)
    spec = PT.fix_spec(P("model", None, None), (16, 5120, 8192))
    assert spec == P("model", None, None)
    for entries, shape in [(("model", None, None), (40, 1536, 512)),
                           ((("pod", "data"), "model"), (6, 48)),
                           (("data", None), (8, 32)),
                           ((None, "model"), (3, 5))]:
        assert _norm(PT.fix_spec(P(*entries), shape)) == _norm(
            RPT.fix_spec(JP(*entries), shape))


def test_zero1_prefers_stack_axis():
    params = {"layers": {"wq": jax.ShapeDtypeStruct((48, 512, 512),
                                                    jax.numpy.bfloat16)}}
    assert PT.zero1_specs(params)["layers"]["wq"][0] == "data"
    # torch leaves (meta tensors) take the same path
    meta = {"layers": {"wq": torch.empty(48, 512, 512, device="meta")}}
    assert PT.zero1_specs(meta)["layers"]["wq"] == P("data", None, "model")


def test_filter_spec_drops_missing_axes():
    assert PT.filter_spec(P(("pod", "data"), None), ("data", "model")) == \
        P(("data",), None)
    assert PT.filter_spec(P("pod", "model"), ("data", "model")) == \
        P(None, "model")
    for entries in [(("pod", "data"), None), ("pod", "model"),
                    (None, ("data", "model")), ("data",)]:
        for names in [("data", "model"), ("pod", "data", "model"), ()]:
            assert _norm(PT.filter_spec(P(*entries), names)) == _norm(
                RPT.filter_spec(JP(*entries), names))


def _meta_model(arch, reduced):
    """The port's model for ``arch`` with meta tensors of the reference's
    shapes and dtypes (no memory, any width)."""
    cfg = get_arch(arch).reduced() if reduced else get_arch(arch)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    tree = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, dtype=dtypes[str(s.dtype)],
                              device="meta"), _shapes(arch, reduced))
    return lm_params_from_reference(tree, cfg, "meta"), cfg


@pytest.mark.parametrize("arch", ARCHS)
def test_model_specs_are_the_reference_leaf_specs_less_the_stack_entry(arch):
    for reduced in (False, True):
        model, _ = _meta_model(arch, reduced)
        want = RPT.tree_paths(RPT.param_specs(_shapes(arch, reduced),
                                              STACKED))
        got = PT.model_specs(model)
        assert len(got) == len(list(model.parameters()))
        for name, spec in got.items():
            parts = name.split(".")
            if parts[0] in STACKED:
                ref = want["/".join([parts[0]] + parts[2:])]
                assert ref[0] is None
                assert _norm(spec) == _norm(ref[1:]), name
            else:
                assert _norm(spec) == _norm(want[name.replace(".", "/")])


def test_no_reference_spec_shards_the_layer_stack():
    """A per-layer module cannot hold a spec on the stack axis; list every
    stacked leaf whose spec names one, over all archs (there is none, so
    ``place_model`` replicates nothing it should have sharded)."""
    found = []
    for arch in ARCHS:
        for reduced in (False, True):
            specs = RPT.tree_paths(RPT.param_specs(_shapes(arch, reduced),
                                                   STACKED))
            found += [(arch, reduced, path, spec)
                      for path, spec in specs.items()
                      if path.split("/")[0] in STACKED
                      and spec[0] is not None]
    assert found == []


class _Mesh:
    def __init__(self, *names, sizes=None):
        self.mesh_dim_names = names
        self.sizes = sizes or (2,) * len(names)

    def size(self, i):
        return self.sizes[i]


def test_placements_map_a_spec_onto_the_mesh_dims():
    dm = _Mesh("data", "model")
    assert PT.placements(P(None, "model"), dm) == [Replicate(), Shard(1)]
    assert PT.placements(P("model", None, None), dm) == [Replicate(),
                                                        Shard(0)]
    assert PT.placements(P(("pod", "data"), None, "model"), dm) == [
        Shard(0), Shard(2)]
    assert PT.placements(P(None, None), dm) == [Replicate(), Replicate()]
    pdm = _Mesh("pod", "data", "model")
    assert PT.placements(P(("pod", "data"), None), pdm) == [
        Shard(0), Shard(0), Replicate()]
    with pytest.raises(ValueError, match="order"):
        PT.placements(P(("data", "pod"), None), pdm)
    with pytest.raises(ValueError, match="twice"):
        PT.placements(P("model", "model"), dm)
    # an axis of one rank holds the whole tensor: nothing is sharded on it
    one = _Mesh("data", "model", sizes=(4, 1))
    assert PT.placements(P("data", "model"), one) == [Shard(0), Replicate()]


def test_shard_is_a_no_op_outside_a_mesh_and_for_a_plain_tensor():
    x = torch.arange(6.0)
    assert PT.current_mesh() is None and PT.axis_size("model") == 1
    assert PT.shard(x, P("data")) is x
    with PT.use_mesh(None):
        assert PT.shard(x, P("data")) is x
    assert PT.current_mesh() is None


@pytest.fixture
def fake_group():
    """torch's fake process group of a given world size (no process, no
    communication), destroyed after the test."""
    def start(world):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def test_production_meshes_keep_the_reference_shapes(fake_group):
    for multi_pod, world, shape, names in [
            (False, 256, (16, 16), ("data", "model")),
            (True, 512, (2, 16, 16), ("pod", "data", "model"))]:
        fake_group(world)
        m = M.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert tuple(m.mesh.shape) == shape
        assert tuple(m.mesh_dim_names) == names
        # the rank grid is row-major, as jax.make_mesh's device grid
        assert np.array_equal(m.mesh.numpy().reshape(-1), np.arange(world))
        with PT.use_mesh(m):
            assert PT.axis_size("model") == 16
            assert PT.axis_size("pod") == (2 if multi_pod else 1)
            with PT.use_mesh(None):
                assert PT.axis_size("model") == 1
            assert PT.current_mesh() is m


def test_local_mesh_splits_the_world_and_refuses_what_does_not_divide(
        fake_group):
    fake_group(4)
    m = M.make_local_mesh(2, "cpu")
    assert tuple(m.mesh.shape) == (2, 2)
    assert tuple(m.mesh_dim_names) == ("data", "model")
    with pytest.raises(ValueError, match=r"model axis of 3 .* world size 4"):
        M.make_local_mesh(3, "cpu")
    with pytest.raises(ValueError, match=r"model axis of 0"):
        M.make_local_mesh(0, "cpu")
