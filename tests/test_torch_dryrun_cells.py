"""``repro_torch.launch.dryrun.run_cell`` on a 2 x 2 ('data', 'model')
mesh of torch's fake process group, for one arch of each family at
reduced size and each shape kind (train, prefill, decode; the
sub-quadratic families' single-request long-context decode too): every
cell runs (``status: ok``), and its per-rank parameter, moment and batch
bytes equal what the reference's specs give for that mesh, computed here
independently from ``repro.runtime.partition`` on the reference's own
shape trees. The ssm and hybrid prefill cells run at 512 tokens instead
of 32768: their chunked scan loops over the sequence's 2048 chunks of 16
op by op, 19 s a cell under ``FakeTensorMode``; both sides take the same
shape."""
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import ShapeCfg as RefShape
from repro.configs.base import all_archs as ref_archs
from repro.models.api import build_model as ref_build
from repro.runtime import partition as RPT
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import dryrun as D

STACKED = ("layers", "enc_layers", "dec_layers")
SIZES = {"data": 2, "model": 2}          # the test mesh; no 'pod'
FAMILIES = {"dense": "minicpm-2b", "moe": "granite-moe-3b-a800m",
            "vlm": "internvl2-76b", "ssm": "mamba2-1.3b",
            "hybrid": "zamba2-2.7b", "audio": "whisper-base"}
SHORT_PREFILL = 512
CELLS = [(fam, shape) for fam in FAMILIES
         for shape in ("train_4k", "prefill_32k", "decode_32k")] + [
    ("ssm", "long_500k"), ("hybrid", "long_500k")]


def _leaf_bytes(leaf, spec, itemsize=None) -> int:
    """One rank's bytes of a leaf placed by ``spec`` on the test mesh (in
    its dtype, or ``itemsize`` bytes an element)."""
    n = 1
    for i, dim in enumerate(leaf.shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= -(-dim // math.prod(SIZES.get(a, 1) for a in axes))
    return n * (itemsize or np.dtype(leaf.dtype).itemsize)


def _tree_bytes(tree, specs, itemsize=None) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return sum(_leaf_bytes(t, s, itemsize)
               for t, s in zip(leaves, spec_leaves))


@pytest.fixture
def no_group():
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("family,shape_name", CELLS)
def test_a_cell_on_two_by_two(family, shape_name, monkeypatch, no_group):
    arch = FAMILIES[family]
    ref_shape = REF_SHAPES[shape_name]
    if family in ("ssm", "hybrid") and shape_name == "prefill_32k":
        monkeypatch.setitem(D.SHAPES, shape_name, ShapeCfg(
            shape_name, SHORT_PREFILL, ref_shape.global_batch, "prefill"))
        ref_shape = RefShape(shape_name, SHORT_PREFILL,
                             ref_shape.global_batch, "prefill")
    rec = D.run_cell(arch, shape_name, False, mesh_shape=(2, 2),
                     reduced=True)
    assert rec["status"] == "ok", rec
    assert rec["mesh"] == "2x2" and rec["roofline"]["chips"] == 4

    ref_cfg = ref_archs()[arch].reduced()
    api = ref_build(ref_cfg)
    sds = jax.eval_shape(lambda: api.init_params(jax.random.PRNGKey(0)))
    mem = rec["memory"]
    assert mem["param_bytes"] == _tree_bytes(
        sds, RPT.param_specs(sds, STACKED))
    batch = api.input_specs(ref_shape)
    assert mem["batch_bytes"] == _tree_bytes(
        batch, RPT.batch_specs(batch, ref_shape.global_batch))
    if ref_shape.kind == "train":
        moments = _tree_bytes(sds, RPT.zero1_specs(
            sds, stacked_prefixes=STACKED), itemsize=4)   # float32
        assert mem["opt_state_bytes"] == 2 * moments + 4    # + the count
    if ref_shape.kind == "decode":
        state = api.state_specs(ref_shape)
        assert mem["state_bytes"] == _tree_bytes(
            state, RPT.decode_state_specs(ref_cfg, ref_shape, state))
    assert mem["argument_bytes"] == (mem["param_bytes"]
                                     + mem["opt_state_bytes"]
                                     + mem["batch_bytes"]
                                     + mem["state_bytes"])
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes"]
    assert rec["roofline"]["flops"] > 0
