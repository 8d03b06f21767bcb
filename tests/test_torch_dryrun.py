"""``repro_torch.launch.dryrun`` and ``ModelAPI.input_specs``/
``state_specs`` against ``repro.launch.dryrun`` and ``repro.models.api``:
the specs' shapes and dtypes for every arch (full and reduced) and every
shape; the partition specs of the port's specs equal to the reference's
on its own; ``count_params``/``count_active_params`` equal to the
reference's for every arch at full width; the reduced dense arch's train
step counted by ``OpCosts`` against the reference's ``HLOCosts`` of the
same cell; a fake step and the same step on real tensors counting the
same FLOPs; one production cell at full width; the command line's lines
and exit codes. The cells on a 2 x 2 mesh are in
``test_torch_dryrun_cells.py``."""
import os
import subprocess
import sys

import jax
import pytest
import torch

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import ShapeCfg as RefShape
from repro.configs.base import all_archs as ref_archs
from repro.models.api import build_model as ref_build
from repro.optim.adamw import AdamW as RefAdamW
from repro.optim.adamw import clip_by_global_norm as ref_clip
from repro.optim.adamw import cosine_schedule as ref_cosine
from repro.roofline.hlo_costs import HLOCosts
from repro.runtime import partition as RPT
from repro_torch.configs.base import SHAPES, ShapeCfg, get_arch
from repro_torch.data.pipeline import DataCfg, TokenPipeline
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun as D
from repro_torch.launch import train
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.roofline.op_costs import OpCosts
from repro_torch.runtime import partition as PT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(ref_archs())


@pytest.fixture(scope="module")
def ref_dry():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` for its
    own command line (512 host devices): restored at once, before this
    process's JAX starts a backend."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return dryrun


def _sig(tree):
    """Shapes and dtypes of a tree of meta tensors or shape structs."""
    if isinstance(tree, dict):
        return {k: _sig(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_sig(v) for v in tree]
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


def _norm(tree):
    """A spec tree with the reference's and the port's specs alike."""
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(
            tree, (PT.P, jax.sharding.PartitionSpec)):
        return [_norm(v) for v in tree]
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in tree)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch, reduced):
    ref_cfg = ref_archs()[arch]
    cfg = get_arch(arch)
    if reduced:
        ref_cfg, cfg = ref_cfg.reduced(), cfg.reduced()
    ref, api = ref_build(ref_cfg), build_model(cfg)
    for name, ref_shape in REF_SHAPES.items():
        shape = SHAPES[name]
        batch, state = api.input_specs(shape), api.state_specs(shape)
        want_b, want_s = ref.input_specs(ref_shape), ref.state_specs(ref_shape)
        assert _sig(batch) == _sig(want_b), (arch, name)
        assert _sig(state) == _sig(want_s), (arch, name)
        assert all(t.device.type == "meta" for t in
                   list(batch.values()) + _flat(state))
        # the port's specs partitioned by the port equal the reference's
        # specs partitioned by the reference
        assert _norm(PT.batch_specs(batch, shape.global_batch)) == _norm(
            RPT.batch_specs(want_b, ref_shape.global_batch))
        assert _norm(PT.decode_state_specs(cfg, shape, state)) == _norm(
            RPT.decode_state_specs(ref_cfg, ref_shape, want_s))


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _flat(v)]
    return [tree]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_reference(arch, ref_dry):
    ref_cfg = ref_archs()[arch]
    sds = jax.eval_shape(lambda: ref_build(ref_cfg).init_params(
        jax.random.PRNGKey(0)))
    cfg = get_arch(arch)
    with D.FakeTensorMode():
        model = build_model(cfg).init_params(torch.Generator())
        assert D.count_params(model) == ref_dry.count_params(sds)
        assert D.count_active_params(cfg, model) == \
            ref_dry.count_active_params(ref_cfg, sds)
    # the reference's own tree counts alike through the port's functions
    assert D.count_params(sds) == ref_dry.count_params(sds)
    assert D.count_active_params(cfg, sds) == \
        ref_dry.count_active_params(ref_cfg, sds)


FLOP_ARCH, FLOP_B, FLOP_S = "minicpm-2b", 4, 128
FLOP_RATIO = 1.0444444444444445     # measured: port / reference


def test_train_step_flops_against_the_reference_hlo():
    """The reduced dense arch's train step (batch 4 x 128, one device):
    ``OpCosts`` of the port's step over ``HLOCosts`` of the reference's
    step lowered on one CPU device is 1.04444 (measured, pinned within
    2%). The whole difference is attention's backward: the flash
    backward recomputes the scores ``S = QK^T`` (``sdpa``'s count: 10
    bh sq sk d against the forward's 4), one product of 2 bh sq sk d a
    layer that XLA's derivative of the reference's attention reuses from
    its forward; the projections, the MLP, the logits and the
    cross-entropy count the same."""
    ref_cfg = ref_archs()[FLOP_ARCH].reduced()
    api = ref_build(ref_cfg)
    opt = RefAdamW(lr=ref_cosine(3e-4, 100, 10000))

    def step(params, opt_state, batch):      # the reference's dry run's
        (loss, aux), grads = jax.value_and_grad(api.loss, has_aux=True)(
            params, batch)
        grads, gnorm = ref_clip(grads, 1.0)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss
    psds = jax.eval_shape(lambda: api.init_params(jax.random.PRNGKey(0)))
    lowered = jax.jit(step).lower(psds, jax.eval_shape(opt.init, psds),
                                  api.input_specs(RefShape(
                                      "t", FLOP_S, FLOP_B, "train")))
    want = HLOCosts(lowered.compile().as_text()).flops()
    cfg = get_arch(FLOP_ARCH).reduced()
    got = D.trace_cell(cfg, ShapeCfg("t", FLOP_S, FLOP_B, "train"), None,
                       "cpu")["costs"].flops()
    assert abs(got / want / FLOP_RATIO - 1) <= 0.02, got / want
    recompute = 2 * FLOP_B * cfg.n_heads * FLOP_S ** 2 * cfg.hd
    assert got - want == recompute * cfg.n_layers


def test_a_fake_step_counts_what_the_real_step_counts():
    """The dry run's step (the trainer's, without a mesh) under
    ``FakeTensorMode`` and on real tensors (reduced minicpm-2b, batch 4 x
    64, the CPU): equal FLOPs, one ``strela::flash_fwd`` and one
    ``flash_bwd`` a layer, the plain versions only on the real tensors,
    and the real step's loss the trainer's."""
    cfg = get_arch("minicpm-2b").reduced()
    shape = ShapeCfg("t", 64, 4, "train")
    before = (fa.plain_calls, fa.backward_plain_calls)
    fake = D.trace_cell(cfg, shape, None, "cpu")["costs"]
    assert (fa.plain_calls, fa.backward_plain_calls) == before
    api = build_model(cfg)
    batch = train.make_batch(cfg, TokenPipeline(DataCfg(cfg.vocab, 64, 4)),
                             0, 4, "cpu")
    params = api.init_params(torch.Generator().manual_seed(0))
    opt = AdamW(lr=cosine_schedule(3e-4, 100, 10000))
    state = opt.init(list(params.parameters()))
    with OpCosts({"params": params, "state": state, "batch": batch}) as real:
        loss = D.make_train_step(api, opt)(params, state, batch)[2]["loss"]
    assert real.flops() == fake.flops() > 0
    n = cfg.n_layers
    for c in (fake, real):
        assert (c.calls["strela::flash_fwd"],
                c.calls["strela::flash_bwd"]) == (n, n)
    assert (fa.plain_calls, fa.backward_plain_calls) == (before[0] + n,
                                                         before[1] + n)
    want = api.loss(api.init_params(torch.Generator().manual_seed(0)),
                    batch)[0]
    assert float(loss) == float(want)
    assert real.peak_bytes >= real.argument_bytes > 0


@pytest.fixture
def no_group():
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_one_production_cell_at_full_width(ref_dry, no_group):
    """minicpm-2b x train_4k x 16 x 16 on a fake group of 256 ranks."""
    rec = D.run_cell("minicpm-2b", "train_4k", False)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    ref_cfg = ref_archs()["minicpm-2b"]
    sds = jax.eval_shape(lambda: ref_build(ref_cfg).init_params(
        jax.random.PRNGKey(0)))
    assert rec["n_params"] == ref_dry.count_params(sds)
    assert rec["n_params_active"] == ref_dry.count_active_params(ref_cfg,
                                                                 sds)
    rl = rec["roofline"]
    assert rl["chips"] == 256 and rl["flops"] > rl["model_flops"] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    mem = rec["memory"]
    assert mem["peak_bytes_per_device"] == (mem["argument_bytes"]
                                            + mem["temp_bytes"])
    assert rec["collectives"]["total_bytes"] == sum(
        rec["collectives"]["bytes_by_type"].values()) > 0


def test_the_command_line(monkeypatch, capsys, no_group):
    """A skipped cell exits 0 with the reference's line; a cell that
    raises is ``status: error`` and the run exits 1."""
    D.main(["--arch", "minicpm-2b", "--shape", "long_500k"])
    out = capsys.readouterr().out
    assert "[dryrun] minicpm-2b x long_500k x 16x16: skipped" in out
    assert "[dryrun] done: 0 ok, 1 skipped, 0 failed" in out

    def boom(*args, **kwargs):
        raise RuntimeError("no")
    monkeypatch.setattr(D, "run_cell", boom)
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "yi-9b", "--shape", "decode_32k", "--multi-pod"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "[dryrun] yi-9b x decode_32k x 2x16x16: error" in out


def test_importing_the_dry_run_starts_nothing():
    """No process group and no environment variable at import: the group
    starts in ``run_cell``."""
    code = ("import os, torch.distributed as dist\n"
            "env = dict(os.environ)\n"
            "import repro_torch.launch.dryrun\n"
            "assert dict(os.environ) == env\n"
            "assert not dist.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_a_collective_backward_runs_outside_the_ambient_mesh(no_group):
    """Autograd runs a CUDA tensor's backward on a device thread of its
    own, where ``partition.use_mesh``'s thread-local mesh is unset: the
    all-reduce of Megatron's f takes its groups from the forward (on the
    card, the 16 x 16 dry run's backward failed on the ambient mesh)."""
    import threading
    from repro_torch.runtime import tp
    mesh = D.cell_mesh(False, (2, 2), "cpu")
    x = torch.ones(4, 8, requires_grad=True)
    with PT.use_mesh(mesh):
        y = tp.enter_model(x) * 2
    out = {}

    def backward():
        try:
            out["grad"] = torch.autograd.grad(y.sum(), [x])[0]
        except Exception as e:          # re-raised below, in the test
            out["error"] = e
    t = threading.Thread(target=backward)
    t.start()
    t.join()
    assert "error" not in out, out.get("error")
    assert torch.equal(out["grad"], torch.full((4, 8), 2.0))
