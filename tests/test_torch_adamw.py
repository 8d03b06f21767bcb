"""The optimizer's step split into the norm, the clipping scale and an
update that applies the scale as it reads each gradient
(``optim/adamw.py`` ``clip_scale``, ``ScaledGrads``), on the plain path:
bit-equal to the eager clip-then-update on one device and on a one-rank
``gloo`` mesh. The kernels' operators (``kernels/adamw.py``) on ``meta``
and fake tensors: their fake implementations' metadata, the checks that
refuse what the kernels do not take, and what ``OpCosts`` counts for
them. The kernels themselves run only on the card
(``tests/test_torch_gpu_adamw.py``)."""
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import get_arch
from repro_torch.kernels import adamw as K
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import (AdamW, ScaledGrads, clip_by_global_norm,
                                     clip_scale, clip_scale_on_mesh,
                                     cosine_schedule, wsd_schedule)
from repro_torch.roofline.op_costs import OpCosts

BF16, F32 = torch.bfloat16, torch.float32
SHAPES = [(3, 5), (7,), (2, 4, 3), (1,), (64,)]
DTYPE_SETS = {"bfloat16": [BF16] * 5, "float32": [F32] * 5,
              "mixed": [BF16, F32, BF16, F32, F32]}


def _eager_clip(grads, max_norm):
    """The eager clipping the trainer ran before the split: a float32 sum
    of squares leaf by leaf, then a scaled copy of every gradient."""
    total = torch.zeros((), dtype=F32)
    for g in grads:
        total = total + torch.sum(g.to(F32) ** 2)
    norm = torch.sqrt(total)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return [(g.to(F32) * scale).to(g.dtype) for g in grads], norm


def _draw(gen, dtypes, scale):
    return [(torch.randn(s, generator=gen) * scale).to(dt)
            for s, dt in zip(SHAPES, dtypes)]


def _split_against_eager(dtypes, clip):
    """Twelve steps from the same parameters: the eager clip-then-update
    against ``clip(grads)`` and the update of ``ScaledGrads``; the second
    half of the steps has gradients large enough to be clipped."""
    gen = torch.Generator().manual_seed(0)
    opt = AdamW(lr=wsd_schedule(1e-2, warmup=3, stable=4, decay=4))
    eager = _draw(gen, dtypes, 1.0)
    split = [p.clone() for p in eager]
    es, ss = opt.init(eager), opt.init(split)
    for i in range(12):
        grads = _draw(gen, dtypes, 0.05 if i < 6 else 3.0)
        clipped, enorm = _eager_clip(grads, 1.0)
        _, es = opt.update(clipped, es, eager)
        scaled, snorm = clip(grads)
        assert isinstance(scaled, ScaledGrads)
        assert all(a is b for a, b in zip(scaled, grads, strict=True))
        _, ss = opt.update(scaled, ss, split)
        assert torch.equal(snorm, enorm), i
    assert float(scaled.scale) < 1.0              # the last steps clipped
    for a, b in zip(eager + es.mu + es.nu, split + ss.mu + ss.nu):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(es.count) == int(ss.count) == 12


@pytest.mark.parametrize("dtypes", sorted(DTYPE_SETS))
def test_split_step_equals_clip_then_update_bit_for_bit(dtypes):
    calls = K.plain_calls
    _split_against_eager(DTYPE_SETS[dtypes],
                         lambda grads: clip_scale(grads, 1.0))
    assert K.plain_calls == calls + 12 * 3        # norm, eager and split


@pytest.mark.parametrize("dtypes", sorted(DTYPE_SETS))
def test_split_step_on_a_one_rank_gloo_mesh_equals_clip_then_update(
        dtypes, tmp_path):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        placements = [(Replicate(), Shard(0)), (Replicate(), Replicate()),
                      (Shard(0), Replicate()), (Replicate(), Replicate()),
                      (Shard(0), Shard(0))]
        _split_against_eager(DTYPE_SETS[dtypes], lambda grads: (
            clip_scale_on_mesh(grads, placements, mesh, 1.0)))
    finally:
        dist.destroy_process_group()


def test_clip_by_global_norm_is_the_eager_clip():
    gen = torch.Generator().manual_seed(3)
    for scale in (0.01, 10.0):
        grads = _draw(gen, DTYPE_SETS["mixed"], scale)
        got, norm = clip_by_global_norm(grads, 1.0)
        want, wnorm = _eager_clip(grads, 1.0)
        assert torch.equal(norm, wnorm)
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# the operators without a card
# ---------------------------------------------------------------------------

def _meta(shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_fake_implementations_give_the_outputs_metadata_on_meta():
    grads = [_meta((5,), BF16), _meta((3, 4))]
    total = torch.ops.strela.global_sq_norm(grads, [True, False])
    assert (total.shape, total.dtype, total.device.type) == (
        torch.Size([]), F32, "meta")
    params = [_meta((5,), BF16), _meta((3, 4))]
    mu, nu = [_meta(p.shape) for p in params], [_meta(p.shape)
                                                 for p in params]
    s = _meta(())
    assert torch.ops.strela.adamw_(params, mu, nu, grads, s, s, s, None,
                                   0.9, 0.95, 1e-8, 0.1) is None
    assert [(p.shape, p.dtype) for p in params] == [
        (torch.Size([5]), BF16), (torch.Size([3, 4]), F32)]


def test_an_update_off_the_host_goes_through_the_operators():
    """``AdamW.update`` and ``clip_scale`` on ``meta`` tensors take the
    operators (their fake implementations here), not the plain loop."""
    params = [_meta((5,), BF16), _meta((3, 4))]
    opt = AdamW(lr=cosine_schedule(1e-3, 3, 10))
    state = opt.init(params)
    grads = [_meta((5,), BF16), _meta((3, 4))]
    calls = K.plain_calls
    scaled, norm = clip_scale(grads, 1.0)
    _, state = opt.update(scaled, state, params)
    assert K.plain_calls == calls
    assert norm.device.type == scaled.scale.device.type == "meta"
    assert state.count.device.type == "meta"


def _update_args():
    return dict(params=[_meta((8,), BF16)], mu=[_meta((8,))],
                nu=[_meta((8,))], grads=[_meta((8,), BF16)], lr=_meta(()),
                b1c=_meta(()), b2c=_meta(()), scale=None, b1=0.9, b2=0.95,
                eps=1e-8, weight_decay=0.1)


REFUSED = {
    "float16 parameter": dict(params=[_meta((8,), torch.float16)],
                              grads=[_meta((8,), torch.float16)]),
    "gradient dtype": dict(grads=[_meta((8,))]),
    "bf16 moment": dict(mu=[_meta((8,), BF16)]),
    "strided gradient": dict(grads=[_meta((16,), BF16)[::2]]),
    "float64 lr": dict(lr=_meta((), torch.float64)),
    "lr of one element": dict(lr=_meta((1,))),
    "shape": dict(nu=[_meta((9,))]),
    "one leaf short": dict(mu=[]),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_update_operator_refuses(case):
    args = {**_update_args(), **REFUSED[case]}
    with pytest.raises(ValueError):
        torch.ops.strela.adamw_(*args.values())


@pytest.mark.parametrize("grads,include", [
    ([_meta((8,), torch.float16)], [True]),
    ([_meta((16,))[::2]], [True]),
    ([_meta((8,))], [True, True])])
def test_norm_operator_refuses(grads, include):
    with pytest.raises(ValueError):
        torch.ops.strela.global_sq_norm(grads, include)


def test_op_costs_count_what_the_operators_move():
    """On a reduced minicpm-2b's bf16 leaves under ``FakeTensorMode``:
    the update counts 22 bytes a parameter (g, p, m and v read; p, m and
    v written) and its four 0-d inputs, the norm 2 bytes a parameter and
    its 0-d output; the eager loop and clipping count over 8 times as
    much."""
    cfg = get_arch("minicpm-2b").reduced()
    real = [p.detach() for p in build_model(cfg).init_params(
        torch.Generator().manual_seed(0)).parameters()]
    n = sum(p.numel() for p in real)
    assert {p.dtype for p in real} == {BF16}
    with FakeTensorMode() as mode:
        params = [mode.from_tensor(p) for p in real]
        grads = [torch.empty_like(p) for p in params]
        mu = [torch.zeros(p.shape) for p in params]
        nu = [torch.zeros(p.shape) for p in params]
        s = torch.ones(())
        with OpCosts() as norm:
            torch.ops.strela.global_sq_norm(grads, [True] * len(grads))
        with OpCosts() as update:
            torch.ops.strela.adamw_(params, mu, nu, grads, s, s, s, s, 0.9,
                                    0.95, 1e-8, 0.1)
        with OpCosts() as eager:
            clipped, _ = _eager_clip(grads, 1.0)
            K.update_plain(params, mu, nu, clipped, s, s, s, None, 0.9,
                           0.95, 1e-8, 0.1)
    assert norm.hbm_bytes() == 2 * n + 4
    assert update.hbm_bytes() == 22 * n + 4 * 4
    assert update.calls["strela::adamw_"] == 1
    assert eager.hbm_bytes() > 8 * (update.hbm_bytes() + norm.hbm_bytes())


def test_a_reduced_model_keeps_its_leaves_contiguous_and_dtype_paired():
    """What the update kernel refuses never reaches it from the trainer:
    every family's reduced model hands contiguous gradients of their
    parameters' dtypes."""
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.launch import train
    for arch in ("minicpm-2b", "granite-moe-3b-a800m", "zamba2-2.7b"):
        cfg = get_arch(arch).reduced()
        api = build_model(cfg)
        params = api.init_params(torch.Generator().manual_seed(0))
        leaves = list(params.parameters())
        batch = train.make_batch(cfg, TokenPipeline(DataCfg(cfg.vocab, 16, 2)),
                                 0, 2, torch.device("cpu"))
        grads = torch.autograd.grad(api.loss(params, batch)[0], leaves)
        assert all(g.is_contiguous() and g.dtype == p.dtype
                   for g, p in zip(grads, leaves)), arch


def test_every_entry_point_has_its_ctypes_signature():
    """ctypes passes an undeclared argument as a 32-bit int, which cuts a
    pointer: every ``extern "C"`` function of ``csrc/*.cu`` has its
    ``argtypes`` and ``restype`` set where ``_build.load`` binds them."""
    import re
    from pathlib import Path
    from repro_torch.kernels import _build
    src = "".join(p.read_text() for p in _build.sources())
    entries = set(re.findall(
        r"^(?:int|long long|const char\*)\s+(strela_\w+)\(", src, re.M))
    assert {"strela_adamw", "strela_sq_norm",
            "strela_sq_norm_partials"} <= entries
    bound = Path(_build.__file__).read_text()
    for e in sorted(entries):
        assert f"lib.{e}.argtypes" in bound and f"lib.{e}.restype" in bound, e
