"""``repro_torch.obs.ranges``: the training step's spans on the
profiler's clock. Off, a span is the shared no-op and enters no
``record_function``; under ``torch.profiler`` one reduced-minicpm step
through ``launch.train.make_step`` gives each of the five spans once,
the three phases as user annotations and clipping and AdamW as host
ranges inside ``train.optimizer`` (so that the phase keeps its range on
the device whole), on the one-card path and on a one-rank mesh; with
``obs`` on the ring holds the same spans; and the step's numbers do not
depend on whether anything records."""
import dataclasses

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs.base import get_arch
from repro_torch.data.pipeline import DataCfg, TokenPipeline
from repro_torch.launch import train
from repro_torch.models.api import build_model
from repro_torch.obs import ranges
from repro_torch.optim.adamw import AdamW

SPANS = ("train.forward", "train.backward", "train.optimizer",
         "optim.clip", "optim.adamw")
B, S = 2, 16


@pytest.fixture(autouse=True)
def _obs_off_after():
    """Every test leaves the process in the disabled default."""
    obs.disable()
    yield
    obs.disable()


def _trainer(mesh=None):
    """A reduced minicpm-2b (float32), its AdamW state, the trainer's step
    and a batch, the same from every call."""
    cfg = dataclasses.replace(get_arch("minicpm-2b").reduced(),
                              dtype="float32")
    api = build_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(0))
    if mesh is not None:
        from repro_torch.runtime import partition
        partition.place_model(params, cfg, mesh)
    opt = AdamW(lr=train.schedule("wsd", 3e-4, 10))
    state = opt.init(list(params.parameters()))
    batch = {k: torch.from_numpy(v) for k, v in
             TokenPipeline(DataCfg(cfg.vocab, S, B, seed=0)).batch(0).items()}
    return params, state, train.make_step(api, opt, False, mesh), batch


def _run_step(mesh=None):
    params, state, step, batch = _trainer(mesh)
    return step(params, state, None, batch)


def test_off_a_span_is_the_shared_no_op_and_enters_nothing(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not autograd_profiler._is_profiler_enabled and not obs.enabled()
    assert ranges.span("train.forward") is obs.NULL_SPAN
    _run_step()
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with ranges.span("train.forward"):
            pass
    assert entered == ["train.forward"]


def test_the_profiler_sets_the_flag_the_spans_test():
    """A torch that drops or renames the flag, or the host-only range,
    fails here, rather than losing every span in silence."""
    assert callable(torch._C._profiler._RecordFunctionFast)
    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False


def _annotations(p):
    """The five spans among the host events: name, start, end and whether
    the profile holds it as a user annotation."""
    return [(e.name, e.time_range.start, e.time_range.end,
             e.is_user_annotation) for e in p.events()
            if e.name in SPANS and e.device_type.name == "CPU"]


def _assert_nested(found):
    assert sorted(n for n, *_ in found) == sorted(SPANS)
    spans = {n: (s, t) for n, s, t, _ in found}
    assert {n for n, *_, user in found if user} == set(SPANS[:3])
    a, b = spans["train.optimizer"]
    for inner in ("optim.clip", "optim.adamw"):
        s, t = spans[inner]
        assert a <= s <= t <= b, (inner, spans)
    assert spans["optim.clip"][1] <= spans["optim.adamw"][0]
    assert spans["train.forward"][1] <= spans["train.backward"][0] \
        <= spans["train.backward"][1] <= a


@pytest.mark.parametrize("with_obs", [False, True])
def test_one_step_under_the_profiler_gives_each_span_once(with_obs):
    if with_obs:
        obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        _run_step()
    _assert_nested(_annotations(p))
    assert sorted(s.name for s in obs.spans()) == (
        sorted(SPANS) if with_obs else [])


def test_on_a_one_rank_mesh_the_optimizer_spans_nest_too(tmp_path):
    from torch.distributed.device_mesh import init_device_mesh
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        with profile(activities=[ProfilerActivity.CPU]) as p:
            _run_step(mesh)
    finally:
        dist.destroy_process_group()
    _assert_nested(_annotations(p))


def test_obs_ring_holds_the_five_spans_with_their_nesting():
    obs.enable()
    _run_step()
    got = {s.name: s for s in obs.spans()}
    assert sorted(got) == sorted(SPANS) and len(obs.spans()) == 5
    opt = got["train.optimizer"]
    assert got["optim.clip"].parent == got["optim.adamw"].parent == opt.sid
    assert {got[n].depth for n in SPANS[:3]} == {0}


def _leaves(out):
    params, state, _, metrics = out
    return ([metrics["loss"], metrics["gnorm"]]
            + [p.detach() for p in params.parameters()]
            + list(state.mu) + list(state.nu) + [state.count])


def test_the_step_is_bit_equal_whether_or_not_anything_records():
    plain = _leaves(_run_step())
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = _leaves(_run_step())
    obs.enable()
    ringed = _leaves(_run_step())
    assert len(plain) == len(profiled) == len(ringed) > 3
    for a, b, c in zip(plain, profiled, ringed):
        assert torch.equal(a, b) and torch.equal(a, c)
