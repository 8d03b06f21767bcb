"""The MoE layer's spans and counters (``repro_torch.models.moe``): under
``torch.profiler`` one training step of the reduced granite-moe-3b-a800m
through ``launch.train.make_step`` opens ``moe.route``, ``moe.experts``
and ``moe.combine`` once a layer, in that order, as host ranges inside
``train.forward`` (so that the phase keeps its range on the device
whole), on the capacity path and on the dropless one; with ``obs``
recording, a call counts its routed pairs, the pairs it dropped and the
busiest expert's load; with ``obs`` off nothing is counted and no count
is taken."""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs.base import get_arch
from repro_torch.data.pipeline import DataCfg, TokenPipeline
from repro_torch.launch import train
from repro_torch.models import moe as M
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import AdamW

MOE_SPANS = ("moe.route", "moe.experts", "moe.combine")
B, S = 2, 16
FACTORS = {"capacity": 1.25, "dropless": 5.0}


@pytest.fixture(autouse=True)
def _obs_off_after():
    """Every test leaves the process in the disabled default."""
    obs.disable()
    yield
    obs.disable()


def _cfg(path):
    cfg = get_arch("granite-moe-3b-a800m").reduced()
    moe = dataclasses.replace(cfg.moe, capacity_factor=FACTORS[path])
    return dataclasses.replace(cfg, dtype="float32", moe=moe)


def _run_step(path):
    """One step of the reduced granite (2 layers, 4 experts top-2)."""
    cfg = _cfg(path)
    assert M.dropless(cfg.moe, B * S) == (path == "dropless")
    api = build_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(0))
    opt = AdamW(lr=train.schedule("wsd", 3e-4, 10))
    state = opt.init(list(params.parameters()))
    batch = {k: torch.from_numpy(v) for k, v in
             TokenPipeline(DataCfg(cfg.vocab, S, B, seed=0)).batch(0).items()}
    return cfg, train.make_step(api, opt, False)(params, state, None, batch)


@pytest.mark.parametrize("path", sorted(FACTORS))
def test_one_step_opens_each_moe_span_once_a_layer_inside_the_forward(path):
    with profile(activities=[ProfilerActivity.CPU]) as p:
        cfg, _ = _run_step(path)
    host = [e for e in p.events() if e.device_type.name == "CPU"]
    forward = [(e.time_range.start, e.time_range.end) for e in host
               if e.name == "train.forward"]
    found = sorted((e.time_range.start, e.time_range.end, e.name,
                    e.is_user_annotation) for e in host
                   if e.name in MOE_SPANS)
    assert len(forward) == 1 and cfg.n_layers == 2
    assert [n for _, _, n, _ in found] == list(MOE_SPANS) * cfg.n_layers
    a, b = forward[0]
    for s, t, _, user in found:
        assert a <= s <= t <= b and not user
    ends = [t for _, t, _, _ in found]
    starts = [s for s, _, _, _ in found]
    assert all(e <= s for e, s in zip(ends, starts[1:]))


def _layer(path):
    cfg = _cfg(path)
    p = M.moe_init(torch.Generator().manual_seed(0), cfg.d_model, cfg.d_ff,
                   cfg.moe, torch.float32)
    # 32 equal tokens: both of their experts get all 32 pairs
    x = torch.randn(1, 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    return cfg, p, x.expand(1, 32, cfg.d_model).contiguous()


def _counts(reg=None):
    reg = reg or obs.registry()
    return [reg.get(n).value for n in ("moe.routed_pairs",
                                       "moe.dropped_pairs",
                                       "moe.expert_load_max_over_mean")]


@pytest.mark.parametrize("path", sorted(FACTORS))
def test_obs_counts_routed_and_dropped_pairs_and_the_busiest_load(path):
    """At capacity factor 1.25, C = int(1.25 x 32 x 2 / 4) = 20 of each
    expert's 32 pairs are kept, so 24 of the 64 are dropped; the dropless
    path drops none. Two experts share the 64 pairs of four experts' 16
    each: a load of twice the mean."""
    cfg, p, x = _layer(path)
    _, keep = M.dispatch_slots(M.route(p, cfg.moe, x)[2], 4,
                               M.capacity(cfg.moe, 32))
    dropped = int((~keep).sum())
    assert dropped == (24 if path == "capacity" else 0)
    obs.enable()
    M.moe_apply(p, cfg.moe, cfg.d_ff, x)
    assert _counts() == [64, dropped, 2.0]
    M.moe_apply(p, cfg.moe, cfg.d_ff, x)
    assert _counts() == [128, 2 * dropped, 2.0]


@pytest.mark.parametrize("path", sorted(FACTORS))
def test_with_obs_off_nothing_is_counted(path, monkeypatch):
    cfg, p, x = _layer(path)
    taken = []
    real = M._count
    monkeypatch.setattr(M, "_count", lambda *a: taken.append(1) or real(*a))
    obs.enable()
    M.moe_apply(p, cfg.moe, cfg.d_ff, x)
    reg = obs.registry()
    before = _counts(reg)
    obs.disable()
    M.moe_apply(p, cfg.moe, cfg.d_ff, x)
    assert _counts(reg) == before and taken == [1]


@pytest.mark.parametrize("path", sorted(FACTORS))
def test_a_step_counts_every_layer_s_routed_pairs(path):
    obs.enable()
    cfg, _ = _run_step(path)
    routed, dropped, load = _counts()
    assert routed == cfg.n_layers * B * S * cfg.moe.top_k
    assert load >= 1.0
    if path == "dropless":
        assert dropped == 0
