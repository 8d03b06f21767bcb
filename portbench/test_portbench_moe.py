"""The MoE training cell: its pieces load, its tiny form trains as the
plain reference does, and the readers of the MoE layer's spans read
known values from events made up for the test, and nothing where the
spans are absent."""
import types

import pytest
import torch

from portbench import harness
from portbench.drivers import train as T
from portbench.spec import model_spec
from portbench.test_portbench_trace import ev
from portbench.tiny import tiny_cell
from portbench.trace import STRETCH, from_events

CELL = "granite-3.0-3b-a800m.train-2x2048"
READERS = ("moe_route_ms", "moe_combine_ms", "moe_experts_roofline")
STEPS = 2
UNITS = [{"batch": 2, "seq": 2048}] * STEPS


def test_the_cell_loads_with_its_pieces():
    cell = harness.load_cell(CELL)
    spec = model_spec(cell.conf)
    assert cell.mix == dict(cell.mix, kind="train", batch=2, seq=2048)
    assert spec.tie_embeddings and spec.moe.top_k == 8
    # a capacity of E / k slots a token: no pair can be dropped
    assert spec.moe.capacity_factor * spec.moe.top_k \
        == spec.moe.n_experts
    names = {m["name"] for m in cell.per_layer()}
    assert set(READERS) <= names
    assert {"mfu.train", "device_idle.train",
            "flash_bwd_roofline.train"} <= names
    assert "train_tokens_per_s" in {m["name"] for m in cell.end_to_end()}


def test_three_training_steps_equal_the_reference():
    cell = tiny_cell(CELL, dtype="float32")
    spec = model_spec(cell.conf)
    assert spec.moe.n_experts == 4 and spec.tie_embeddings
    prog = T.Program(cell, 13, torch.device("cpu"))
    got = T.checked_steps(prog)
    want = T.reference(cell, 13, torch.device("cpu"))
    assert got["losses"] == pytest.approx(want["losses"], rel=1e-5)
    assert set(got["grad_norms"]) == set(want["grad_norms"])
    assert any(".moe.router" in n for n in want["grad_norms"])
    for n, g in want["grad_norms"].items():
        assert got["grad_norms"][n] == pytest.approx(g, rel=1e-4, abs=1e-7)
    for n, c in want["change_norms"].items():
        assert got["change_norms"][n] == pytest.approx(c, rel=1e-4,
                                                       abs=1e-7)
    assert max(want["change_norms"].values()) > 0


def events(mode="order", spans=True):
    """Two steps of 1000 us. In each the forward's host span 100-400
    holds ``moe.route`` 110-180, ``moe.experts`` 180-250 and
    ``moe.combine`` 250-300, each launching one kernel (on the device at
    150-200, 200-300 and 300-340), and launches one more kernel after
    them (340-450). ``mode``: ``"ranges"`` gives the three spans ranges
    of their own on the device; ``"order"`` gives the device the
    forward's range alone, so launch order tells the spans apart."""
    out = [ev(STRETCH, 0, 1000 * STEPS, user=True)]
    for k in range(STEPS):
        b = 1000 * k
        if spans:
            out.append(ev("train.forward", b + 100, b + 400, user=True))
            out += [ev(n, b + s, b + t, user=mode == "ranges")
                    for n, s, t in (("moe.route", 110, 180),
                                    ("moe.experts", 180, 250),
                                    ("moe.combine", 250, 300))]
        for i, ((hs, he), kernel, (ds, de)) in enumerate((
                ((120, 130), "void sort_kernel<1>(int)", (150, 200)),
                ((190, 200), "void grouped_gemm<2>(float*)", (200, 300)),
                ((260, 270), "void gather_kernel<3>(float*)", (300, 340)),
                ((310, 320), "void flash_kernel<64>(float*)", (340, 450)))):
            cid = 100 * (i + 1) + k
            out += [ev("aten::op", b + hs, b + he, id=cid),
                    ev("cudaLaunchKernel", b + hs + 2, b + hs + 5),
                    ev(kernel, b + ds, b + de, device=True)]
        if spans and mode == "order":
            out.append(ev("train.forward", b + 150, b + 450, device=True,
                          user=True))
        if spans and mode == "ranges":
            out += [ev(n, b + s, b + t, device=True, user=True)
                    for n, s, t in (("moe.route", 150, 200),
                                    ("moe.experts", 200, 300),
                                    ("moe.combine", 300, 340))]
    return out


def ctx_of(evs, conf="granite-3.0-3b-a800m"):
    spec = model_spec(harness.load_json(
        harness.HERE / "configs" / f"{conf}.json"))
    return types.SimpleNamespace(
        trace=from_events(evs, UNITS), spec=spec, mix={"kind": "train"},
        window={"seconds": 1.0, "units": UNITS})


def read(name, ctx):
    return harness.reader(name).read(ctx)


@pytest.mark.parametrize("mode", ["ranges", "order"])
def test_the_readers_read_each_stage(mode):
    ctx = ctx_of(events(mode))
    assert read("moe_route_ms", ctx) == pytest.approx(0.050)
    assert read("moe_combine_ms", ctx) == pytest.approx(0.040)
    roof = harness.reader("moe_experts_roofline")
    bound_ms = 32 * roof.layer_bound_s(ctx.spec, 4096) * 1e3
    assert read("moe_experts_roofline", ctx) \
        == pytest.approx(100 * bound_ms / 0.100)


def test_the_experts_bound_counts_routed_pairs():
    roof = harness.reader("moe_experts_roofline")
    s = ctx_of(events()).spec
    # gate, up and down over 4,096 tokens x 8 pairs at 1536 x 512
    assert roof.layer_flops(s, 4096) == 3 * 2 * 4096 * 8 * 1536 * 512
    assert roof.layer_bytes(s, 4096) == 692060160
    # bytes, not FLOPs, bound the products at these widths
    assert roof.layer_bound_s(s, 4096) == pytest.approx(692060160 / 3.35e12)


def test_the_experts_roofline_is_the_same_at_any_capacity():
    dropless = ctx_of(events())
    capped = ctx_of(events(), conf="granite-moe-3b-a800m")
    assert capped.spec.moe.capacity_factor == 1.25
    assert dropless.spec.moe.capacity_factor == 5.0
    assert read("moe_experts_roofline", capped) \
        == read("moe_experts_roofline", dropless)


@pytest.mark.parametrize("name", READERS)
def test_nothing_where_the_spans_are_absent(name):
    # the parent commit opens no MoE span; a profile may also hold none
    assert read(name, ctx_of(events(spans=False))) is None
    assert read(name, types.SimpleNamespace(
        trace=None, spec=None, mix={}, window={})) is None
