"""The readers of the training step's phases, on events made up for the
test: clipping's and AdamW's device time by the span on the device's
timeline and by the host ops the span launched, each phase's idle on a
stretch whose idle is known, nothing where the spans are absent, and a
reader for each of their entries in ``BENCHMARK.json``."""
import types

import pytest

from portbench import harness
from portbench.metrics import _phase
from portbench.trace import STRETCH, Trace, from_events
from portbench.test_portbench_trace import ev

PHASES = ("train.forward", "train.backward", "train.optimizer")
BASES = ("adamw_device_ms", "clip_device_ms", "forward_idle_ms",
         "backward_idle_ms", "optimizer_idle_ms")
STEPS = 2


def events(mode="order", spans=True, drop_call=False):
    """A stretch of two steps of 1000 us. In each: the forward's host span
    100-300 holds a kernel at 150-250 (idle 100); the backward's 300-600
    a kernel at 350-650 that runs on into the optimizer (idle 50); the
    optimizer's 600-900 holds clipping 600-700 with a kernel at 660-690
    and AdamW 700-900 with one at 720-850 (busy 50 + 30 + 130, idle 90);
    outside every span (0-100, 900-1000) a memset at 950-980 (idle 170).
    The device is busy 590 of each 1000 us: idle 410 = 100 + 50 + 90 +
    170.

    ``mode`` says how the profile shows the optimizer's two spans:
    ``"ranges"``, as user annotations with ranges of their own on the
    device; ``"links"``, as host ranges, with every operation linked to
    the host op that launched it; ``"order"``, as host ranges with no
    link, so that only the optimizer's range on the device and the order
    of launches tell them apart (as the profiler of torch 2.11 shows the
    port's nested spans). ``drop_call`` leaves one enqueue call out."""
    out = [ev(STRETCH, 0, 1000 * STEPS, user=True)]
    linked = mode != "order"
    for k in range(STEPS):
        b = 1000 * k
        if spans:
            out += [ev(n, b + s, b + t, user=True) for n, s, t in (
                ("train.forward", 100, 300), ("train.backward", 300, 600),
                ("train.optimizer", 600, 900))]
            out += [ev(n, b + s, b + t, user=mode == "ranges")
                    for n, s, t in (("optim.clip", 600, 700),
                                    ("optim.adamw", 700, 900))]
        for i, (op, (hs, he), call, kernel, (ds, de)) in enumerate((
                ("aten::mm", (110, 140), "cudaLaunchKernel",
                 "void gemm_kernel<1>(float*)", (150, 250)),
                ("aten::mm", (310, 340), "cuLaunchKernelEx",
                 "void flash_bwd_dkdv_kernel<64>(float*)", (350, 650)),
                ("aten::sum", (610, 630), "cudaLaunchKernel",
                 "void reduce_kernel<2>(int)", (660, 690)),
                ("aten::add_", (710, 730), "cudaLaunchKernel",
                 "void vectorized_elementwise_kernel<4>(int)", (720, 850)),
                ("aten::zero_", (910, 930), "cudaMemsetAsync",
                 "Memset (Device)", (950, 980)))):
            cid = 100 * (i + 1) + k
            out += [ev(op, b + hs, b + he, id=cid),
                    ev(kernel, b + ds, b + de, device=True,
                       link=cid if linked else 0)]
            if not (drop_call and k == 1 and op == "aten::add_"):
                out.append(ev(call, b + hs + 5, b + hs + 10,
                              link=cid if linked else 0))
        if spans and mode != "ranges":
            out.append(ev("train.optimizer", b + 660, b + 850,
                          device=True, user=True))
        if spans and mode == "ranges":
            out += [ev("optim.clip", b + 660, b + 690, device=True,
                       user=True),
                    ev("optim.adamw", b + 720, b + 850, device=True,
                       user=True)]
    out.append(ev("void stray_kernel()", 5000, 5100, device=True))
    return out


def ctx_of(tr):
    return types.SimpleNamespace(trace=tr, spec=None, mix={}, window={
        "seconds": 1.0, "units": [{"batch": 1, "seq": 8}] * 10})


def trace(**kw):
    return from_events(events(**kw), [{"batch": 1, "seq": 8}] * STEPS)


@pytest.mark.parametrize("mode", ["ranges", "links", "order"])
def test_adamw_and_clip_device_time(mode):
    tr = trace(mode=mode)
    names = {n for n, _, _ in tr.device_ranges}
    assert names == ({"optim.clip", "optim.adamw"} if mode == "ranges"
                     else {"train.optimizer"})
    ctx = ctx_of(tr)
    read = lambda name: harness.reader(name).read(ctx)  # noqa: E731
    assert read("adamw_device_ms.small_batch") == pytest.approx(0.130)
    assert read("clip_device_ms.train") == pytest.approx(0.030)
    if mode != "ranges":
        # the optimizer's range on the device holds clipping and AdamW
        assert read("optimizer_device_ms.train") == pytest.approx(0.160)


def test_launch_order_reads_nothing_when_the_counts_differ():
    tr = trace(mode="order", drop_call=True)
    assert _phase.in_launch_order_us(tr, "optim.adamw",
                                     "train.optimizer") is None
    assert harness.reader("adamw_device_ms.train").read(ctx_of(tr)) is None
    good = trace(mode="order")
    assert _phase.in_launch_order_us(good, "optim.adamw",
                                     "train.optimizer") == pytest.approx(260)


def test_each_phase_idle_and_the_rest_add_up_to_the_stretch():
    tr = trace()
    ctx = ctx_of(tr)
    idle = {b: harness.reader(f"{b}.train").read(ctx)
            for b in ("forward_idle_ms", "backward_idle_ms",
                      "optimizer_idle_ms")}
    assert idle == {"forward_idle_ms": pytest.approx(0.100),
                    "backward_idle_ms": pytest.approx(0.050),
                    "optimizer_idle_ms": pytest.approx(0.090)}
    inside = sorted(iv for n in PHASES
                    for iv in _phase.host_intervals(tr, n))
    outside, cursor = [], tr.start
    for s, t in inside:
        if s > cursor:
            outside.append((cursor, s))
        cursor = max(cursor, t)
    outside.append((cursor, tr.end))
    rest = _phase.idle_us(tr, outside) / 1e3 / STEPS
    assert rest == pytest.approx(0.170)
    stretch = (tr.window_s - tr.busy_s) * 1e3 / STEPS
    assert stretch == pytest.approx(0.410)
    assert sum(idle.values()) + rest == pytest.approx(stretch)


def test_host_intervals_merge_and_clip_to_the_stretch():
    tr = Trace([], [], [("train.forward", -50.0, 40.0),
                        ("train.forward", 30.0, 60.0),
                        ("train.forward", 90.0, 200.0),
                        ("train.backward", 0.0, 10.0)], 0.0, 100.0, [{}])
    assert _phase.host_intervals(tr, "train.forward") == [(0.0, 60.0),
                                                          (90.0, 100.0)]


def test_nothing_where_the_spans_are_absent():
    for tr in (trace(spans=False), trace(mode="links", spans=False), None):
        ctx = ctx_of(tr)
        for base in BASES:
            for variant in ("train", "small_batch"):
                assert harness.reader(f"{base}.{variant}").read(ctx) is None
    # the parent commit's trainer opens the three phases but neither
    # optimizer span
    parent = [e for e in events() if not e.name.startswith("optim.")]
    ctx = ctx_of(from_events(parent, [{"batch": 1, "seq": 8}] * STEPS))
    assert harness.reader("adamw_device_ms.train").read(ctx) is None
    assert harness.reader("clip_device_ms.train").read(ctx) is None
    assert harness.reader("forward_idle_ms.train").read(ctx) \
        == pytest.approx(0.100)


BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
VARIANTS = {"train": ("train_tokens_per_s", "minicpm-2b.train-4k"),
            "small_batch": ("train_tokens_per_s.small_batch",
                            "minicpm-2b.train-512")}


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_each_entry_resolves_to_its_reader(base, variant):
    name = f"{base}.{variant}"
    entry = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert len(entry) == 1
    moves, cell = VARIANTS[variant]
    assert entry[0]["moves"] == moves and entry[0]["workloads"] == [cell]
    assert entry[0]["unit"] == "ms/step" and entry[0]["better"] == "lower"
    mod = harness.reader(name)
    assert mod.__file__ == str(harness.HERE / "metrics" / f"{base}.py")
    assert callable(mod.read)
    assert name in {m["name"] for m in
                    harness.load_cell(cell, BENCH).per_layer()}
