"""The statistics and the trace reading, on values and events made up
for the test: p95 over every request, the idle share, device time by
range and by kernel, launches, and the breakdown."""
import math
import types

import pytest
from torch.autograd import DeviceType

from portbench import harness
from portbench.trace import STRETCH, Trace, from_events, kernel_name



def test_p95_is_taken_over_every_request():
    assert harness.p95(list(range(1, 101))) == 95
    # 19 batches of 8 requests at 1 ms and one of 8 at 9 ms: 8 of 160
    # requests (5%) lie at 9 ms, so the 95th percentile is 1 ms; with two
    # slow batches of 20 it is 9 ms
    assert harness.p95([1.0] * 152 + [9.0] * 8) == 1.0
    assert harness.p95([1.0] * 144 + [9.0] * 16) == 9.0
    assert harness.p95([3.0]) == 3.0
    with pytest.raises(ValueError):
        harness.p95([])


def ev(name, start, end, device=False, user=False, id=0, link=0):
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=start, end=end),
        is_user_annotation=user, id=id, linked_correlation_id=link)


def events(annotate=True):
    """A stretch of 1000 us: two steps; in each the optimizer's host range
    launches one kernel; the device is busy 600 us in all."""
    out = [ev(STRETCH, 0, 1000, user=True)]
    for k, base in enumerate((0, 500)):
        out += [ev("train.forward", base + 10, base + 100, user=True),
                ev("aten::mm", base + 20, base + 40, id=10 + k),
                ev("cudaLaunchKernel", base + 25, base + 30, link=10 + k),
                ev("void gemm_kernel<1>(float*)", base + 50, base + 250,
                   device=True, link=10 + k),
                ev("train.optimizer", base + 100, base + 200, user=True),
                ev("aten::add_", base + 110, base + 150, id=20 + k),
                ev("cudaLaunchKernel", base + 115, base + 120, link=20 + k),
                ev("void elementwise_kernel<2>(int)", base + 250,
                   base + 350, device=True, link=20 + k)]
        if annotate:
            out.append(ev("train.optimizer", base + 250, base + 350,
                          device=True, user=True))
    out.append(ev("void stray_kernel()", 2000, 2100, device=True))
    return out


@pytest.mark.parametrize("annotate", [True, False])
def test_trace_reads_busy_idle_and_the_optimizer(annotate):
    tr = from_events(events(annotate), [{"batch": 1, "seq": 8}] * 2)
    assert tr.window_s == pytest.approx(1000e-6)
    assert tr.busy_s == pytest.approx(600e-6)      # 2 x (200 + 100)
    assert tr.launches() == 4
    assert tr.device_us_in("train.optimizer") == pytest.approx(200.0)
    assert tr.device_us(("gemm_kernel",)) == pytest.approx(400.0)
    # the window: 10 steps of 8 tokens in 4 ms; the stretch: 300 us busy a
    # step, so the device idles 1 - 300 / 400 of the window
    ctx = types.SimpleNamespace(trace=tr, spec=None, mix={}, window={
        "seconds": 4e-3, "units": [{"batch": 1, "seq": 8}] * 10})
    idle = harness.reader("device_idle.train").read(ctx)
    assert idle == pytest.approx(25.0)
    opt = harness.reader("optimizer_device_ms.train")
    assert opt.read(ctx) == pytest.approx(0.1)
    launches = harness.reader("launches_per_step.train")
    assert launches.read(ctx) == 2.0


def test_breakdown_names_ops_and_gaps():
    tr = from_events(events(), [{"batch": 1, "seq": 8}] * 2)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["gemm_kernel", pytest.approx(400e-6)]
    # idle 0-50 (the host in the launch at 25-30), 350-550 and 850-1000
    # (no host event of the stretch runs then)
    assert dict(b["idle_gaps"]) == {"cudaLaunchKernel": pytest.approx(50e-6),
                                    "(no host event)": pytest.approx(350e-6)}


def test_readers_give_nothing_without_a_trace():
    ctx = types.SimpleNamespace(trace=None, spec=None, mix={},
                                window={"seconds": 1.0, "units": []})
    for name in ("device_idle.prefill", "optimizer_device_ms.train",
                 "launches_per_step.train", "flash_bwd_roofline.train",
                 "flash_fwd_roofline.prefill"):
        assert harness.reader(name).read(ctx) is None
    empty = Trace([], [], [], 0.0, 1.0, [])
    ctx.trace = empty
    assert harness.reader("device_idle.train").read(
        ctx) is None
    assert empty.device_us_in("train.optimizer") is None


def test_kernel_names():
    assert kernel_name("void flash_kernel<float, 64>(float const*)") \
        == "flash_kernel"
    assert kernel_name("void at::native::(anonymous namespace)::"
                       "elementwise_kernel<128, 2>(int)") \
        == "elementwise_kernel"
    assert kernel_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
    assert kernel_name("sm90_xmma_gemm_bf16") == "sm90_xmma_gemm_bf16"


def test_roofline_reader_over_the_stretch():
    from portbench.spec import model_spec
    spec = model_spec(harness.load_json(harness.HERE / "configs"
                                        / "minicpm-2b.json"))
    mod = harness.reader("flash_fwd_roofline.prefill")
    units = [{"batch": 8, "seq": 512}, {"batch": 8, "seq": 4096}]
    bound = sum(40 * mod.layer_bound_s(8, 36, u["seq"], 64) for u in units)
    ops = [("void flash_kernel<float, 64>(float*)", 0.0, 4 * bound * 1e6,
            None)]
    tr = Trace(ops, [], [], 0.0, 1e7, units)
    ctx = types.SimpleNamespace(trace=tr, spec=spec, mix={}, window={})
    assert math.isclose(mod.read(ctx), 25.0)
