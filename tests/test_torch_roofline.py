"""``repro_torch.roofline`` against ``repro.roofline`` and against what is
known of each program: ``op_costs.OpCosts`` on the cases of
``tests/test_roofline.py`` (a matmul's FLOPs exactly, a Python loop of 8
and nested loops of 3 x 5 counted 8 and 15 times, bytes between one read
and 20x), ``analysis`` equal to the reference's arithmetic with the
reference's constants patched to the H100's at test time only,
collectives counted by input bytes on torch's fake process group, the
live-bytes tracker on sequences with a known peak, and the flash kernel's
registered operators (``strela::flash_fwd``/``flash_bwd``/``flash_attn``):
FLOPs equal to ``torch.utils.flop_counter``'s count of SDPA's fused
kernels on the same shapes, fake implementations that give shapes only,
and the plain version for CPU tensors."""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils.flop_counter import FlopCounterMode

from repro.roofline import analysis as REF
from repro_torch.kernels import flash_attention as fa
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.op_costs import COLLECTIVES, OpCosts


def _costs_of(fn, *args):
    with OpCosts() as c:
        fn(*args)
    return c


# ---------------------------------------------------------------------------
# the cases of tests/test_roofline.py
# ---------------------------------------------------------------------------

def test_counts_matmul_flops():
    a, b = torch.zeros(128, 256), torch.zeros(256, 64)
    assert _costs_of(lambda: a @ b).flops() == 2 * 128 * 256 * 64


def test_a_loop_of_8_counts_8_times():
    w, x = torch.zeros(8, 64, 64), torch.zeros(4, 64)

    def fn():
        c = x
        for i in range(8):
            c = c @ w[i]
        return c
    assert _costs_of(fn).flops() == 8 * 2 * 4 * 64 * 64


def test_nested_loops_multiply():
    w, x = torch.zeros(3, 5, 32, 32), torch.zeros(2, 32)

    def fn():
        c = x
        for i in range(3):
            for j in range(5):
                c = c @ w[i, j]
        return c
    assert _costs_of(fn).flops() == 15 * 2 * 2 * 32 * 32


def test_bytes_nonzero_and_plausible():
    a = torch.zeros(1024, 1024)
    nbytes = _costs_of(lambda: (a * 2 + 1).sum()).hbm_bytes()
    assert a.numel() * 4 <= nbytes < a.numel() * 4 * 20


def test_views_count_no_bytes():
    a = torch.zeros(64, 64)
    c = _costs_of(lambda: a.reshape(-1).view(64, 64).t()[1:].detach()
                  .unsqueeze(0).expand(3, 63, 64))
    assert c.hbm_bytes() == 0 and c.flops() == 0
    # a reshape that has to copy moves the data
    c = _costs_of(lambda: a.t().reshape(-1))
    assert c.hbm_bytes() == 2 * a.numel() * 4


def test_roofline_terms_and_bottleneck():
    rl = RA.roofline_from_costs(flops=989e12, hbm_bytes=3.35e12,
                                collective_bytes=0, chips=1)
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(1.0)
    assert rl.bottleneck in ("compute", "memory")
    rl2 = RA.roofline_from_costs(1e12, 1e9, 1e12, chips=256)
    assert rl2.bottleneck == "collective"


def test_the_h100_peaks():
    """NVIDIA's data-sheet numbers for the H100 SXM: bf16 dense, HBM3,
    NVLink 4 each way."""
    assert (RA.PEAK_FLOPS, RA.HBM_BW, RA.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)


@pytest.mark.parametrize("case", [
    (989e12, 3.35e12, 0.0, 1, None),
    (1e12, 1e9, 1e12, 256, 5e11),
    (5.3e16, 9.2e14, 1.3e13, 256, 1.7e16),
    (0.0, 0.0, 0.0, 512, 1.0),
    (3e15, 2e13, 4e12, 512, 2.5e15)])
def test_analysis_equals_the_reference_arithmetic(monkeypatch, case):
    """The same inputs, the reference's three constants patched to the
    port's: every field, the step time and both fractions equal."""
    monkeypatch.setattr(REF, "PEAK_FLOPS", RA.PEAK_FLOPS)
    monkeypatch.setattr(REF, "HBM_BW", RA.HBM_BW)
    monkeypatch.setattr(REF, "ICI_BW", RA.LINK_BW)
    got, want = RA.roofline_from_costs(*case), REF.roofline_from_costs(*case)
    for field in ("flops", "hbm_bytes", "collective_bytes", "chips",
                  "compute_s", "memory_s", "collective_s", "bottleneck",
                  "model_flops", "step_time_s"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.useful_fraction() == want.useful_fraction()
    assert got.roofline_fraction() == want.roofline_fraction()
    for n, t in [(2.7e9, 2048.0), (1.3e9, 1.0), (17e9, 1048576.0)]:
        assert RA.model_flops_train(n, t) == REF.model_flops_train(n, t)
        assert RA.model_flops_decode(n, t) == REF.model_flops_decode(n, t)


# ---------------------------------------------------------------------------
# collectives, on torch's fake process group
# ---------------------------------------------------------------------------

@pytest.fixture
def four_ranks():
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield
    dist.destroy_process_group()


def test_collectives_count_their_input_bytes(four_ranks):
    x = torch.ones(1024)
    c = _costs_of(dist.all_reduce, x)
    assert c.collective_bytes() == {**{k: 0.0 for k in COLLECTIVES},
                                    "all-reduce": 4096.0}
    c = _costs_of(dist.all_gather_into_tensor, torch.empty(4096), x)
    assert c.collective_bytes()["all-gather"] == 4096.0
    assert sum(c.collective_bytes().values()) == 4096.0
    c = _costs_of(dist.reduce_scatter_tensor, torch.empty(256), x)
    assert c.collective_bytes()["reduce-scatter"] == 4096.0
    c = _costs_of(dist.all_to_all_single, torch.empty(1024), x)
    assert c.collective_bytes()["all-to-all"] == 4096.0
    assert c.top_collectives(1)[0][:2] == (4096.0, "all-to-all")


def test_the_pipeline_shift_counts_as_collective_permute(four_ranks):
    """Stage 0 of 4 sends its activation forward (a ``send``) and gets
    the gradient back; the ``recv`` ends count nothing."""
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.runtime.pipeline import _Shift
    mesh = compat_make_mesh((4,), ("pod",), "cpu")
    h = torch.ones(8, 16, requires_grad=True)
    with OpCosts() as c:
        out = _Shift.apply(h, mesh.get_group("pod"), 0, 4, 7)
        out.sum().backward()
    got = c.collective_bytes()
    assert got["collective-permute"] == 8 * 16 * 4
    assert sum(got.values()) == got["collective-permute"]


def test_a_dtensor_op_counts_the_local_work(four_ranks):
    """A DTensor matmul counts rank 0's shard of it, not the global
    product DTensor runs on fake tensors to find the output's shape; its
    redistribution counts the gather."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import compat_make_mesh
    mesh = compat_make_mesh((2, 2), ("data", "model"), "cpu")
    with FakeTensorMode():
        a = DTensor.from_local(torch.empty(8, 16), mesh,
                               [Shard(0), Replicate()], run_check=False)
        b = DTensor.from_local(torch.empty(16, 32), mesh,
                               [Replicate(), Replicate()], run_check=False)
        with OpCosts() as c:
            (a @ b).redistribute(mesh, [Replicate(), Replicate()])
    assert c.flops() == 2 * 8 * 16 * 32
    assert c.collective_bytes()["all-gather"] == 8 * 32 * 4


# ---------------------------------------------------------------------------
# live bytes
# ---------------------------------------------------------------------------

def test_live_bytes_follow_allocations_and_frees():
    with OpCosts() as c:
        a = torch.empty(1000)                  # 4000 live
        b = torch.empty(500)                   # 6000
        del a                                  # 2000
        d = torch.empty(2000)                  # 10000: the peak
        e = d.view(50, 40)                     # a view: nothing new
    assert (c.peak_live_bytes, c.live_bytes) == (10000, 10000)
    del b, d, e
    assert c.live_bytes == 0


def test_saved_for_backward_stays_live_until_the_backward():
    """tanh saves its output for the backward: it stays live after the
    forward drops it, until the gradient frees the graph; the product
    before it goes as soon as tanh has read it. The arguments count
    apart."""
    w = torch.zeros(64, 64, requires_grad=True)
    x = torch.zeros(32, 64)
    act = 32 * 64 * 4
    with OpCosts(arguments=[w, x]) as c:
        h = torch.tanh(x @ w)
        loss = h.sum()
        assert c.live_bytes == act + 4          # tanh's output, the loss
        assert c.peak_live_bytes == 2 * act     # x @ w beside tanh's
        del h
        assert c.live_bytes == act + 4          # saved for the backward
        g, = torch.autograd.grad(loss, [w])
        del loss
    assert c.argument_bytes == (64 * 64 + 32 * 64) * 4
    assert c.live_bytes == g.numel() * 4
    assert c.peak_bytes == c.argument_bytes + c.peak_live_bytes


# ---------------------------------------------------------------------------
# the flash kernel's registered operators
# ---------------------------------------------------------------------------

def _sdpa_flops(b, h, sq, sk, d):
    """FlopCounterMode's count of SDPA's fused forward and backward
    (``_scaled_dot_product_efficient_attention`` and its backward: the
    CPU's SDPA kernel has no formula) on fake CUDA tensors."""
    with FakeTensorMode():
        q = torch.empty(b, h, sq, d, device="cuda")
        k, v = (torch.empty(b, h, sk, d, device="cuda") for _ in range(2))
        with FlopCounterMode(display=False) as m:
            o, lse, s, off = \
                torch.ops.aten._scaled_dot_product_efficient_attention(
                    q, k, v, None, True)
            torch.ops.aten._scaled_dot_product_efficient_attention_backward(
                o, q, k, v, None, o, lse, s, off, 0.0,
                [True, True, True, False])
    return m.get_total_flops()


@pytest.mark.parametrize("shape", [(2, 4, 64, 64, 16), (1, 3, 17, 49, 64),
                                   (3, 2, 128, 96, 80)])
def test_flash_flops_equal_sdpa_forward_and_backward(shape):
    b, h, sq, sk, d = shape
    with FakeTensorMode():
        q = torch.empty(b * h, sq, d, device="cuda")
        k, v = (torch.empty(b * h, sk, d, device="cuda") for _ in range(2))
        with FlopCounterMode(display=False) as m:
            o, lse = torch.ops.strela.flash_fwd(q, k, v, False)
            torch.ops.strela.flash_bwd(q, k, v, o, lse, o, False)
        with OpCosts() as c:
            torch.ops.strela.flash_attn(q, k, v, False)
    assert m.get_total_flops() == _sdpa_flops(b, h, sq, sk, d)
    assert c.flops() == 4 * b * h * sq * sk * d


def test_fake_implementations_give_shapes_and_dtypes():
    with FakeTensorMode():
        for dt in (torch.float32, torch.bfloat16):
            q = torch.empty(6, 32, 64, dtype=dt, device="cuda")
            k = torch.empty(6, 48, 64, dtype=dt, device="cuda")
            o, lse = torch.ops.strela.flash_fwd(q, k, k, True)
            assert (o.shape, o.dtype, o.device.type) == (q.shape, dt, "cuda")
            assert (lse.shape, lse.dtype) == ((6, 32), torch.float32)
            dq, dk, dv = torch.ops.strela.flash_bwd(q, k, k, o, lse, o, True)
            assert [(t.shape, t.dtype) for t in (dq, dk, dv)] == [
                (q.shape, dt), (k.shape, dt), (k.shape, dt)]
            out = torch.ops.strela.flash_attn(q, k, k, True)
            assert (out.shape, out.dtype) == (q.shape, dt)
        # the checks of the kernel's wrapper hold for fake tensors too
        q = torch.empty(2, 9, 16, device="cuda")
        k = torch.empty(2, 4, 16, device="cuda")
        with pytest.raises(ValueError, match="causal attention with sq=9"):
            torch.ops.strela.flash_fwd(q, k, k, True)


def test_a_fake_tensor_never_reaches_the_kernel(monkeypatch):
    """Under FakeTensorMode the operators run their fake implementations:
    no pointer is read, no library loaded, no launch or plain call
    counted."""
    def refuse(*args, **kwargs):
        raise AssertionError("a fake tensor reached the kernel's wrapper")
    monkeypatch.setattr(fa._build, "load", refuse)
    monkeypatch.setattr(fa, "_check_kernel_inputs", refuse)
    monkeypatch.setattr(torch.Tensor, "data_ptr", refuse)
    before = (fa.launches, fa.plain_calls, fa.backward_plain_calls,
              fa.bwd_dq_launches)
    with FakeTensorMode():
        q = torch.empty(4, 16, 16, device="cuda")
        o, lse = torch.ops.strela.flash_fwd(q, q, q, True)
        torch.ops.strela.flash_bwd(q, q, q, o, lse, o, True)
        torch.ops.strela.flash_attn(q, q, q, True)
        fa.flash_attention(q, q, q)
    assert (fa.launches, fa.plain_calls, fa.backward_plain_calls,
            fa.bwd_dq_launches) == before


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 8, 16))
                                .astype(np.float32)) for _ in range(3))
    before = (fa.plain_calls, fa.backward_plain_calls, fa.launches)
    o, lse = torch.ops.strela.flash_fwd(q, k, v, True)
    dq, dk, dv = torch.ops.strela.flash_bwd(q, k, v, o, lse, o, True)
    got = torch.ops.strela.flash_attn(q, k, v, True)
    assert (fa.plain_calls, fa.backward_plain_calls, fa.launches) == (
        before[0] + 2, before[1] + 1, before[2])
    want_o, want_lse = fa.ref.flash_attention_lse(q, k, v, True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert torch.equal(got, want_o)
    for g, w in zip((dq, dk, dv), fa.ref.flash_attention_backward(
            q, k, v, o, lse, o, True)):
        assert torch.equal(g, w)


def test_the_function_runs_through_the_operators():
    """A training attention on CPU tensors is one strela::flash_fwd and
    one strela::flash_bwd, counted with the formulas."""
    q, k, v = (torch.randn(4, 32, 16, requires_grad=True) for _ in range(3))
    with OpCosts() as c:
        out = fa.flash_attention(q, k, v)
        torch.autograd.grad(out.sum(), (q, k, v))
    assert c.calls["strela::flash_fwd"] == c.calls["strela::flash_bwd"] == 1
    assert c.calls["strela::flash_attn"] == 0
    assert c.flops() == 14 * 4 * 32 * 32 * 16


def test_meta_tensors_hold_no_memory():
    """A meta tensor (a shape with no storage anywhere, as code may make
    to read a stride) adds no bytes and no live bytes, even under
    ``FakeTensorMode``, where it is a fake tensor on the meta device."""
    with FakeTensorMode():
        with OpCosts() as c:
            t = torch.empty(1 << 40, device="meta")
            t.stride()
            torch.empty(4, 8)
    assert (c.hbm_bytes(), c.peak_live_bytes) == (0.0, 4 * 8 * 4)
