"""The optimizer's kernels on the card (``kernels/adamw.py``,
``csrc/adamw.cu``): the update equals the plain loop on the same device
bit for bit, the norm is within 1e-5 of a float64 sum and repeats to the
bit, the wrapper refuses what the kernels do not take, and the trainer's
step, one card or a one-rank NCCL mesh, runs the kernels and no plain
version. Marked ``gpu``: each test asks its fixture for the card and
skips, with the reason, where there is none. This file imports neither
``jax`` nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_adamw.py
"""
import pytest
import torch

from repro_torch.kernels import adamw as K
from repro_torch.optim.adamw import AdamW, ScaledGrads, wsd_schedule

pytestmark = pytest.mark.gpu

BF16, F32 = torch.bfloat16, torch.float32
SIZES = (1, 7, 2304, 4097, 3_000_000)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; none is available here")
    return torch.device("cuda")


def _leaves(gen, device, scale=1.0):
    """bf16 and float32 leaves of every size in ``SIZES``, and one bf16
    leaf that starts 2 bytes past a 16-byte boundary (the kernel's
    element-wise path)."""
    out = []
    for dtype in (BF16, F32):
        for n in SIZES:
            out.append((torch.randn(n, generator=gen, device=device)
                        * scale).to(dtype))
    buf = (torch.randn(4098, generator=gen, device=device) * scale).to(BF16)
    out.append(buf[1:])
    return out


def _plain_step(opt, grads, state, params, scale):
    """:meth:`AdamW.update`'s count, corrections and rate, then the plain
    loop on the card."""
    count = state.count + 1
    b1c, b2c = opt.bias_corrections(count)
    K.update_plain(params, state.mu, state.nu, grads, opt.lr(count), b1c,
                   b2c, scale, opt.b1, opt.b2, opt.eps, opt.weight_decay)
    return state._replace(count=count)


@pytest.mark.parametrize("scale", [0.37, 1.0, None])
def test_update_kernel_equals_the_plain_loop_bit_for_bit(cuda, scale):
    """Twelve steps of the WSD schedule (warmup, flat and decay): every
    parameter, moment and the count equal the plain loop's bits."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    opt = AdamW(lr=wsd_schedule(1e-2, warmup=3, stable=4, decay=4))
    kern = _leaves(gen, cuda)
    plain = [p.clone() for p in kern]
    ks, ps = opt.init(kern), opt.init(plain)
    launches, calls = K.adamw_launches, K.plain_calls
    for _ in range(12):
        grads = _leaves(gen, cuda, 0.1)
        s = None if scale is None else torch.tensor(scale, device=cuda)
        _, ks = opt.update(grads if s is None else ScaledGrads(grads, s),
                           ks, kern)
        ps = _plain_step(opt, grads, ps, plain, s)
    torch.cuda.synchronize()
    assert K.adamw_launches == launches + 12
    assert K.plain_calls == calls + 12          # the plain side's only
    assert int(ks.count) == int(ps.count) == 12
    for a, b in zip(kern + ks.mu + ks.nu, plain + ps.mu + ps.nu):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_norm_kernel_is_near_a_float64_sum_and_repeats(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    grads = _leaves(gen, cuda)
    want = sum(float(g.double().pow(2).sum()) for g in grads)
    launches = K.sq_norm_launches
    totals = [K.global_sq_norm(grads) for _ in range(3)]
    torch.cuda.synchronize()
    assert K.sq_norm_launches == launches + 3 * 2   # one batch, one sum
    assert totals[0].dtype == F32 and totals[0].dim() == 0
    assert abs(float(totals[0]) - want) <= 1e-5 * want
    assert all(torch.equal(t, totals[0]) for t in totals)
    some = [i % 2 == 0 for i in range(len(grads))]
    part = sum(float(g.double().pow(2).sum())
               for g, inc in zip(grads, some) if inc)
    got = float(K.global_sq_norm(grads, some))
    assert abs(got - part) <= 1e-5 * part
    assert float(K.global_sq_norm(grads, [False] * len(grads))) == 0.0


def _leaves_a_launch():
    """Leaves one launch of the update and of the norm takes
    (``csrc/adamw.cu`` ``kAdamLeaves``, ``kNormLeaves``)."""
    import os
    import re
    path = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                        "adamw.cu")
    with open(path) as f:
        src = f.read()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src)
                     .group(1)) for name in ("kAdamLeaves", "kNormLeaves"))


def test_kernels_take_many_leaves_in_batches_of_a_launch(cuda):
    """More leaves than a launch of either kernel holds, as a model's
    (minicpm-2b has 362): the update in ceil(n / kAdamLeaves) launches,
    bit-equal to the plain loop in every leaf; the norm in
    ceil(n / kNormLeaves) launches and one that sums the partials, within
    1e-5 of a float64 sum."""
    adam_leaves, norm_leaves = _leaves_a_launch()
    n = 2 * norm_leaves + 3
    gen = torch.Generator(device=cuda).manual_seed(2)
    shapes = [(1 + 37 * i % 5000,) for i in range(n)]
    params = [(torch.randn(s, generator=gen, device=cuda) * 0.02).to(BF16)
              for s in shapes]
    grads = [(torch.randn(s, generator=gen, device=cuda) * 1e-3).to(BF16)
             for s in shapes]
    mu = [torch.randn(s, generator=gen, device=cuda) * 1e-4 for s in shapes]
    nu = [torch.rand(s, generator=gen, device=cuda) * 1e-8 for s in shapes]
    plain = [[t.clone() for t in ts] for ts in (params, mu, nu)]
    args = (torch.tensor(1e-3, device=cuda), torch.tensor(0.271, device=cuda),
            torch.tensor(0.1426, device=cuda),
            torch.tensor(0.5, device=cuda), 0.9, 0.95, 1e-8, 0.1)
    before = (K.adamw_launches, K.sq_norm_launches)
    K.update(params, mu, nu, grads, *args)
    total = K.global_sq_norm(grads)
    torch.cuda.synchronize()
    assert (K.adamw_launches - before[0], K.sq_norm_launches - before[1]) \
        == (-(-n // adam_leaves), -(-n // norm_leaves) + 1)
    K.update_plain(*plain, grads, *args)
    for a, b in zip(params + mu + nu, sum(plain, [])):
        assert torch.equal(a, b)
    want = sum(float(g.double().pow(2).sum()) for g in grads)
    assert abs(float(total) - want) <= 1e-5 * want


def _update_args(cuda):
    p = [torch.zeros(8, dtype=BF16, device=cuda)]
    return dict(params=p, mu=[torch.zeros(8, device=cuda)],
                nu=[torch.zeros(8, device=cuda)],
                grads=[torch.zeros(8, dtype=BF16, device=cuda)],
                lr=torch.tensor(1e-3, device=cuda),
                b1c=torch.tensor(0.1, device=cuda),
                b2c=torch.tensor(0.05, device=cuda), scale=None,
                b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


REFUSED = {
    "float16 parameter": lambda a, d: a.update(
        params=[torch.zeros(8, dtype=torch.float16, device=d)],
        grads=[torch.zeros(8, dtype=torch.float16, device=d)]),
    "gradient dtype": lambda a, d: a.update(
        grads=[torch.zeros(8, device=d)]),
    "bf16 moment": lambda a, d: a.update(
        mu=[torch.zeros(8, dtype=BF16, device=d)]),
    "strided gradient": lambda a, d: a.update(
        grads=[torch.zeros(16, dtype=BF16, device=d)[::2]]),
    "float64 lr": lambda a, d: a.update(
        lr=torch.tensor(1e-3, dtype=torch.float64, device=d)),
    "lr on the host": lambda a, d: a.update(lr=torch.tensor(1e-3)),
    "shape": lambda a, d: a.update(nu=[torch.zeros(9, device=d)]),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_update_kernel_refuses(cuda, case):
    args = _update_args(cuda)
    REFUSED[case](args, cuda)
    launches = K.adamw_launches
    with pytest.raises(ValueError):
        torch.ops.strela.adamw_(*args.values())
    assert K.adamw_launches == launches


@pytest.mark.parametrize("grads", [
    lambda d: [torch.zeros(8, dtype=torch.float16, device=d)],
    lambda d: [torch.zeros(16, device=d)[::2]],
    lambda d: [torch.zeros(8, device=d), torch.zeros(8)]])
def test_norm_kernel_refuses(cuda, grads):
    g = grads(cuda)
    with pytest.raises((ValueError, RuntimeError)):
        torch.ops.strela.global_sq_norm(g, [True] * len(g))


def _train_args():
    return ["--arch", "minicpm-2b", "--reduced", "--steps", "3", "--batch",
            "4", "--seq", "64", "--log-every", "1", "--device", "cuda"]


def test_trainer_step_runs_the_kernels_only(cuda):
    """A reduced minicpm-2b (20 leaves) trains 3 steps with one update
    launch and one norm launch plus its sum a step, no plain call."""
    from repro_torch.launch import train
    before = (K.adamw_launches, K.sq_norm_launches, K.plain_calls)
    losses = train.main(_train_args())
    torch.cuda.synchronize()
    assert (K.adamw_launches, K.sq_norm_launches, K.plain_calls) == (
        before[0] + 3, before[1] + 3 * 2, before[2])
    assert all(torch.isfinite(torch.tensor(losses)))


@pytest.fixture
def nccl_rank(cuda):
    """The trainer's one-rank NCCL group, destroyed after the test."""
    import torch.distributed as dist
    yield cuda
    if dist.is_initialized():
        dist.destroy_process_group()


def test_one_rank_nccl_mesh_step_equals_the_one_card_step(nccl_rank):
    """``--model-axis 1``: the norm over the local shards, the all-reduce
    skipped on one rank, the update on the shards, all by the kernels:
    the same losses bit for bit as the trainer with no mesh."""
    from repro_torch.launch import train
    want = train.main(_train_args())
    before = (K.adamw_launches, K.sq_norm_launches, K.plain_calls)
    got = train.main(_train_args() + ["--model-axis", "1"])
    assert got == want
    assert (K.adamw_launches, K.sq_norm_launches, K.plain_calls) == (
        before[0] + 3, before[1] + 3 * 2, before[2])
