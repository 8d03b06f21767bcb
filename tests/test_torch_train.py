"""Training in the port against the JAX reference on the CPU: the flash
attention's gradient (``kernels.flash_attention.FlashAttentionFn`` and its
plain backward, ``kernels.ref.flash_attention_backward``), the loss and
every gradient of one reduced arch per family, and the trainer's
``make_step`` (``repro_torch.launch.train``) step by step against
``repro.launch.train.make_step``. Inputs are numpy arrays from a seed,
handed to both packages; parameters are the reference's own
(``init_params(PRNGKey(0))``, carried over by
``convert.lm_params_from_reference``), in float32.

Tolerances: the plain backward within 2e-5 of ``jax.grad`` (float32 sums
in another order); the Function within 1e-6 of torch autograd through the
plain forward; a model's loss within 1e-6 relative and each gradient
leaf within 2e-5 of its largest entry (measured at most 3.3e-6: forty
float32 ops of rounding); ``make_step`` as described at its test. The
reference's gradient is jitted for every family, the MoE arch included:
in float32 XLA's fusion moves no router input across a routing tie here
(``tests/test_torch_lm_parity.py`` runs the bf16 MoE archs op by op,
where a fused bf16 chain does)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.checkpoint.ckpt import _flatten as ref_flatten
from repro.configs.base import get_arch as ref_arch
from repro.kernels import ref as RK
from repro.launch.train import make_step as ref_make_step
from repro.models.api import build_model as ref_build
from repro.models.layers import _chunked_attention
from repro.optim import grad_compress as ref_gc
from repro.optim.adamw import AdamW as RefAdamW
from repro.optim.adamw import wsd_schedule as ref_wsd
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.configs.base import get_arch
from repro_torch.convert import (_to_reference, lm_params_from_reference,
                                 lm_params_to_reference)
from repro_torch.data.pipeline import DataCfg, TokenPipeline
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.launch import train
from repro_torch.models.api import build_model
from repro_torch.optim import grad_compress
from repro_torch.optim.adamw import AdamW

# (h, sq, sk, d): sq != sk, sq = sk, one query, keys past a chunk
SHAPES = [(2, 5, 9, 16), (3, 12, 12, 16), (2, 1, 7, 64), (1, 20, 33, 16)]


def _qkvdo(h, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((h, sq, d), (h, sk, d), (h, sk, d), (h, sq, d))]


def _plain_grads(q, k, v, do, causal):
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_attention_lse(tq, tk, tv, causal)
    return [g.numpy() for g in ref.flash_attention_backward(
        tq, tk, tv, o, lse, tdo, causal)]


def _full(q, k, v, causal):
    """The reference's "full" attention branch (einsum, where(mask, -inf),
    softmax, einsum) as its oracle ``repro.kernels.ref`` writes it."""
    return RK.flash_attention(q, k, v, causal=causal)


def _chunked(q, k, v, causal, blk=4):
    """The reference's ``_chunked_attention`` on (h, s, d) operands, keys
    in blocks of ``blk``, the queries at the end of the keys."""
    sq, sk = q.shape[1], k.shape[1]
    qpos = jnp.arange(sk - sq, sk, dtype=jnp.int32)[None]
    kpos = jnp.arange(sk, dtype=jnp.int32)[None]
    out = _chunked_attention(
        jnp.swapaxes(q, 0, 1)[None], jnp.swapaxes(k, 0, 1)[None],
        jnp.swapaxes(v, 0, 1)[None], qpos, kpos, 1.0 / (q.shape[-1] ** 0.5),
        blk, P(None, None, None, None), causal)
    return jnp.swapaxes(out[0], 0, 1)


@pytest.mark.parametrize("branch", ["full", "chunked"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_flash_backward_matches_jax_grad(branch, causal, shape):
    q, k, v, do = _qkvdo(*shape, seed=sum(shape))
    fn = _full if branch == "full" else _chunked
    _, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, causal), q, k, v)
    want = vjp(jnp.asarray(do))
    for got, w, name in zip(_plain_grads(q, k, v, do, causal), want,
                            ("dq", "dk", "dv")):
        np.testing.assert_allclose(got, np.asarray(w), atol=2e-5, rtol=2e-5,
                                   err_msg=f"{branch} {name}")


def test_plain_lse_is_the_masked_logsumexp():
    q, k, v, _ = _qkvdo(2, 5, 9, 16, seed=3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = ref.flash_attention_lse(tq, tk, tv, True)
    logits = np.einsum("hqd,hkd->hqk", q, k) / 4.0
    mask = np.tril(np.ones((5, 9), bool), k=4)
    want = np.asarray(jax.scipy.special.logsumexp(
        np.where(mask, logits, -np.inf), axis=-1))
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-6, rtol=1e-6)
    assert torch.equal(o, ref.flash_attention(tq, tk, tv, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fn_on_cpu_matches_autograd_of_plain(dtype, causal):
    """The Function's plumbing on CPU tensors: saved tensors, dtypes, a
    strided incoming gradient made contiguous, and GQA's
    ``repeat_interleave`` outside the Function summed by autograd."""
    rng = np.random.default_rng(7)
    kvh, group, sq, sk, d = 2, 3, 6, 10, 16
    q0 = torch.from_numpy(rng.standard_normal((kvh * group, sq, d))
                          .astype(np.float32)).to(dtype)
    k0, v0 = (torch.from_numpy(rng.standard_normal((kvh, sk, d))
                               .astype(np.float32)).to(dtype)
              for _ in range(2))
    # the incoming gradient as the transpose of a contiguous tensor
    do = torch.from_numpy(rng.standard_normal((d, sq, kvh * group))
                          .astype(np.float32)).to(dtype).permute(2, 1, 0)
    assert not do.is_contiguous()
    grads, calls = [], fa.backward_plain_calls
    for attn in (fa.flash_attention,
                 lambda a, b, c, m: ref.flash_attention(a, b, c, m)):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        o = attn(q, torch.repeat_interleave(k, group, 0),
                 torch.repeat_interleave(v, group, 0), causal)
        assert o.dtype == dtype and o.requires_grad
        grads.append(torch.autograd.grad(o, (q, k, v), do))
    assert fa.backward_plain_calls == calls + 1      # the Function's, once
    for got, want in zip(*grads):
        assert got.dtype == dtype and got.shape == want.shape
        tol = 1e-6 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def test_flash_attention_takes_the_function_only_with_a_gradient():
    q, k, v, _ = _qkvdo(2, 4, 4, 16, seed=1)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = fa.backward_plain_calls
    assert not fa.flash_attention(tq, tk, tv).requires_grad
    tq.requires_grad_()
    with torch.no_grad():
        assert not fa.flash_attention(tq, tk, tv).requires_grad
    out = fa.flash_attention(tq, tk, tv)
    assert out.grad_fn is not None and "FlashAttentionFn" in str(out.grad_fn)
    out.sum().backward()
    assert fa.backward_plain_calls == before + 1 and tq.grad is not None


def test_attention_kernel_refuses_an_input_that_needs_a_gradient():
    """The silent fault: the kernel writes through a raw pointer, so its
    output would carry no graph. It raises before it looks at the
    device."""
    q, k, v, _ = _qkvdo(2, 4, 4, 16, seed=2)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tk.requires_grad_()
    with pytest.raises(ValueError, match="attention_kernel returns no "
                                         "gradient"):
        fa.attention_kernel(tq, tk, tv)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fa.attention_kernel(tq, tk, tv)        # no graph asked: the device


# ---------------------------------------------------------------------------
# the loss and every gradient of one reduced arch per family
# ---------------------------------------------------------------------------

B, S = 2, 16
FAMILY_ARCHS = [("minicpm-2b", "full"), ("minicpm-2b", "chunked"),
                ("yi-9b", "full"), ("granite-moe-3b-a800m", "full"),
                ("internvl2-76b", "full"), ("mamba2-1.3b", "full"),
                ("zamba2-2.7b", "full"), ("whisper-base", "full")]


def _batch(rcfg, seed):
    rng = np.random.default_rng(seed)
    np_b = {"tokens": rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32),
            "targets": rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32)}
    stub = {"vlm": ("patches", rcfg.n_patches),
            "audio": ("frames", rcfg.encdec.enc_len if rcfg.encdec else 0)}
    if rcfg.family in stub:
        key, n = stub[rcfg.family]
        np_b[key] = (rng.standard_normal((B, n, rcfg.d_model)) * 0.02
                     ).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in np_b.items()},
            {k: torch.from_numpy(v) for k, v in np_b.items()})


@pytest.mark.parametrize("arch,impl", FAMILY_ARCHS)
def test_loss_and_every_gradient_match_the_reference(arch, impl):
    kw = dict(dtype="float32", attention_impl=impl, attention_chunk=8)
    rcfg = dataclasses.replace(ref_arch(arch).reduced(), **kw)
    pcfg = dataclasses.replace(get_arch(arch).reduced(), **kw)
    rapi, papi = ref_build(rcfg), build_model(pcfg)
    rp = rapi.init_params(jax.random.PRNGKey(0))
    pp = lm_params_from_reference(jax.device_get(rp), pcfg, "cpu")
    rb, pb = _batch(rcfg, seed=len(arch))
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(rapi.loss, has_aux=True))(
        rp, rb)
    ploss, _ = papi.loss(pp, pb)
    named = list(pp.named_parameters())
    grads = torch.autograd.grad(ploss, [p for _, p in named])
    assert all(g is not None for g in grads)
    np.testing.assert_allclose(float(ploss.detach()), float(rloss),
                               rtol=1e-6)
    want = ref_flatten(jax.device_get(rgrads))
    got = _flatten(_to_reference([(n, g) for (n, _), g in zip(named, grads)]))
    assert got.keys() == want.keys()
    for key, w in want.items():
        w = np.asarray(w, np.float32)
        err = np.abs(got[key].numpy() - w).max()
        assert err <= 2e-5 * max(np.abs(w).max(), 1e-30), (key, err)


# ---------------------------------------------------------------------------
# make_step against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
def test_make_step_matches_the_reference_for_three_steps(compress):
    """Three steps of the trainer's step (loss, gradient, compression,
    clipping, AdamW under wsd) from the same parameters and batches.
    Losses within 1e-6 and gnorms within 1e-5 relative each step. The
    parameters after: without compression within 1e-5 (measured 8.5e-7);
    with it, a block whose target lies within float32 noise of a rounding
    boundary rounds to the next int8 level in one package and not the
    other, and Adam's normalised step carries that entry at most
    2 x (lr_1 + lr_2 + lr_3) = 7.2e-4 apart, so those entries must stay
    under 1% of all (measured 119 of 90,432)."""
    rcfg = dataclasses.replace(ref_arch("minicpm-2b").reduced(),
                               dtype="float32")
    pcfg = dataclasses.replace(get_arch("minicpm-2b").reduced(),
                               dtype="float32")
    rapi, papi = ref_build(rcfg), build_model(pcfg)
    rp = rapi.init_params(jax.random.PRNGKey(0))
    pp = lm_params_from_reference(jax.device_get(rp), pcfg, "cpu")
    ropt = RefAdamW(lr=ref_wsd(3e-4, warmup=5, stable=7, decay=2))
    popt = AdamW(lr=train.schedule("wsd", 3e-4, 10))
    rs, ps = ropt.init(rp), popt.init(list(pp.parameters()))
    re = ref_gc.init_error(rp) if compress else None
    pe = grad_compress.init_error(list(pp.parameters())) if compress else None
    rstep = jax.jit(ref_make_step(rapi, ropt, compress))
    pstep = train.make_step(papi, popt, compress)
    pipe = TokenPipeline(DataCfg(rcfg.vocab, S, B, seed=0))
    for i in range(3):
        b = pipe.batch(i)
        rp, rs, re, rm = rstep(rp, rs, re, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        pp, ps, pe, pm = pstep(pp, ps, pe, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(pm["gnorm"]), float(rm["gnorm"]),
                                   rtol=1e-5)
    assert int(ps.count) == int(rs.count) == 3
    want = ref_flatten(jax.device_get(rp))
    got = _flatten(lm_params_to_reference(pp, pcfg))
    diffs = {k: np.abs(got[k].numpy() - np.asarray(w)) for k, w in
             want.items()}
    worst = max(d.max() for d in diffs.values())
    if not compress:
        assert worst <= 1e-5, worst
    else:
        off = sum(int((d > 1e-6).sum()) for d in diffs.values())
        total = sum(d.size for d in diffs.values())
        assert worst <= 7.2e-4 and off <= 0.01 * total, (worst, off, total)
