"""The port's LM configs and layers against the JAX reference on the CPU:
``repro_torch.configs`` equal to ``repro.configs`` field by field, and each
function of ``repro_torch.models.layers`` within 1e-5 of
``repro.models.layers`` in float32 on the same numpy inputs (attention's
core through the flash kernel's plain version). Every family of the
configs builds; an unknown family raises by name."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.configs.strela_soc import SOC as REF_SOC
from repro.models import layers as RL
from repro_torch.configs import base as pbase
from repro_torch.configs.strela_soc import SOC
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.api import build_model

ARCHS = list(rbase.all_archs())
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def _prop(cfg, name):
    """A property's value, or the exception it raises (``hd`` of an
    attention-free config divides by zero heads in both packages)."""
    try:
        v = getattr(cfg, name)
        return v() if callable(v) else v
    except ArithmeticError as e:
        return type(e)


def test_registry_lists_the_reference_archs_in_order():
    assert list(pbase.all_archs()) == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("variant", ["full", "reduced"])
def test_arch_config_equals_the_reference(arch_id, variant):
    ref, port = rbase.get_arch(arch_id), pbase.get_arch(arch_id)
    if variant == "reduced":
        ref, port = ref.reduced(), port.reduced()
    got, want = dataclasses.asdict(port), dataclasses.asdict(ref)
    if arch_id == "granite-moe-3b-a800m":
        # the port names the model whose widths these are; the reference
        # names granite-3.0-1b-a400m
        assert got.pop("source") == "hf:ibm-granite/granite-3.0-3b-a800m-base; hf"
        assert want.pop("source") == "hf:ibm-granite/granite-3.0-1b-a400m-base; hf"
    assert got == want
    props = ("hd", "vocab_padded", "sub_quadratic", "has_decoder")
    assert [_prop(port, n) for n in props] == [_prop(ref, n) for n in props]
    want = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    assert port.torch_dtype == want[ref.jdtype]


def test_shapes_and_cell_rules_equal_the_reference():
    assert ({k: dataclasses.asdict(v) for k, v in pbase.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in rbase.SHAPES.items()})
    for arch_id in ARCHS:
        for name in rbase.SHAPES:
            assert (pbase.cell_runnable(pbase.get_arch(arch_id),
                                        pbase.SHAPES[name])
                    == rbase.cell_runnable(rbase.get_arch(arch_id),
                                           rbase.SHAPES[name]))


def test_float32_config_maps_to_torch_float32():
    cfg = dataclasses.replace(pbase.get_arch("yi-9b"), dtype="float32")
    assert cfg.torch_dtype == torch.float32


def test_strela_soc_equals_the_reference():
    assert dataclasses.asdict(SOC) == dataclasses.asdict(REF_SOC)
    assert dataclasses.asdict(SOC.fabric()) == dataclasses.asdict(
        REF_SOC.fabric())
    assert dataclasses.asdict(SOC.bus()) == dataclasses.asdict(REF_SOC.bus())
    assert SOC.peak_gops() == REF_SOC.peak_gops()


# ---------------------------------------------------------------------------
# layers, float32
# ---------------------------------------------------------------------------

def test_rmsnorm_and_layernorm():
    rng = np.random.default_rng(0)
    x, g, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 5, 64), (64,), (64,)))
    np.testing.assert_allclose(L.rmsnorm(_t(x), _t(g)).numpy(),
                               _np(RL.rmsnorm(jnp.asarray(x), jnp.asarray(g))),
                               **TOL)
    np.testing.assert_allclose(
        L.layernorm(_t(x), _t(g), _t(b)).numpy(),
        _np(RL.layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))),
        **TOL)


def test_rmsnorm_scales_after_the_cast():
    """bfloat16: normalised in float32, rounded, then times g in bf16."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    x16, g16 = x.to(torch.bfloat16), g.to(torch.bfloat16)
    got = L.rmsnorm(x16, g16)
    assert got.dtype == torch.bfloat16
    ref = RL.rmsnorm(jnp.asarray(x16.float().numpy(), jnp.bfloat16),
                     jnp.asarray(g16.float().numpy(), jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), _np(ref))


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_rope_rotates_halves(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = (7 + np.arange(5))[None, :].repeat(2, 0).astype(np.int32)
    np.testing.assert_allclose(
        L.rope(_t(x), _t(pos), theta).numpy(),
        _np(RL.rope(jnp.asarray(x), jnp.asarray(pos), theta)), **TOL)


def _attn_params(rng, d, nh, nkv, hd, bias):
    p = {"wq": rng.standard_normal((d, nh * hd)),
         "wk": rng.standard_normal((d, nkv * hd)),
         "wv": rng.standard_normal((d, nkv * hd)),
         "wo": rng.standard_normal((nh * hd, d))}
    p = {k: (v * d ** -0.5).astype(np.float32) for k, v in p.items()}
    if bias:             # non-zero, unlike the reference's init
        for k, n in (("bq", nh * hd), ("bk", nkv * hd), ("bv", nkv * hd)):
            p[k] = rng.standard_normal(n).astype(np.float32)
    return p


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("impl", ["full", "chunked"])
def test_attention_matches_the_reference(impl, cached, group, bias):
    """Both reference implementations (chunk 4 < 6 queries, so the chunked
    branch runs), with and without a cache (filled with noise past its
    valid length, which must stay masked), GQA group 1 and 2, qkv bias."""
    rng = np.random.default_rng(3 + 2 * group + bias)
    b, s, d, nh, hd, smax, clen = 2, 6, 32, 4, 16, 16, 5
    nkv = nh // group
    p = _attn_params(rng, d, nh, nkv, hd, bias)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    base = clen if cached else 0
    pos = (base + np.arange(s))[None, :].repeat(b, 0).astype(np.int32)
    rcfg = RL.AttnCfg(d, nh, nkv, hd, bias, 10000.0, impl=impl, chunk=4)
    pcfg = L.AttnCfg(d, nh, nkv, hd, bias, 10000.0)
    caches = [rng.standard_normal((b, smax, nkv, hd)).astype(np.float32)
              for _ in range(2)] if cached else None
    ref, rc = RL.attention(
        {k: jnp.asarray(v) for k, v in p.items()}, rcfg, jnp.asarray(x),
        jnp.asarray(pos),
        tuple(map(jnp.asarray, caches)) if cached else None,
        jnp.asarray(clen, jnp.int32) if cached else None)
    pc = tuple(_t(c) for c in caches) if cached else None
    got, gc = L.attention({k: _t(v) for k, v in p.items()}, pcfg, _t(x),
                          _t(pos), pc, clen if cached else 0)
    np.testing.assert_allclose(got.numpy(), _np(ref), **TOL)
    if cached:
        for g_, r_ in zip(gc, rc):
            np.testing.assert_allclose(g_.numpy(), _np(r_), **TOL)
    else:
        assert gc is None and rc is None


def test_attention_rejects_a_cache_overrun():
    rng = np.random.default_rng(4)
    p = {k: _t(v) for k, v in _attn_params(rng, 32, 4, 4, 16, False).items()}
    caches = (torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 4, 16))
    x = torch.zeros(1, 2, 32)
    with pytest.raises(ValueError, match="do not fit a cache of 8"):
        L.attention(p, L.AttnCfg(32, 4, 4, 16), x,
                    torch.tensor([[7, 8]]), caches, 7)


def test_attention_core_goes_through_the_flash_wrapper():
    """On CPU tensors, one plain call of the kernel's wrapper per call."""
    rng = np.random.default_rng(5)
    p = {k: _t(v) for k, v in _attn_params(rng, 32, 4, 2, 16, False).items()}
    before = (fa.launches, fa.plain_calls)
    L.attention(p, L.AttnCfg(32, 4, 2, 16), torch.zeros(2, 3, 32),
                torch.arange(3)[None].expand(2, 3))
    assert (fa.launches, fa.plain_calls) == (before[0], before[1] + 1)


def _recording(monkeypatch):
    """Wraps the layers' flash entry point: each call's q, k, v dtypes."""
    seen = []

    def kernel(q, k, v, causal=True):
        seen.append((q.dtype, k.dtype, v.dtype))
        return fa.flash_attention(q, k, v, causal)
    monkeypatch.setattr(L, "flash_attention", kernel)
    return seen


@pytest.mark.parametrize("x_dtype,cache_dtype,want", [
    (torch.bfloat16, None, torch.bfloat16),
    (torch.float32, None, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16, torch.float32)])
def test_attention_hands_the_kernel_the_activations_dtype(
        monkeypatch, x_dtype, cache_dtype, want):
    """bfloat16 activations reach the kernel as bfloat16 (its tensor-core
    route on the card), float32 ones as float32, and a float32 query
    against a bfloat16 cache as float32; the output is x's dtype, and the
    gradient flows through the same call."""
    seen = _recording(monkeypatch)
    rng = np.random.default_rng(6)
    p = {k: _t(v).to(x_dtype).requires_grad_()
         for k, v in _attn_params(rng, 32, 4, 2, 16, False).items()}
    x = torch.from_numpy(rng.standard_normal((2, 3, 32)).astype(
        np.float32)).to(x_dtype)
    caches = None if cache_dtype is None else tuple(
        torch.zeros(2, 8, 2, 16, dtype=cache_dtype) for _ in range(2))
    out, _ = L.attention(p, L.AttnCfg(32, 4, 2, 16), x,
                         torch.arange(3)[None].expand(2, 3), caches, 0)
    assert out.dtype == x_dtype and seen == [(want,) * 3]
    out.float().square().sum().backward()
    assert all(v.grad is not None for v in p.values())


def test_a_bf16_model_hands_every_layer_bf16_to_the_kernel(monkeypatch):
    """A bfloat16 LM's loss and gradient (minicpm-2b reduced): every
    layer's attention gives the kernel bfloat16 q, k and v."""
    seen = _recording(monkeypatch)
    cfg = pbase.get_arch("minicpm-2b").reduced()
    assert cfg.torch_dtype == torch.bfloat16
    api = build_model(cfg)
    params = api.init_params(torch.Generator("cpu").manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 9),
                         generator=torch.Generator("cpu").manual_seed(1))
    loss, _ = api.loss(params, {"tokens": toks[:, :-1],
                                "targets": toks[:, 1:]})
    loss.backward()
    assert seen == [(torch.bfloat16,) * 3] * cfg.n_layers


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp_matches_the_reference(activation):
    rng = np.random.default_rng(6)
    d, f = 32, 64
    names = ("wg", "wu", "wd") if activation == "swiglu" else ("wu", "wd")
    p = {n: (rng.standard_normal((f, d) if n == "wd" else (d, f))
             * d ** -0.5).astype(np.float32) for n in names}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    ref = RL.mlp({k: jnp.asarray(v) for k, v in p.items()},
                 RL.MlpCfg(d, f, activation), jnp.asarray(x))
    got = L.mlp({k: _t(v) for k, v in p.items()}, L.MlpCfg(d, f, activation),
                _t(x))
    np.testing.assert_allclose(got.numpy(), _np(ref), **TOL)


@pytest.mark.parametrize("vocab", [None, 256, 250])
def test_xent_loss_matches_the_reference(vocab):
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 5, 256)).astype(np.float32) * 3
    targets = rng.integers(0, vocab or 256, (2, 5)).astype(np.int32)
    ref = RL.xent_loss(jnp.asarray(logits), jnp.asarray(targets), vocab)
    got = L.xent_loss(_t(logits), _t(targets), vocab)
    np.testing.assert_allclose(float(got), float(ref), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab", [256, 250])
def test_mask_padded_vocab_matches_the_reference(vocab, dtype):
    rng = np.random.default_rng(8)
    logits = torch.from_numpy(rng.standard_normal((3, 256)).astype(
        np.float32)).to(getattr(torch, dtype))
    ref = RL.mask_padded_vocab(
        jnp.asarray(logits.float().numpy(), getattr(jnp, dtype)), vocab)
    got = L.mask_padded_vocab(logits, vocab)
    assert got.dtype == logits.dtype
    np.testing.assert_array_equal(got.float().numpy(), _np(ref))


def test_init_helpers_follow_the_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    w = L.dense_init(gen, 256, 512, torch.float32)
    e = L.embed_init(gen, 1024, 64, torch.bfloat16)
    assert w.shape == (256, 512) and e.dtype == torch.bfloat16
    assert abs(float(w.std()) - (2 / 768) ** 0.5) < 2e-3
    assert abs(float(e.float().std()) - 0.02) < 1e-3


# ---------------------------------------------------------------------------
# every family builds; an unknown one raises by name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", [a for a in ARCHS
                                     if pbase.get_arch(a).family != "dense"])
def test_other_families_raise_naming_their_queue_item(arch_id):
    """Every family in the configs is ported (moe, vlm, ssm, hybrid and
    audio): each non-dense arch builds, and its family under another name
    raises ``ValueError`` naming it."""
    cfg = pbase.get_arch(arch_id).reduced()
    assert build_model(cfg).cfg is cfg
    unknown = dataclasses.replace(cfg, family=f"{cfg.family}-x")
    with pytest.raises(ValueError, match=f"{cfg.family}-x"):
        build_model(unknown)


def test_a_moe_config_raises_in_the_transformer():
    """As in the reference, ``cfg.moe`` (not the family) decides a
    layer's MoE branch: a granite config named dense still gets its
    experts, and a dense one none."""
    cfg = dataclasses.replace(pbase.get_arch("granite-moe-3b-a800m").reduced(),
                              family="dense")
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    assert all(hasattr(b, "moe") and not hasattr(b, "mlp")
               for b in params.layers)
    dense = dataclasses.replace(cfg, moe=None)
    params = transformer.init_params(torch.Generator().manual_seed(0), dense)
    assert all(hasattr(b, "mlp") and not hasattr(b, "moe")
               for b in params.layers)
