"""The port's Whisper encoder-decoder (``repro_torch.models.encdec``, its
builder and ``convert``) against the JAX reference (``repro.models.
encdec``) on the CPU, from the reference's own parameters (carried over
by ``convert``) and identical numpy inputs, at whisper-base's reduced
widths (d_model 64, 4 query heads over 2 kv heads, 2 encoder and 2
decoder layers, 32 frames). One test per numeric contract; each was
checked to fail on a broken copy of the port's code, named in its
docstring:

  (a) the encoder: learned positions, pre-LN layers of non-causal
      attention that still ropes, the final LayerNorm, one attention
      path whatever ``attention_impl`` says;
  (b) LayerNorm: float32 statistics, the cast, then ``* g + b`` in x's
      dtype;
  (c) the GELU MLP: tanh form in float32, cast back before ``wd``;
  (d) the decoder: token embedding plus learned positions from
      ``cache_len``, causal self-attention writing the cache, the layer
      order, the tied head, a float32 zero aux;
  (e) cross-attention: k and v recomputed from the encoder's output on
      every call, no rope, no mask, kv heads repeated, one non-causal
      flash call over the frames;
  (f) the caches in the config's dtype;
  (g) ``api.prefill``'s caches exactly S long: the reference clamps the
      next write, the port raises;
  (h) the padded vocab masked by ``decode_step`` only;
  (i) positions past ``MAX_DEC_POS``: the reference clamps, the port
      raises.

Tolerances: float32 within 2e-4 (the LM parity tests'); bit-exact
bfloat16 comparisons run the reference op by op (eager ``jnp``), which
rounds each operation as the port does."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as ref_arch
from repro.models import encdec as RE
from repro.models import layers as RL
from repro.models.api import build_model as ref_build
from repro_torch.configs.base import get_arch
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.api import build_model

ARCH = "whisper-base"
TOL = dict(atol=2e-4, rtol=2e-4)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(**kw):
    return (dataclasses.replace(ref_arch(ARCH).reduced(), **kw),
            dataclasses.replace(get_arch(ARCH).reduced(), **kw))


def _params(rcfg, pcfg, seed=0):
    rp = ref_build(rcfg).init_params(jax.random.PRNGKey(seed))
    return rp, lm_params_from_reference(jax.device_get(rp), pcfg, "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _both(x, dtype="float32"):
    """A numpy array rounded to ``dtype``, for both packages."""
    xr = jnp.asarray(x, JDT[dtype])
    return xr, torch.from_numpy(np.array(xr.astype(jnp.float32))).to(
        TDT[dtype])


def _frames(cfg, seed, batch=2, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(
        (batch, cfg.encdec.enc_len, cfg.d_model)) * scale
    return _both(x, cfg.dtype)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


@pytest.fixture
def flash_calls(monkeypatch):
    """Record (causal, q shape, k shape) of every flash call the model
    makes, through ``layers.attention`` and through cross-attention."""
    calls = []
    for mod in (L, E):
        real = mod.flash_attention

        def rec(q, k, v, causal=True, real=real):
            calls.append((causal, tuple(q.shape), tuple(k.shape)))
            return real(q, k, v, causal)
        monkeypatch.setattr(mod, "flash_attention", rec)
    return calls


# ---------------------------------------------------------------------------
# (a) the encoder
# ---------------------------------------------------------------------------

def test_encoder_ropes_non_causal_attention_over_learned_positions(
        flash_calls):
    """``frames + enc_pos_embed[:T]``, pre-LN layers ``x + attn(ln1(x))``
    and ``x + mlp(ln2(x))``, the final LN: the port's ``encode`` equals
    the reference's within 2e-4 in float32, each layer's attention one
    non-causal flash call over all T frames. The reference's
    ``_attn_cfg`` passes no ``impl``, so "chunked" gives the same bits
    there. Failed on copies without rope in the encoder (positions
    dropped), with ``causal=True`` and without ``enc_pos_embed``."""
    rcfg, pcfg = _pair(dtype="float32")
    rp, pp = _params(rcfg, pcfg)
    fr, ft = _frames(rcfg, 1)
    want = RE.encode(rp, rcfg, fr)
    chunked = dataclasses.replace(rcfg, attention_impl="chunked",
                                  attention_chunk=8)
    np.testing.assert_array_equal(_f32(RE.encode(rp, chunked, fr)),
                                  _f32(want))
    with torch.no_grad():
        got = E.encode(pp, pcfg, ft)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    T_enc, bh = rcfg.encdec.enc_len, 2 * rcfg.n_heads
    assert flash_calls == [(False, (bh, T_enc, rcfg.hd),
                            (bh, T_enc, rcfg.hd))] * rcfg.encdec.n_enc_layers


# ---------------------------------------------------------------------------
# (b) LayerNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_scales_and_shifts_after_the_cast(dtype):
    """Mean and biased variance in float32, normalised, cast to x's dtype,
    and only then ``* g + b`` in that dtype: bit for bit in bfloat16
    against the reference's ``L.layernorm`` run op by op (1e-6 in
    float32), on a drawn g and b. Failed on a copy that applied g and b
    in float32 before the cast (about 3,100 of 8,448 bf16 values moved)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 33, 64)) * 3 + 1
    (xr, xt), (gr, gt), (br, bt) = (
        _both(a, dtype) for a in (x, rng.uniform(0.5, 1.5, 64),
                                  rng.standard_normal(64) * 0.5))
    got = L.layernorm(xt, gt, bt)
    want = RL.layernorm(xr, gr, br)
    assert got.dtype == TDT[dtype]
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_f32(got), _f32(want))
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-6,
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# (c) the GELU MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_is_the_tanh_form_in_float32(dtype):
    """``gelu(x @ wu)`` in float32 by the tanh approximation (the default
    of ``jax.nn.gelu``), cast to x's dtype, then ``@ wd``: bit for bit in
    bfloat16 against the reference op by op, 1e-6 in float32. Failed on a
    copy with the exact (erf) GELU. (A copy that takes the GELU of the
    bf16 product passed: torch's CPU GELU computes bf16 in float32 and
    rounds once, the same bits.)"""
    rng = np.random.default_rng(3)
    (xr, xt), (ur, ut), (dr, dt) = (
        _both(a, dtype) for a in (rng.standard_normal((2, 17, 64)),
                                  rng.standard_normal((64, 128)) * 0.1,
                                  rng.standard_normal((128, 64)) * 0.1))
    got = L.mlp({"wu": ut, "wd": dt}, E._mlp_cfg(get_arch(ARCH).reduced()),
                xt)
    want = RL.mlp({"wu": ur, "wd": dr}, RL.MlpCfg(64, 128, "gelu"), xr)
    assert got.dtype == TDT[dtype]
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_f32(got), _f32(want))
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-6,
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# (d) the decoder
# ---------------------------------------------------------------------------

def test_decoder_positions_layer_order_and_tied_head():
    """``embed[tokens] + pos_embed[cache_len + arange(S)]``, causal
    self-attention (its cache written at ``cache_len``), cross-attention,
    the MLP, the final LN and ``x @ embed.T`` (no separate head): the
    port's ``decode`` equals the reference's within 2e-4 in float32,
    without caches and with caches at ``cache_len`` 3, caches included;
    aux is a float32 zero. Failed on copies that took the positions from
    0 whatever ``cache_len``, that swapped the cross-attention and the
    MLP, and that ran the self-attention non-causal."""
    rcfg, pcfg = _pair(dtype="float32")
    rp, pp = _params(rcfg, pcfg)
    assert "lm_head" not in rp and not hasattr(pp, "lm_head")
    fr, ft = _frames(rcfg, 4, scale=0.02)
    enc_r = RE.encode(rp, rcfg, fr)
    with torch.no_grad():
        enc_t = E.encode(pp, pcfg, ft)
        toks = _tokens(rcfg, (2, 9), 5)
        want, _, raux = RE.decode(rp, rcfg, jnp.asarray(toks), enc_r)
        got, caches, aux = E.decode(pp, pcfg, torch.from_numpy(toks), enc_t)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
        assert caches is None
        assert aux.dtype == torch.float32 and float(aux) == 0.0 == raux
        rc = RE.init_caches(rcfg, 2, 8)
        rc = tuple(c.at[:, :, :3].set(0.5) for c in rc)
        pc = tuple(torch.from_numpy(np.array(c)) for c in rc)
        want, rc, _ = RE.decode(rp, rcfg, jnp.asarray(toks[:, :2]), enc_r,
                                rc, jnp.asarray(3, jnp.int32))
        got, pc, _ = E.decode(pp, pcfg, torch.from_numpy(toks[:, :2]),
                              enc_t, pc, 3)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    for g, w in zip(pc, rc):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)
    assert bool(pc[0][:, :, 3:5].any()) and not pc[0][:, :, 5:].any()


# ---------------------------------------------------------------------------
# (e) cross-attention
# ---------------------------------------------------------------------------

def test_cross_attention_recomputes_k_and_v_without_rope_or_mask(
        flash_calls):
    """``q = x @ wq``; ``k, v = enc_out @ wk, wv`` on every call (two calls
    over two encoder outputs each equal the reference's: nothing is kept
    between them); the kv heads repeated as ``jnp.repeat`` (4 query heads
    over 2 kv heads); no rope, no mask; one ``flash_attention(...,
    causal=False)`` over the T frames; within 2e-4 in float32. Failed on
    copies with ``Tensor.repeat`` for the kv heads, with ``causal=True``,
    and with rope on q and k."""
    rcfg, pcfg = _pair(dtype="float32")
    assert rcfg.n_heads // rcfg.n_kv_heads == 2
    rp, pp = _params(rcfg, pcfg)
    p = pp.dec_layers[0].cross_attn
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, rcfg.d_model)).astype(np.float32)
    for seed in (7, 8):
        enc = np.random.default_rng(seed).standard_normal(
            (2, rcfg.encdec.enc_len, rcfg.d_model)).astype(np.float32)
        want = RE._cross_attention(
            jax.tree.map(lambda a: a[0], rp["dec_layers"])["cross_attn"],
            rcfg, jnp.asarray(x), jnp.asarray(enc))
        with torch.no_grad():
            got = E.cross_attention(p, pcfg, torch.from_numpy(x),
                                    torch.from_numpy(enc))
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    bh, T_enc = 2 * rcfg.n_heads, rcfg.encdec.enc_len
    assert flash_calls == [(False, (bh, 5, rcfg.hd),
                            (bh, T_enc, rcfg.hd))] * 2


# ---------------------------------------------------------------------------
# (f) caches in the config's dtype
# ---------------------------------------------------------------------------

def test_caches_are_in_the_config_dtype():
    """``init_caches`` gives (n_layers, B, max_len, n_kv, hd) in the
    config's dtype: float32 in a float32 config (the transformer's
    default is bf16), so decode steps over them meet the reference within
    the forward's 2e-4. Failed on a copy that allocated bf16 caches (the
    dtype check)."""
    for dtype in ("float32", "bfloat16"):
        rcfg, pcfg = _pair(dtype=dtype)
        want = RE.init_caches(rcfg, 3, 10)
        got = E.init_caches(pcfg, 3, 10, device="cpu")
        for w, g in zip(want, got):
            assert tuple(g.shape) == w.shape and g.dtype == TDT[dtype]
            assert not g.any()
    assert T.init_caches(pcfg, 3, 10, device="cpu")[0].dtype == torch.bfloat16
    rcfg, pcfg = _pair(dtype="float32")
    rp, pp = _params(rcfg, pcfg)
    fr, ft = _frames(rcfg, 9, scale=0.02)
    toks = _tokens(rcfg, (2, 4), 10)
    rapi, papi = ref_build(rcfg), build_model(pcfg)
    rs = (RE.encode(rp, rcfg, fr), RE.init_caches(rcfg, 2, 6))
    with torch.no_grad():
        ps = (E.encode(pp, pcfg, ft), E.init_caches(pcfg, 2, 6, "cpu"))
    for t in range(4):
        want, rs = rapi.decode_step(rp, rs, jnp.asarray(toks[:, t:t + 1]),
                                    jnp.asarray(t, jnp.int32))
        got, ps = papi.decode_step(pp, ps, torch.from_numpy(
            toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    assert ps[1][0].dtype == torch.float32


# ---------------------------------------------------------------------------
# (g) api.prefill's caches are exactly S long
# ---------------------------------------------------------------------------

def test_prefill_caches_are_s_long_the_reference_clamps_the_port_raises():
    """``prefill`` encodes, allocates caches of exactly S positions (a
    ``max_len`` is ignored), decodes the prompt at 0 and returns the
    unmasked last logits with ``(enc_out, caches)``. A ``decode_step`` at
    ``cache_len`` S then writes past the caches: the reference's
    ``dynamic_update_slice`` clamps the start and overwrites position
    S - 1; the port raises ``ValueError``. Failed on a copy that honoured
    ``max_len``."""
    rcfg, pcfg = _pair(dtype="float32")
    rp, pp = _params(rcfg, pcfg)
    fr, ft = _frames(rcfg, 11, scale=0.02)
    toks = _tokens(rcfg, (2, 6), 12)
    want, (renc, rc) = ref_build(rcfg).prefill(
        rp, {"tokens": jnp.asarray(toks), "frames": fr, "max_len": 20})
    papi = build_model(pcfg)
    got, (penc, pc) = papi.prefill(pp, {"tokens": torch.from_numpy(toks),
                                        "frames": ft, "max_len": 20})
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    np.testing.assert_allclose(_f32(penc), _f32(renc), **TOL)
    assert rc[0].shape[2] == pc[0].shape[2] == 6
    for g, w in zip(pc, rc):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)
    nxt = toks[:, :1]
    _, (_, rc2) = ref_build(rcfg).decode_step(
        rp, (renc, rc), jnp.asarray(nxt), jnp.asarray(6, jnp.int32))
    assert rc2[0].shape == rc[0].shape
    assert not np.array_equal(_f32(rc2[0][:, :, 5]), _f32(rc[0][:, :, 5]))
    np.testing.assert_array_equal(_f32(rc2[0][:, :, :5]),
                                  _f32(rc[0][:, :, :5]))
    with pytest.raises(ValueError, match="do not fit a cache of 6"):
        papi.decode_step(pp, (penc, pc), torch.from_numpy(nxt), 6)


# ---------------------------------------------------------------------------
# (h) the padded vocab
# ---------------------------------------------------------------------------

def test_decode_step_masks_the_padded_vocab_prefill_does_not():
    """``tests/test_models.py:103-117`` for the port: a zero ``enc_out``
    over caches 4 long, one decode step, the columns >= vocab at -1e30;
    at vocab 250 (padded to 256; the reduced 256 pads nothing) ``prefill``
    leaves them as they are, finite and equal to the reference's. Failed
    on a copy whose ``decode_step`` returned the logits unmasked."""
    rcfg, pcfg = _pair(dtype="float32", vocab=250)
    assert pcfg.vocab_padded == 256
    rp, pp = _params(rcfg, pcfg)
    papi = build_model(pcfg)
    B = 2
    state = (torch.zeros(B, pcfg.encdec.enc_len, pcfg.d_model),
             E.init_caches(pcfg, B, 4, device="cpu"))
    logits, _ = papi.decode_step(pp, state, torch.zeros(B, 1, dtype=int), 0)
    assert np.all(_f32(logits)[:, 250:] <= -1e29)
    assert np.all(_f32(logits)[:, :250] > -1e29)
    fr, ft = _frames(rcfg, 13, scale=0.02)
    toks = _tokens(rcfg, (B, 5), 14)
    want, _ = ref_build(rcfg).prefill(rp, {"tokens": jnp.asarray(toks),
                                           "frames": fr})
    got, _ = papi.prefill(pp, {"tokens": torch.from_numpy(toks),
                               "frames": ft})
    pad = _f32(got)[:, 250:]
    assert np.all(np.isfinite(pad)) and np.all(np.abs(pad) < 1e3)
    np.testing.assert_allclose(pad, _f32(want)[:, 250:], **TOL)


# ---------------------------------------------------------------------------
# (i) positions past MAX_DEC_POS
# ---------------------------------------------------------------------------

def test_positions_past_the_learned_table_raise():
    """``pos_embed`` has ``MAX_DEC_POS`` rows in both packages. The
    reference's gather clamps a position past it to the last row; the
    port raises ``ValueError`` naming the table, and decodes the last
    rows themselves as the reference does. Failed on a copy without the
    check, which broadcast the one row left in the slice and decoded
    without a word."""
    assert E.MAX_DEC_POS == RE.MAX_DEC_POS == 32768 + 8
    rcfg, pcfg = _pair(dtype="float32")
    rp, pp = _params(rcfg, pcfg)
    assert pp.pos_embed.shape == (E.MAX_DEC_POS, pcfg.d_model)
    last = rp["pos_embed"][E.MAX_DEC_POS - 1]
    np.testing.assert_array_equal(
        _f32(rp["pos_embed"][E.MAX_DEC_POS + jnp.arange(2)]),
        _f32(jnp.stack([last, last])))
    enc = jnp.zeros((2, rcfg.encdec.enc_len, rcfg.d_model))
    toks = _tokens(rcfg, (2, 2), 15)
    base = E.MAX_DEC_POS - 2
    want = RE.decode(rp, rcfg, jnp.asarray(toks), enc, None,
                     jnp.asarray(base, jnp.int32))[0]
    with torch.no_grad():
        got = E.decode(pp, pcfg, torch.from_numpy(toks),
                       torch.zeros(enc.shape), None, base)[0]
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    clamped = RE.decode(rp, rcfg, jnp.asarray(toks), enc, None,
                        jnp.asarray(base + 1, jnp.int32))[0]
    assert np.all(np.isfinite(_f32(clamped)))
    with pytest.raises(ValueError, match="learned decoder positions"):
        E.decode(pp, pcfg, torch.from_numpy(toks), torch.zeros(enc.shape),
                 None, base + 1)


# ---------------------------------------------------------------------------
# convert and the builder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_unstacks_both_layer_stacks_keeping_dtypes(dtype):
    """``enc_layers`` over the encoder's depth and ``dec_layers`` over
    ``n_layers``, every other leaf as it is, each in its own dtype; the
    model refuses stacks of another depth than the config's, by name."""
    rcfg, pcfg = _pair(dtype=dtype, n_layers=3)
    rp, pp = _params(rcfg, pcfg)
    assert (len(pp.enc_layers), len(pp.dec_layers)) == (2, 3)
    got = dict(pp.named_parameters())
    want = {}
    for k, v in jax.tree_util.tree_flatten_with_path(jax.device_get(rp))[0]:
        names = [str(getattr(e, "key", "")) for e in k]
        if names[0] in ("enc_layers", "dec_layers"):
            for i in range(v.shape[0]):
                want[".".join([names[0], str(i)] + names[1:])] = v[i]
        else:
            want[".".join(names)] = v
    assert sorted(got) == sorted(want)
    for name, v in want.items():
        assert got[name].dtype == TDT[dtype], name
        np.testing.assert_array_equal(_f32(got[name]), _f32(v))
    with pytest.raises(ValueError, match="2 encoder and 3 decoder layers "
                                         "given, the config has 2 and 2"):
        E.EncDec(_pair()[1], {"enc_layers": [{}] * 2,
                              "dec_layers": [{}] * 3})
