"""The port's LM (``repro_torch.models``) against the JAX reference
(``repro.models``) on the CPU, from the reference's own parameters
(``api.init_params(PRNGKey(0))``, carried over by
``repro_torch.convert.lm_params_from_reference``) and the same numpy
tokens: ``transformer.forward``, ``api.loss``, ``api.prefill`` and
``api.decode_step`` on the reduced dense, moe, vlm, ssm, hybrid and audio
archs, in float32 and bfloat16, with ``attention_impl`` "full" and
"chunked" (a chunk below the sequence, so the reference's chunked branch
runs; the port takes one path; mamba2 has no attention and whisper's
``_attn_cfg`` passes no ``impl``, so both take "full" only). The vlm's
forward, loss and prefill take patch embeddings, and whisper's its
frames, drawn from a seeded normal at scale 0.02, so that they show in
the result. The forward is ``transformer.forward``, ``ssm.lm_forward``,
``hybrid.forward`` or whisper's ``encode`` then ``decode`` by family.
Whisper's ``prefill`` allocates caches exactly S long, so its decode
steps start from the encoder's output and caches ``MAX_LEN`` long that
one ``decode`` call over the prompt has written.

The MoE archs' reference runs op by op (``jax.disable_jit``), as the
port does: jitted, XLA fuses a layer's bfloat16 elementwise chain and
rounds it once, which moves a router input by a bfloat16 ulp and, at a
near tie of the k-th and (k+1)-th probabilities, sends a token to another
expert (a different function, not a rounding error). Op by op the two
packages route alike, and the MoE archs' decode steps drop pairs (C = 1).

Tolerances: float32 logits within 2e-4 and the loss within 1e-5
relative; prefill and decode attend over the KV caches, which are
bfloat16 in both packages whatever the config's dtype, so a float32
k or v that rounds the other way there moves the logits: 3e-2 (the
reference's own decode tolerance, ``tests/test_models.py:73-75``), as
for everything in bfloat16. The ssm, hybrid and audio families keep
float32 states or caches in a float32 config, so their float32 prefill
and decode are held to the forward's 2e-4. Then one test per reference
quirk the port keeps."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as ref_arch
from repro.models import encdec as RE
from repro.models import hybrid as RH
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro.models.api import build_model as ref_build
from repro_torch.configs.base import get_arch
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import encdec as E
from repro_torch.models import hybrid as H
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.api import build_model

DENSE = ["minicpm-2b", "qwen1.5-4b", "yi-9b", "internlm2-20b"]
MOE = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e"]
VLM = ["internvl2-76b"]
SSM_ARCHS = ["mamba2-1.3b"]                 # no attention: one impl
HYBRID = ["zamba2-2.7b"]
AUDIO = ["whisper-base"]                    # one attention path: one impl
B, S, MAX_LEN, STEPS = 2, 16, 20, 3
CHUNK = 8                      # below S: the reference's chunked branch runs
LOOSE = dict(atol=3e-2, rtol=3e-2)
TOL = {("float32", "forward"): dict(atol=2e-4, rtol=2e-4),
       ("float32", "loss"): dict(atol=0.0, rtol=1e-5)}


def _tol(arch, dtype, what):
    if (dtype == "float32" and arch in SSM_ARCHS + HYBRID + AUDIO
            and what in ("prefill", "decode")):
        return TOL["float32", "forward"]
    return TOL.get((dtype, what), LOOSE)


def _pair(arch, **kw):
    """The reference's and the port's reduced config, with ``kw``."""
    return (dataclasses.replace(ref_arch(arch).reduced(), **kw),
            dataclasses.replace(get_arch(arch).reduced(), **kw))


def _params(rcfg, pcfg):
    rp = ref_build(rcfg).init_params(jax.random.PRNGKey(0))
    return rp, lm_params_from_reference(jax.device_get(rp), pcfg, "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _patches(rcfg, seed):
    """A vlm's stub patch embeddings or whisper's stub frames (the
    reference's tests pass zeros): a seeded normal at 0.02, in the
    config's dtype."""
    if rcfg.family == "vlm":
        key, n = "patches", rcfg.n_patches
    elif rcfg.family == "audio":
        key, n = "frames", rcfg.encdec.enc_len
    else:
        return {}, {}
    x = np.random.default_rng(seed).standard_normal(
        (B, n, rcfg.d_model)) * 0.02
    x = np.array(jnp.asarray(x, rcfg.jdtype).astype(jnp.float32))
    return ({key: jnp.asarray(x, rcfg.jdtype)},
            {key: torch.from_numpy(x).to(getattr(torch, rcfg.dtype))})


def _run(arch, dtype, impl):
    rcfg, pcfg = _pair(arch, dtype=dtype, attention_impl=impl,
                       attention_chunk=CHUNK)
    rapi, papi = ref_build(rcfg), build_model(pcfg)
    rp, pp = _params(rcfg, pcfg)
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, rcfg.vocab, (B, S + STEPS)).astype(np.int32)
    prompt, tgt = toks[:, :S], rng.integers(0, rcfg.vocab, (B, S))
    tgt = tgt.astype(np.int32)
    rpat, ppat = _patches(rcfg, len(arch))
    Pn = rcfg.n_patches if "patches" in rpat else 0
    out = {}
    with contextlib.ExitStack() as ref_mode, torch.no_grad():
        if rcfg.family == "moe":
            ref_mode.enter_context(jax.disable_jit())
        if rcfg.family == "ssm":
            ref_fwd, port_fwd = RS.lm_forward, SSM.lm_forward
        elif rcfg.family == "hybrid":
            ref_fwd, port_fwd = RH.forward, H.forward
        elif rcfg.family == "audio":
            ref_fwd = lambda p, c, t: RE.decode(  # noqa: E731
                p, c, t, RE.encode(p, c, rpat["frames"]))
            port_fwd = lambda p, c, t: E.decode(  # noqa: E731
                p, c, t, E.encode(p, c, ppat["frames"]))
        else:
            ref_fwd = lambda p, c, t: RT.forward(  # noqa: E731
                p, c, tokens=t, embeds=rpat.get("patches"))
            port_fwd = lambda p, c, t: T.forward(  # noqa: E731
                p, c, t, embeds=ppat.get("patches"))
        out["forward"] = (ref_fwd(rp, rcfg, jnp.asarray(prompt))[0],
                          port_fwd(pp, pcfg, torch.from_numpy(prompt))[0])
        out["loss"] = (
            rapi.loss(rp, {"tokens": jnp.asarray(prompt),
                           "targets": jnp.asarray(tgt), **rpat})[0],
            papi.loss(pp, {"tokens": torch.from_numpy(prompt),
                           "targets": torch.from_numpy(tgt), **ppat})[0])
        rl, rs = rapi.prefill(rp, {"tokens": jnp.asarray(prompt),
                                   "max_len": MAX_LEN + Pn, **rpat})
        pl, ps = papi.prefill(pp, {"tokens": torch.from_numpy(prompt),
                                   "max_len": MAX_LEN + Pn, **ppat})
        out["prefill"] = (rl, pl)
        if rcfg.family == "audio":
            renc, penc = rs[0], ps[0]
            _, rc, _ = RE.decode(rp, rcfg, jnp.asarray(prompt), renc,
                                 RE.init_caches(rcfg, B, MAX_LEN),
                                 jnp.zeros((), jnp.int32))
            _, pc, _ = E.decode(pp, pcfg, torch.from_numpy(prompt), penc,
                                E.init_caches(pcfg, B, MAX_LEN, "cpu"), 0)
            rs, ps = (renc, rc), (penc, pc)
        decode = jax.jit(rapi.decode_step)
        rsteps, psteps = [], []
        for t in range(S, S + STEPS):
            tok = toks[:, t:t + 1]
            rl, rs = decode(rp, rs, jnp.asarray(tok),
                            jnp.asarray(Pn + t, jnp.int32))
            pl, ps = papi.decode_step(pp, ps, torch.from_numpy(tok), Pn + t)
            rsteps.append(rl)
            psteps.append(pl)
        out["decode"] = (jnp.stack(rsteps, 1), torch.stack(psteps, 1))
    return out


@pytest.fixture(scope="module")
def runs():
    done = {}

    def get(arch, dtype, impl):
        if (arch, dtype, impl) not in done:
            done[arch, dtype, impl] = _run(arch, dtype, impl)
        return done[arch, dtype, impl]
    return get


@pytest.mark.parametrize("arch,dtype,impl,what", [
    (arch, dtype, impl, what)
    for arch in DENSE + MOE + VLM + SSM_ARCHS + HYBRID + AUDIO
    for dtype in ("float32", "bfloat16")
    for impl in (("full",) if arch in SSM_ARCHS + AUDIO
                 else ("full", "chunked"))
    for what in ("forward", "loss", "prefill", "decode")])
def test_port_matches_the_reference(runs, arch, dtype, impl, what):
    ref, got = runs(arch, dtype, impl)[what]
    assert tuple(got.shape) == tuple(ref.shape)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         and what != "loss" else torch.float32)
    np.testing.assert_allclose(_f32(got), _f32(ref),
                               **_tol(arch, dtype, what))


def test_decode_matches_the_full_forward():
    """The port's own cache check, as ``tests/test_models.py:53`` makes it
    for the reference: decoding token by token equals the causal forward."""
    cfg = get_arch("yi-9b").reduced()
    api = build_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(1))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    with torch.no_grad():
        full = T.forward(params, cfg, toks)[0]
    state = T.init_caches(cfg, 2, 14, device="cpu")
    got = []
    for t in range(12):
        logits, state = api.decode_step(params, state, toks[:, t:t + 1], t)
        got.append(logits)
    np.testing.assert_allclose(_f32(torch.stack(got, 1)), _f32(full), **LOOSE)


# ---------------------------------------------------------------------------
# the reference's quirks, kept
# ---------------------------------------------------------------------------

def test_bf16_cache_in_a_float32_config():
    """``init_caches`` defaults to bfloat16 and nothing passes a dtype, so
    a float32 model attends over bf16-rounded k and v. With those caches
    the port meets the reference to float32 rounding; with float32 caches
    it would not."""
    rcfg, pcfg = _pair("minicpm-2b", dtype="float32")
    rp, pp = _params(rcfg, pcfg)
    toks = np.random.default_rng(0).integers(0, rcfg.vocab, (2, 8))
    toks = toks.astype(np.int32)
    ref, _ = ref_build(rcfg).prefill(rp, {"tokens": jnp.asarray(toks),
                                          "max_len": 12})
    assert T.init_caches(pcfg, 2, 12, device="cpu")[0].dtype == torch.bfloat16
    got, state = build_model(pcfg).prefill(pp, {"tokens": torch.from_numpy(
        toks), "max_len": 12})
    assert state[0].dtype == state[1].dtype == torch.bfloat16
    assert got.dtype == torch.float32
    f32_caches = T.init_caches(pcfg, 2, 12, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        wide = T.forward(pp, pcfg, torch.from_numpy(toks), f32_caches)[0]
    err = np.abs(_f32(got) - _f32(ref)).max()
    err_wide = np.abs(_f32(wide[:, -1]) - _f32(ref)).max()
    assert err < 1e-5 and err_wide > 1e-4, (err, err_wide)


def test_kv_heads_are_repeated_not_tiled():
    """``jnp.repeat(k, group, axis=2)``: each kv head ``group`` times in a
    row, as ``repeat_interleave`` gives and ``Tensor.repeat`` does not."""
    x = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    got = L.repeat_kv(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.repeat(x, 2, axis=2)))
    assert not np.array_equal(got, np.tile(x, (1, 1, 2, 1)))
    cfg = get_arch("yi-9b").reduced()
    assert cfg.n_heads // cfg.n_kv_heads == 2     # the parity runs' GQA case


def test_minicpm_scales_its_tied_embedding():
    """``x * sqrt(d_model)`` after the lookup, only for tied embeddings and
    an ``arch_id`` starting with "minicpm": the same weights under another
    name give other logits, and the port follows the reference in both."""
    rcfg, pcfg = _pair("minicpm-2b", dtype="float32")
    tree = jax.device_get(ref_build(rcfg).init_params(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(2).integers(0, rcfg.vocab, (2, 6))
    toks = toks.astype(np.int32)
    logits = {}
    for name in ("minicpm-2b", "llama-like"):
        rc = dataclasses.replace(rcfg, arch_id=name)
        pc = dataclasses.replace(pcfg, arch_id=name)
        pp = lm_params_from_reference(tree, pc, "cpu")
        ref = RT.forward(tree, rc, tokens=jnp.asarray(toks))[0]
        with torch.no_grad():
            got = T.forward(pp, pc, torch.from_numpy(toks))[0]
        np.testing.assert_allclose(_f32(got), _f32(ref), atol=2e-4,
                                   rtol=2e-4)
        logits[name] = _f32(got)
    assert np.abs(logits["minicpm-2b"] - logits["llama-like"]).max() > 0.1


def test_prefill_logits_are_unmasked():
    """``prefill`` returns ``logits[:, -1]`` with the padded vocab columns
    as they are; ``decode_step`` masks them to -1e30."""
    rcfg, pcfg = _pair("yi-9b", dtype="float32", vocab=250)
    assert pcfg.vocab_padded == 256
    rp, pp = _params(rcfg, pcfg)
    toks = np.random.default_rng(3).integers(0, 250, (2, 5)).astype(np.int32)
    ref, _ = ref_build(rcfg).prefill(rp, {"tokens": jnp.asarray(toks)})
    api = build_model(pcfg)
    got, state = api.prefill(pp, {"tokens": torch.from_numpy(toks),
                                  "max_len": 6})
    pad = _f32(got)[:, 250:]
    assert np.all(np.isfinite(pad)) and np.all(np.abs(pad) < 1e3)
    np.testing.assert_allclose(pad, _f32(ref)[:, 250:], **LOOSE)
    dec, _ = api.decode_step(pp, state, torch.from_numpy(toks[:, :1]), 5)
    assert np.all(_f32(dec)[:, 250:] <= -1e29)
    assert np.all(_f32(dec)[:, :250] > -1e29)
