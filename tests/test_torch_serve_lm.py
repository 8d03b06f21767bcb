"""``repro_torch.launch.serve_lm`` against ``repro.launch.serve_lm`` on the
CPU: from the reference's own parameters in float32, the port's greedy
tokens equal the reference loop's (whose first row's sample the
reference ``main`` itself prints) for dense, moe, vlm, ssm, hybrid and
audio archs (a vlm is served on tokens only, whisper on the stub
frontend's frames, as the reference serves them), each from its family's
decode state; and the port's ``main`` runs here with ``--device cpu``,
through the flash kernel's plain version once per attention and step,
and refuses the card where there is none."""
import ast
import dataclasses
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve_lm as ref_serve_lm
from repro.configs.base import get_arch as ref_arch
from repro.data.pipeline import stub_frames
from repro.models import encdec as RE
from repro.models.api import build_model as ref_build
from repro_torch.configs.base import get_arch
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve, serve_lm
from repro_torch.models import ModelAPI, build_model

BATCH, PROMPT, GEN = 4, 32, 16           # serve_lm's defaults


def _reference_generate(api, params, tokens, gen):
    """The reference driver's loop (``src/repro/launch/serve_lm.py``,
    ``main`` from the decode state to the stacked generations; whisper's
    state built where ``main`` builds it)."""
    cfg = api.cfg
    B, S = tokens.shape
    if cfg.family == "audio":
        frames = jnp.asarray(stub_frames(B, cfg.encdec.enc_len, cfg.d_model)
                             ).astype(cfg.jdtype)
        state = (RE.encode(params, cfg, frames),
                 RE.init_caches(cfg, B, S + gen + 1))
    else:
        state = ref_serve_lm.init_decode_state(cfg, api, B, S + gen + 1,
                                               None)
    decode = jax.jit(api.decode_step)
    cache_len, logits = jnp.zeros((), jnp.int32), None
    for t in range(S):
        logits, state = decode(params, state, tokens[:, t:t + 1], cache_len)
        cache_len = cache_len + 1
    out = []
    cur = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for _ in range(gen):
        out.append(np.asarray(cur)[:, 0])
        logits, state = decode(params, state, cur, cache_len)
        cache_len = cache_len + 1
        cur = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    return np.stack(out, 1)


@pytest.mark.parametrize("arch", ["minicpm-2b", "yi-9b",
                                  "granite-moe-3b-a800m", "internvl2-76b",
                                  "mamba2-1.3b", "zamba2-2.7b",
                                  "whisper-base"])
def test_greedy_tokens_equal_the_reference(arch, monkeypatch, capsys):
    f32 = lambda a: dataclasses.replace(ref_arch(a), dtype="float32")  # noqa
    rcfg = f32(arch).reduced()
    pcfg = dataclasses.replace(get_arch(arch), dtype="float32").reduced()
    rapi = ref_build(rcfg)
    rp = rapi.init_params(jax.random.PRNGKey(0))
    prompt = np.random.default_rng(0).integers(
        0, rcfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    want = _reference_generate(rapi, rp, jnp.asarray(prompt), GEN)

    # the reference main, seed 0, float32: its printed sample is row 0's
    monkeypatch.setattr(ref_serve_lm, "get_arch", f32)
    monkeypatch.setattr(sys, "argv", ["serve_lm", "--arch", arch,
                                      "--reduced"])
    ref_serve_lm.main()
    printed = re.search(r"sample generations \(token ids\): (\[.*\])",
                        capsys.readouterr().out)
    assert printed
    assert ast.literal_eval(printed.group(1)) == want[0][:12].tolist()

    pp = lm_params_from_reference(jax.device_get(rp), pcfg, "cpu")
    with torch.inference_mode():
        got = serve_lm.generate(build_model(pcfg), pp,
                                torch.from_numpy(prompt), GEN)
    np.testing.assert_array_equal(got["tokens"], want)


def test_main_serves_on_the_cpu_through_the_flash_wrapper(capsys):
    before = (fa.launches, fa.plain_calls)
    res = serve_lm.main(["--arch", "minicpm-2b", "--reduced",
                         "--device", "cpu"])
    cfg = res["cfg"]
    assert res["tokens"].shape == (BATCH, GEN)
    assert res["tokens"].min() >= 0 and res["tokens"].max() < cfg.vocab
    assert res["logits"].shape == (BATCH, cfg.vocab_padded)
    assert bool(torch.isfinite(res["logits"]).all())
    np.testing.assert_array_equal(
        res["prompt"].numpy(), np.random.default_rng(0).integers(
            0, cfg.vocab, (BATCH, PROMPT)))
    # one attention per layer and decode step: the prompt's 32, then 16
    assert (fa.launches, fa.plain_calls) == (
        before[0], before[1] + cfg.n_layers * (PROMPT + GEN))
    out = capsys.readouterr().out
    assert "[serve] arch=minicpm-2b batch=4 prompt=32 gen=16" in out
    assert "ms/token/batch" in out


@pytest.mark.parametrize("arch,sites", [("mamba2-1.3b", 0),
                                        ("zamba2-2.7b", 2)])
def test_main_serves_ssm_and_hybrid_on_the_cpu(arch, sites):
    """mamba2 runs no attention; the reduced zamba2's two shared-block
    sites call the flash wrapper's plain version once a step each."""
    before = (fa.launches, fa.plain_calls)
    res = serve_lm.main(["--arch", arch, "--reduced", "--device", "cpu"])
    cfg = res["cfg"]
    assert res["tokens"].shape == (BATCH, GEN)
    assert res["tokens"].min() >= 0 and res["tokens"].max() < cfg.vocab
    assert bool(torch.isfinite(res["logits"][:, :cfg.vocab]).all())
    assert (fa.launches, fa.plain_calls) == (
        before[0], before[1] + sites * (PROMPT + GEN))
    states = res["state"] if cfg.family == "ssm" else res["state"][0]
    assert states[1].dtype == torch.float32 and bool(states[1].any())


def test_main_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        serve_lm.main(["--arch", "minicpm-2b", "--reduced"])


def test_main_serves_whisper_on_the_cpu():
    """The encoder's flash call once a layer in the prefill, then the
    decoder's self- and cross-attention once a layer and step each; the
    caches in the config's dtype, ``S + gen + 1`` long, beside the
    encoder's output over the stub frames."""
    before = (fa.launches, fa.plain_calls)
    res = serve_lm.main(["--arch", "whisper-base", "--reduced",
                         "--device", "cpu"])
    cfg = res["cfg"]
    assert res["tokens"].shape == (BATCH, GEN)
    assert res["tokens"].min() >= 0 and res["tokens"].max() < cfg.vocab
    assert bool(torch.isfinite(res["logits"]).all())
    assert (fa.launches, fa.plain_calls) == (
        before[0], before[1] + cfg.encdec.n_enc_layers
        + 2 * cfg.n_layers * (PROMPT + GEN))
    enc_out, caches = res["state"]
    assert enc_out.shape == (BATCH, cfg.encdec.enc_len, cfg.d_model)
    assert caches[0].shape == (cfg.n_layers, BATCH, PROMPT + GEN + 1,
                               cfg.n_kv_heads, cfg.hd)
    assert caches[0].dtype == cfg.torch_dtype
    with pytest.raises(ValueError, match="audio"):
        serve_lm.init_decode_state(cfg, BATCH, 8, "cpu")


def test_main_refuses_a_family_not_ported_by_name(monkeypatch):
    """Every family of the configs is ported; a family the builder does
    not know raises ``ValueError`` naming it, before any weight is made."""
    cfg = dataclasses.replace(get_arch("minicpm-2b").reduced(),
                              family="speech")
    monkeypatch.setattr(serve_lm, "get_arch", lambda arch: cfg)
    with pytest.raises(ValueError, match="speech"):
        serve_lm.main(["--arch", "minicpm-2b", "--device", "cpu"])


def test_generate_refuses_a_padded_vocab_token():
    cfg = dataclasses.replace(get_arch("yi-9b").reduced(), vocab=250)

    def leaky(params, state, tokens, cache_len):
        logits = torch.zeros(tokens.shape[0], cfg.vocab_padded)
        logits[:, cfg.vocab_padded - 1] = 1.0
        return logits, state

    api = ModelAPI(cfg, None, None, None, leaky)
    with pytest.raises(RuntimeError, match="padded-vocab leak"):
        serve_lm.generate(api, None, torch.zeros(2, 3, dtype=torch.int32), 2)


def test_serve_is_an_alias_of_serve_lm():
    assert serve.main is serve_lm.main
    assert serve.generate is serve_lm.generate
