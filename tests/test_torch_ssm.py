"""The port's Mamba-2 SSD layer and Zamba-2 hybrid
(``repro_torch.models.ssm``, ``hybrid``) against the JAX reference
(``repro.models.ssm``, ``hybrid``) on the CPU, on identical numpy inputs
and the reference's own parameters (carried over by ``convert``).

First the layer: ``ssm_forward``'s chunked path (two chunks) and its
decode path (single steps and a two-token step from the carried state)
against the reference's at mamba2's reduced widths, with one and two
groups, in float32 (2e-4) and bfloat16 (3e-2 + 3e-2 |x|, the LM
tolerance). Then the numeric contracts, one test each (each was checked
to fail on a broken copy of the port's code):

  1. the causal conv: taps summed from tap 0 in the activations' dtype,
     the bias in it, silu in float32; the state the last K-1 raw inputs;
     a decode step with a carried state equal to that column of the full
     conv;
  2. dt and dA in float32 (``F.softplus``'s threshold rounds alike);
     ``A_log``, ``Dp``, ``dt_bias`` float32 in a bf16 model;
  3. the decode recurrence in float32, one step per position, groups
     broadcast to heads by ``repeat_interleave``;
  4. the chunked form: the log decay clamped before ``exp`` (a finite
     gradient), the final state returned, ``S % chunk`` refused by name,
     chunk 16 reduced and 256 full;
  5. the D skip and the gated RMSNorm in the reference's order;
  6. the hybrid: layers past the last site never run, the block input
     ``cat([x, x0]) @ concat_proj``, one set of shared weights and a KV
     cache per site;
  7. the decode state's layout and dtypes (hybrid caches in the config's
     dtype), updated in place;
  8. ``api.prefill``'s quirks: zeroed states (and caches ``S + 8`` long
     for the hybrid, ``max_len`` ignored).

Bit-exact comparisons run the reference op by op (eager ``jnp``), which
rounds each bfloat16 operation as the port does."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.base import get_arch as ref_arch
from repro.models import hybrid as RH
from repro.models import ssm as RS
from repro.models.api import build_model as ref_build
from repro_torch.configs.base import get_arch
from repro_torch.convert import _map, _tensor, lm_params_from_reference
from repro_torch.models import hybrid as H
from repro_torch.models import ssm as S
from repro_torch.models.api import build_model

MAMBA, ZAMBA = "mamba2-1.3b", "zamba2-2.7b"
TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(arch, **kw):
    """The reference's and the port's reduced config of ``arch``; an
    ``ssm`` dict in ``kw`` replaces fields of the SSM spec."""
    spec = kw.pop("ssm", {})
    out = []
    for cfg in (ref_arch(arch).reduced(), get_arch(arch).reduced()):
        cfg = dataclasses.replace(cfg, **kw)
        out.append(dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, **spec)))
    return tuple(out)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _both(x, dtype):
    """A numpy array rounded to ``dtype``, for both packages."""
    xr = jnp.asarray(x, JDT[dtype])
    return xr, torch.from_numpy(np.array(xr.astype(jnp.float32))).to(
        TDT[dtype])


def _layer(rcfg, dtype, seed=0, norm_g=False):
    """The reference's layer parameters and the same leaves as tensors;
    ``norm_g`` draws the gate's scale (the reference inits it to ones)."""
    rp = RS.ssm_init(jax.random.PRNGKey(seed), rcfg, JDT[dtype])
    if norm_g:
        g = np.random.default_rng(seed).uniform(0.5, 1.5, rp["norm_g"].shape)
        rp["norm_g"] = jnp.asarray(g, JDT[dtype])
    return rp, _map(jax.device_get(rp), lambda a: _tensor(a, "cpu"))


def _params(rcfg, pcfg, seed=0):
    rp = ref_build(rcfg).init_params(jax.random.PRNGKey(seed))
    return rp, lm_params_from_reference(jax.device_get(rp), pcfg, "cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the layer against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_forward_matches_the_reference(dtype, groups):
    rcfg, pcfg = _pair(MAMBA, dtype=dtype, ssm=dict(n_groups=groups))
    rp, pp = _layer(rcfg, dtype)
    x = np.random.default_rng(groups).standard_normal((2, 36, rcfg.d_model))
    xr, xt = _both(x, dtype)
    with torch.no_grad():
        want, rst = RS.ssm_forward(rp, rcfg, xr[:, :32])      # two chunks
        got, pst = S.ssm_forward(pp, pcfg, xt[:, :32])
        assert got.dtype == TDT[dtype] and pst[1].dtype == torch.float32
        outs = [(want, got)]
        pst = (pst[0].clone(), pst[1].clone())
        for a, b in ((32, 33), (33, 34), (34, 36)):         # 1, 1, 2 tokens
            want, rst = RS.ssm_forward(rp, rcfg, xr[:, a:b], rst)
            got, pst = S.ssm_forward(pp, pcfg, xt[:, a:b], pst)
            outs.append((want, got))
    for want, got in outs:
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])
    np.testing.assert_allclose(_f32(pst[0]), _f32(rst[0]), **TOL[dtype])
    np.testing.assert_allclose(_f32(pst[1]), _f32(rst[1]), **TOL[dtype])


def test_ssm_decode_matches_the_chunked_forward():
    """``tests/test_models.py:78-99`` for the port: decoding token by
    token from zeroed states equals the chunked forward (5e-2)."""
    cfg = get_arch(MAMBA).reduced()
    api = build_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(2))
    toks = torch.from_numpy(_tokens(cfg, (2, 16), 2))
    with torch.no_grad():
        full = S.lm_forward(params, cfg, toks)[0]
    state = S.init_lm_states(cfg, 2, device="cpu")
    got = []
    for t in range(16):
        logits, state = api.decode_step(params, state, toks[:, t:t + 1], t)
        got.append(logits)
    np.testing.assert_allclose(_f32(torch.stack(got, 1))[..., :cfg.vocab],
                               _f32(full)[..., :cfg.vocab],
                               atol=5e-2, rtol=5e-2)


def test_the_ssm_path_never_reads_hd():
    """mamba2's config has no heads (``cfg.hd`` divides by zero): the
    port builds, runs its forward, prefill and decode without it."""
    cfg = dataclasses.replace(get_arch(MAMBA).reduced(), n_heads=0,
                              n_kv_heads=0, head_dim=None)
    with pytest.raises(ZeroDivisionError):
        cfg.hd
    api = build_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg, (2, 16), 0))
    logits, state = api.prefill(params, {"tokens": toks})
    logits, state = api.decode_step(params, state, toks[:, :1], 16)
    assert logits.shape == (2, cfg.vocab_padded)
    assert bool(torch.isfinite(logits[:, :cfg.vocab]).all())


# ---------------------------------------------------------------------------
# 1. the causal conv
# ---------------------------------------------------------------------------

def _conv_inputs(dtype, S_len=8, C=24, K=4, seed=0):
    rng = np.random.default_rng(seed)
    return (_both(rng.standard_normal((2, S_len, C)), dtype),
            _both(rng.standard_normal((K, C)) * 0.7, dtype),
            _both(rng.standard_normal(C) * 0.3, dtype))


def test_conv_sums_the_taps_from_tap_0_in_the_activations_dtype():
    """bf16: the port's conv output equals the reference's bit for bit;
    summing in float32 instead would not."""
    (xr, xt), (wr, wt), (br, bt) = _conv_inputs("bfloat16")
    want, _ = RS._causal_conv(xr, wr, br)
    got, _ = S._causal_conv(xt, wt, bt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))
    full = torch.cat([xt.new_zeros(2, 3, 24), xt], 1).float()
    wide = sum(full[:, i:i + 8] * wt[i].float() for i in range(4))
    wide = F.silu(wide + bt.float()).to(torch.bfloat16)
    assert not torch.equal(wide, got)


def test_conv_state_is_the_last_raw_inputs():
    """The new state is the last K-1 inputs before the silu, in their
    dtype; with one new token it shifts the carried state by one."""
    (xr, xt), (wr, wt), (br, bt) = _conv_inputs("bfloat16")
    _, st = S._causal_conv(xt, wt, bt)
    assert st.dtype == torch.bfloat16
    assert torch.equal(st, xt[:, -3:])
    _, st1 = S._causal_conv(xt[:, :1], wt, bt, st)
    assert torch.equal(st1, torch.cat([xt[:, -2:], xt[:, :1]], 1))
    _, rst1 = RS._causal_conv(xr[:, :1], wr, br, jnp.asarray(xr[:, -3:]))
    np.testing.assert_array_equal(_f32(st1), _f32(rst1))


def test_conv_decode_with_a_carried_state_equals_the_full_conv():
    (_, xt), (_, wt), (_, bt) = _conv_inputs("bfloat16", S_len=8)
    full, _ = S._causal_conv(xt, wt, bt)
    out, st = S._causal_conv(xt[:, :5], wt, bt)
    cols = [out]
    for t in range(5, 8):
        col, st = S._causal_conv(xt[:, t:t + 1], wt, bt, st)
        cols.append(col)
    assert torch.equal(torch.cat(cols, 1), full)


# ---------------------------------------------------------------------------
# 2. dt and A
# ---------------------------------------------------------------------------

def test_dt_is_a_float32_softplus_and_dA_its_negative_decay():
    """bf16 dt from the projection: softplus of dt + dt_bias in float32
    (arguments from -30 to 40, past ``F.softplus``'s threshold of 20),
    then ``-exp(A_log) * dt``, against the reference's expression."""
    rcfg, _ = _pair(MAMBA, dtype="bfloat16")
    rp, pp = _layer(rcfg, "bfloat16")
    H_ = rp["A_log"].shape[0]
    bias = np.linspace(-3.0, 3.0, H_).astype(np.float32)
    rp["dt_bias"], pp["dt_bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    dtr, dtt = _both(np.linspace(-30, 40, 3 * H_).reshape(1, 3, H_),
                     "bfloat16")
    want = jax.nn.softplus(dtr.astype(jnp.float32) + rp["dt_bias"])
    want_dA = -jnp.exp(rp["A_log"])[None, None, :] * want
    got, got_dA = S._dt_and_decay(pp, dtt)
    assert got.dtype == got_dA.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_dA.numpy(), np.asarray(want_dA),
                               rtol=1e-6, atol=1e-6)
    assert (got_dA <= 0).all() and (got > 20).any() and (got < 1e-3).any()


def test_a_log_dp_and_dt_bias_stay_float32_in_a_bf16_model():
    """Through ``convert`` (each leaf keeps its dtype) and through
    ``init_params`` of both families."""
    for arch in (MAMBA, ZAMBA):
        rcfg, pcfg = _pair(arch, dtype="bfloat16")
        _, pp = _params(rcfg, pcfg)
        mine = build_model(pcfg).init_params(torch.Generator().manual_seed(0))
        for model in (pp, mine):
            leaves = model.layers[0].ssm
            for name in ("A_log", "Dp", "dt_bias"):
                assert leaves[name].dtype == torch.float32, (arch, name)
            for name in ("in_proj", "conv_w", "conv_b", "norm_g",
                         "out_proj"):
                assert leaves[name].dtype == torch.bfloat16, (arch, name)


# ---------------------------------------------------------------------------
# 3. the decode recurrence
# ---------------------------------------------------------------------------

def _scan_inputs(dtype, B=2, S_len=3, H_=4, P=8, N=6, seed=0):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.01, 0.5, (B, S_len, H_)).astype(np.float32)
    dA = -dt * rng.uniform(1, 16, H_).astype(np.float32)
    h = rng.standard_normal((B, H_, P, N)).astype(np.float32)
    xs, Bh, Ch = (_both(rng.standard_normal(s), dtype) for s in
                  ((B, S_len, H_, P), (B, S_len, H_, N), (B, S_len, H_, N)))
    return dt, dA, h, xs, Bh, Ch


def test_decode_recurrence_runs_in_float32_one_step_a_position():
    """bf16 x, B and C with float32 dt, dA and state: the reference's
    ``step`` (``ssm.py:117-124``) rerun over three positions, against
    ``_decode_scan``, within float32 rounding."""
    dt, dA, h, (xr, xt), (Br, Bt), (Cr, Ct) = _scan_inputs("bfloat16")
    a = jnp.exp(jnp.asarray(dA))[..., None, None]
    hr, ys = jnp.asarray(h), []
    for t in range(3):
        hr = a[:, t] * hr + (jnp.asarray(dt)[:, t, :, None, None]
                             * xr[:, t, :, :, None] * Br[:, t, :, None, :])
        ys.append(jnp.einsum("bhpn,bhn->bhp", hr, Cr[:, t]))
    y, hT = S._decode_scan(torch.from_numpy(h), torch.from_numpy(dt),
                           torch.from_numpy(dA), xt, Bt, Ct)
    assert y.dtype == hT.dtype == torch.float32 and y.shape == (2, 3, 4, 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(jnp.stack(ys, 1)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hT.numpy(), np.asarray(hr), rtol=1e-5,
                               atol=1e-6)


def test_groups_broadcast_to_heads_by_repeat_not_tile():
    """Two groups over eight heads: heads 0-3 read group 0 (``jnp.repeat``);
    tiling would give heads 0, 2, 4, 6 group 0. Chunked and decode paths
    against the reference at ``n_groups = 2``."""
    rcfg, pcfg = _pair(MAMBA, dtype="float32", ssm=dict(n_groups=2))
    assert S.dims(pcfg)[1] == 8
    rp, pp = _layer(rcfg, "float32", seed=3)
    x = np.random.default_rng(3).standard_normal((1, 17, rcfg.d_model))
    xr, xt = _both(x, "float32")
    with torch.no_grad():
        want, rst = RS.ssm_forward(rp, rcfg, xr[:, :16])
        got, pst = S.ssm_forward(pp, pcfg, xt[:, :16])
        want1, _ = RS.ssm_forward(rp, rcfg, xr[:, 16:], rst)
        got1, _ = S.ssm_forward(pp, pcfg, xt[:, 16:], pst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1),
                               **TOL["float32"])


# ---------------------------------------------------------------------------
# 4. the chunked form
# ---------------------------------------------------------------------------

def _chunk_inputs(S_len, seed=0, decay=1.0):
    rng = np.random.default_rng(seed)
    B, H_, P, N = 2, 3, 4, 5
    dt = rng.uniform(0.05, 0.5, (B, S_len, H_)).astype(np.float32)
    dA = (-dt * rng.uniform(1, 16, H_) * decay).astype(np.float32)
    xs, Bh, Ch = (rng.standard_normal(s).astype(np.float32) for s in
                  ((B, S_len, H_, P), (B, S_len, H_, N), (B, S_len, H_, N)))
    return xs, Bh, Ch, dt, dA


def test_chunked_ssd_matches_the_reference_and_returns_the_final_state():
    """Three chunks of 16 from a zero state: y and the final state against
    ``repro.models.ssm._chunked_ssd``; the final state equals the
    recurrence run step by step from zero."""
    ins = _chunk_inputs(48)
    want_y, want_h = RS._chunked_ssd(*map(jnp.asarray, ins), 16)
    got_y, got_h = S._chunked_ssd(*map(torch.from_numpy, ins), 16)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-5,
                               atol=1e-5)
    xs, Bh, Ch, dt, dA = map(torch.from_numpy, ins)
    y, h = S._decode_scan(torch.zeros(2, 3, 4, 5), dt, dA, xs, Bh, Ch)
    np.testing.assert_allclose(got_h.numpy(), h.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got_y.numpy(), y.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_chunked_log_decay_is_clamped_before_exp():
    """Steep decays make the log decay above the diagonal large and
    positive: unclamped, ``exp`` overflows there and the gradient through
    the zeroing ``where`` is 0 * inf = NaN. Clamped, it is finite, and the
    forward still equals the reference's."""
    ins = _chunk_inputs(32, seed=1, decay=40.0)
    xs, Bh, Ch, dt, dA = map(torch.from_numpy, ins)
    dA.requires_grad_(True)
    y, h = S._chunked_ssd(xs, Bh, Ch, dt, dA, 16)
    (grad,) = torch.autograd.grad(y.sum() + h.sum(), dA)
    assert bool(torch.isfinite(grad).all())
    assert float(-dA.detach().reshape(2, 2, 16, 3).sum(2).min()) > 100
    want_y, _ = RS._chunked_ssd(*map(jnp.asarray, ins), 16)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-5)


def test_a_sequence_not_a_multiple_of_the_chunk_is_refused_by_name():
    """The reference asserts; the port raises ``ValueError`` naming both
    numbers."""
    ins = map(torch.from_numpy, _chunk_inputs(17))
    with pytest.raises(ValueError, match="17 is not a multiple of the "
                                         "chunk 16"):
        S._chunked_ssd(*ins, 16)
    cfg = get_arch(MAMBA).reduced()
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="chunk 16"):
        S.lm_forward(params, cfg, torch.zeros(1, 20, dtype=torch.int32))


def test_the_chunk_is_16_reduced_and_256_full():
    for arch in (MAMBA, ZAMBA):
        assert get_arch(arch).ssm.chunk == ref_arch(arch).ssm.chunk == 256
        assert get_arch(arch).reduced().ssm.chunk == 16


# ---------------------------------------------------------------------------
# 5. the D skip and the gated RMSNorm
# ---------------------------------------------------------------------------

def test_skip_and_gated_rmsnorm_follow_the_reference_order():
    """bf16, a drawn ``norm_g``: ``ssm.py:125-132`` rerun on the same
    arrays equals ``_skip_and_gate`` bit for bit (the skip in float32,
    the cast, the gate, the norm in float32, the cast, then g)."""
    rcfg, _ = _pair(MAMBA, dtype="bfloat16")
    rp, pp = _layer(rcfg, "bfloat16", norm_g=True)
    rng = np.random.default_rng(5)
    dI, H_, _, _ = RS.dims(rcfg)
    P = rcfg.ssm.head_dim
    y = rng.standard_normal((2, 3, H_, P)).astype(np.float32)
    rp["Dp"] = jnp.asarray(rng.uniform(0.5, 2, H_), jnp.float32)
    pp["Dp"] = torch.from_numpy(np.array(rp["Dp"]))
    (xr, xt), (zr, zt) = (_both(rng.standard_normal(s), "bfloat16")
                          for s in ((2, 3, H_, P), (2, 3, dI)))
    want = jnp.asarray(y) + rp["Dp"][None, None, :, None] * xr.astype(
        jnp.float32)
    want = want.reshape(2, 3, dI).astype(jnp.bfloat16)
    want = want * jax.nn.silu(zr.astype(jnp.float32)).astype(want.dtype)
    wf = want.astype(jnp.float32)
    want = (wf * jax.lax.rsqrt(jnp.mean(wf * wf, -1, keepdims=True) + 1e-5)
            ).astype(jnp.bfloat16) * rp["norm_g"]
    got = S._skip_and_gate(pp, torch.from_numpy(y), xt, zt, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))


# ---------------------------------------------------------------------------
# 6. the hybrid's structure
# ---------------------------------------------------------------------------

def test_hybrid_never_runs_the_layers_past_the_last_site():
    """n_layers 5, share_every 2: two sites run layers 0-3; layer 4's
    parameters change nothing, its state stays zero, and the states
    returned are the four layers' (as the reference's)."""
    rcfg, pcfg = _pair(ZAMBA, dtype="float32", n_layers=5)
    assert H.n_shared_sites(pcfg) == 2
    rp, pp = _params(rcfg, pcfg)
    toks = _tokens(rcfg, (2, 16), 4)
    want = RH.forward(rp, rcfg, jnp.asarray(toks))[0]
    with torch.no_grad():
        got = H.forward(pp, pcfg, torch.from_numpy(toks))[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL["float32"])
        for t in pp.layers[4].parameters():
            t.add_(1.0)
        again = H.forward(pp, pcfg, torch.from_numpy(toks))[0]
        assert torch.equal(again, got)
        state = H.init_decode_state(pcfg, 2, 4, device="cpu")
        _, (ns, nc), _ = H.forward(pp, pcfg, torch.from_numpy(toks[:, :1]),
                                   *state, cache_len=0)
    rstate = RH.init_decode_state(rcfg, 2, 4)
    _, (rns, _), _ = RH.forward(rp, rcfg, jnp.asarray(toks[:, :1]), *rstate,
                                cache_len=jnp.asarray(0, jnp.int32))
    assert ns[0].shape == rns[0].shape and ns[1].shape[0] == 4
    assert not state[0][1][4].any() and state[0][1][3].any()


def test_shared_block_input_is_the_hidden_state_beside_the_embedding():
    """``cat([x, x0]) @ concat_proj``, then attention on ``rmsnorm(h,
    ln1)`` and the GELU MLP, each added to h, and ``x + h``: the port's
    ``SharedBlock`` against ``hybrid._shared_block`` without and with a
    cache."""
    rcfg, pcfg = _pair(ZAMBA, dtype="float32")
    rp, pp = _params(rcfg, pcfg)
    rng = np.random.default_rng(6)
    x, x0 = (rng.standard_normal((2, 5, rcfg.d_model)).astype(np.float32)
             for _ in range(2))
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    want, _ = RH._shared_block(rcfg, rp["shared"], jnp.asarray(x),
                               jnp.asarray(x0), jnp.asarray(pos), None, None)
    with torch.no_grad():
        got, _ = pp.shared(torch.from_numpy(x), torch.from_numpy(x0),
                           torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])
    shape = (2, 8, rcfg.n_kv_heads, rcfg.hd)
    rc = (jnp.zeros(shape), jnp.zeros(shape))
    pc = (torch.zeros(shape), torch.zeros(shape))
    want, _ = RH._shared_block(rcfg, rp["shared"], jnp.asarray(x),
                               jnp.asarray(x0), jnp.asarray(pos + 2), rc,
                               jnp.asarray(2, jnp.int32))
    with torch.no_grad():
        got, _ = pp.shared(torch.from_numpy(x), torch.from_numpy(x0),
                           torch.from_numpy(pos + 2), pc, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


def test_each_site_keeps_its_own_cache_with_one_set_of_weights():
    """Two sites share one ``SharedBlock``; after three decode steps each
    site's k and v caches equal the reference's for that site, and the
    two sites' differ."""
    rcfg, pcfg = _pair(ZAMBA, dtype="float32")
    rp, pp = _params(rcfg, pcfg)
    assert sum(isinstance(m, H.SharedBlock) for m in pp.modules()) == 1
    toks = _tokens(rcfg, (2, 3), 7)
    rstate = RH.init_decode_state(rcfg, 2, 6)
    pstate = H.init_decode_state(pcfg, 2, 6, device="cpu")
    rapi, papi = ref_build(rcfg), build_model(pcfg)
    for t in range(3):
        _, rstate = rapi.decode_step(rp, rstate, jnp.asarray(toks[:, t:t + 1]),
                                     jnp.asarray(t, jnp.int32))
        _, pstate = papi.decode_step(pp, pstate, torch.from_numpy(
            toks[:, t:t + 1]), t)
    for i in range(2):
        np.testing.assert_allclose(pstate[1][i].numpy(),
                                   np.asarray(rstate[1][i]),
                                   **TOL["float32"])
    assert not torch.allclose(pstate[1][0][0], pstate[1][0][1])


# ---------------------------------------------------------------------------
# 7. the decode state's layout, dtypes and in-place updates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_state_layout_and_dtypes_follow_the_reference(dtype):
    """SSM states (L, B, K-1, convd) in the config's dtype and (L, B, H,
    P, N) float32; the hybrid's caches (sites, B, max_len, n_kv, hd) in
    the config's dtype (float32 in a float32 config, unlike the
    transformer's bf16 default)."""
    rcfg, pcfg = _pair(MAMBA, dtype=dtype)
    want = RS.init_lm_states(rcfg, 3)
    got = S.init_lm_states(pcfg, 3, device="cpu")
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape and _f32(g).sum() == 0
    assert got[0].dtype == TDT[dtype] and got[1].dtype == torch.float32
    rcfg, pcfg = _pair(ZAMBA, dtype=dtype)
    (rst, rkv) = RH.init_decode_state(rcfg, 3, 10)
    (pst, pkv) = H.init_decode_state(pcfg, 3, 10, device="cpu")
    for w, g in zip(rst + rkv, pst + pkv):
        assert tuple(g.shape) == w.shape
        assert g.dtype == TDT[str(w.dtype)]
    assert pkv[0].dtype == pkv[1].dtype == TDT[dtype]
    assert pkv[0].shape == (2, 3, 10, pcfg.n_kv_heads, pcfg.hd)


def test_decode_writes_states_and_caches_in_place():
    """``decode_step`` returns the caller's tensors, overwritten."""
    for arch in (MAMBA, ZAMBA):
        cfg = get_arch(arch).reduced()
        api = build_model(cfg)
        params = api.init_params(torch.Generator().manual_seed(0))
        if cfg.family == "ssm":
            state = S.init_lm_states(cfg, 2, device="cpu")
            tensors = list(state)
        else:
            state = H.init_decode_state(cfg, 2, 4, device="cpu")
            tensors = list(state[0]) + list(state[1])
        ptrs = [t.data_ptr() for t in tensors]
        _, new = api.decode_step(params, state, torch.ones(2, 1, dtype=int),
                                 0)
        flat = list(new) if cfg.family == "ssm" else list(new[0]) + list(
            new[1])
        assert [t.data_ptr() for t in flat] == ptrs
        assert all(bool(t.any()) for t in tensors[1:]), arch


# ---------------------------------------------------------------------------
# 8. api.prefill as the reference does it
# ---------------------------------------------------------------------------

def test_ssm_prefill_returns_zeroed_states():
    """The chunked forward's last logits, and the states zeroed, not the
    prompt's (``api.py:126-132``)."""
    rcfg, pcfg = _pair(MAMBA, dtype="float32")
    rp, pp = _params(rcfg, pcfg)
    toks = _tokens(rcfg, (2, 16), 8)
    want, rst = ref_build(rcfg).prefill(rp, {"tokens": jnp.asarray(toks)})
    got, pst = build_model(pcfg).prefill(pp, {"tokens": torch.from_numpy(
        toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])
    for w, g in zip(rst, pst):
        assert tuple(g.shape) == w.shape and not g.any()
    _, prompt_state = S.ssm_forward(pp.layers[0].ssm, pcfg, pp.embed[
        torch.from_numpy(toks).long()])
    assert prompt_state[1].any()


def test_hybrid_prefill_returns_zeroed_states_and_caches_s_plus_8_long():
    """``api.py:167-171``: zeroed states and caches ``S + 8`` long
    whatever ``max_len`` says."""
    rcfg, pcfg = _pair(ZAMBA, dtype="float32")
    rp, pp = _params(rcfg, pcfg)
    toks = _tokens(rcfg, (2, 16), 9)
    want, (rst, rkv) = ref_build(rcfg).prefill(rp, {"tokens": jnp.asarray(
        toks)})
    got, (pst, pkv) = build_model(pcfg).prefill(pp, {
        "tokens": torch.from_numpy(toks), "max_len": 40})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])
    for w, g in zip(rst + rkv, pst + pkv):
        assert tuple(g.shape) == w.shape and not g.any()
    assert pkv[0].shape[2] == 16 + 8
