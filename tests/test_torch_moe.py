"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
reference (``repro.models.moe``) on the CPU, on identical numpy inputs and
the reference's own parameters (``moe_init(PRNGKey(0))``).

``moe_apply`` is held to the reference's at granite's and llama4's
reduced specs (4 experts, top-2; top-1 with a shared expert), in float32
and bfloat16, at N = 32 tokens (C = 20 for granite), N = 2 (C = 1: the
second token repeats the first, so it finds its experts full) and with
``capacity_factor`` 8 (no drop, so the layer takes its dropless path):
the output, the aux loss, the routing, the keep mask and C. The reference does not return its routing or
dispatch plan, so the test reruns its lines (``src/repro/models/moe.py``
:54-59 and :67-78) on the reference's arrays.

Tolerances are ``tests/test_torch_lm_parity.py``'s: float32 outputs 2e-4,
the float32 aux loss 1e-5 relative, bfloat16 3e-2 + 3e-2 |x|. The dropless path is held to the capacity
path where C >= N, output, aux loss and gradients. Then one test per
numeric contract of the layer, each failing without it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as ref_arch
from repro.models import api as RA
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch.configs.base import MoESpec, get_arch
from repro_torch.convert import _map, _tensor, lm_params_from_reference
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.api import build_model

SPECS = {"granite": "granite-moe-3b-a800m", "llama4": "llama4-scout-17b-a16e"}
TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfg(name, **moe_kw):
    """The reference's and the port's reduced config of ``name``."""
    rcfg = ref_arch(SPECS[name]).reduced()
    pcfg = get_arch(SPECS[name]).reduced()
    if moe_kw:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe,
                                                                 **moe_kw))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe,
                                                                 **moe_kw))
    return rcfg, pcfg


def _layer(rcfg, dtype, seed=0):
    """The reference's MoE parameters and the same leaves as tensors."""
    rp = RM.moe_init(jax.random.PRNGKey(seed), rcfg.d_model, rcfg.d_ff,
                     rcfg.moe, JDT[dtype])
    return rp, _map(jax.device_get(rp), lambda a: _tensor(a, "cpu"))


def _inputs(rcfg, n, dtype, seed=1, repeat=False):
    """(1, n, D) activations rounded to ``dtype``, for both packages."""
    x = np.random.default_rng(seed).standard_normal((1, n, rcfg.d_model))
    if repeat:
        x[:, 1:] = x[:, :1]
    xr = jnp.asarray(x, JDT[dtype])
    xt = torch.from_numpy(np.array(xr.astype(jnp.float32))).to(TDT[dtype])
    return xr, xt


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _ref_route(p, spec, x):
    """``src/repro/models/moe.py:54-59``."""
    xf = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, spec.top_k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    return probs, gate_vals, gate_idx


def _ref_plan(gate_idx, spec):
    """``src/repro/models/moe.py:67-78``: C and the keep mask, put back
    in the (N, k) layout of ``gate_idx``."""
    N, k = gate_idx.shape
    E = spec.n_experts
    C = max(int(spec.capacity_factor * N * k / E), 1)
    flat_e = gate_idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = jnp.bincount(se, length=E)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(N * k) - starts[se]
    keep = np.zeros(N * k, bool)
    keep[np.asarray(order)] = np.asarray(pos < C)
    return C, keep.reshape(N, k)


CASES = {"n32": dict(n=32), "n2_drops": dict(n=2, repeat=True),
         "cf8_no_drops": dict(n=32, capacity_factor=8.0)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_moe_apply_matches_the_reference(name, dtype, case):
    kw = dict(CASES[case])
    n, repeat = kw.pop("n"), kw.pop("repeat", False)
    rcfg, pcfg = _cfg(name, **kw)
    rp, pp = _layer(rcfg, dtype)
    xr, xt = _inputs(rcfg, n, dtype, repeat=repeat)
    want, want_aux = RM.moe_apply(rp, rcfg.moe, rcfg.d_ff, xr)
    with torch.no_grad():
        got, got_aux = M.moe_apply(pp, pcfg.moe, pcfg.d_ff, xt)
        _, gv, gi = M.route(pp, pcfg.moe, xt)
    assert got.dtype == TDT[dtype] and got_aux.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)

    _, rgv, rgi = _ref_route(rp, rcfg.moe, xr)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(rgi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rgv), rtol=1e-5)
    C, keep = _ref_plan(rgi, rcfg.moe)
    assert M.capacity(pcfg.moe, n) == C
    slot, got_keep = M.dispatch_slots(gi, pcfg.moe.n_experts, C)
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    assert (slot.numpy() == C).sum() == (~keep).sum()
    # granite routes 2 of 4 experts, llama4 1 of 4
    assert C == {("granite", "n32"): 20, ("llama4", "n32"): 10,
                 ("granite", "n2_drops"): 1, ("llama4", "n2_drops"): 1,
                 ("granite", "cf8_no_drops"): 128,
                 ("llama4", "cf8_no_drops"): 64}[name, case]
    if case == "n2_drops":
        assert not keep.all()
    if case == "cf8_no_drops":
        assert keep.all()


# ---------------------------------------------------------------------------
# the dropless path
# ---------------------------------------------------------------------------

def _out_aux_grads(pp, spec, d_ff, x, w):
    """``moe_apply``'s output, aux loss and the gradients of
    ``sum(out * w) + aux`` with respect to x and every leaf."""
    leaves = {k: v.clone().requires_grad_() for k, v in pp.items()
              if isinstance(v, torch.Tensor)}
    params = dict(pp, **leaves)
    x = x.clone().requires_grad_()
    out, aux = M.moe_apply(params, spec, d_ff, x)
    grads = torch.autograd.grad((out * w).sum() + aux,
                                [x] + list(leaves.values()))
    return [out, aux] + list(grads)


@pytest.mark.parametrize("factor", ["cf8", "e_over_k"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_the_dropless_path_equals_the_capacity_path(name, factor,
                                                    monkeypatch):
    """Where no pair can be dropped (capacity factor 8, and exactly E / k,
    where C = N), the dropless path (pairs sorted by expert, grouped
    products) gives the capacity path's output, aux loss and every
    gradient, the shared expert's included, in float32. Routing and the
    combine's order are the same, so only the products' summation order
    may differ: 1e-6."""
    _, pcfg = _cfg(name)
    spec = pcfg.moe
    cf = 8.0 if factor == "cf8" else spec.n_experts / spec.top_k
    spec = dataclasses.replace(spec, capacity_factor=cf)
    n = 32
    assert M.dropless(spec, n)
    if factor == "e_over_k":
        assert M.capacity(spec, n) == n
    rcfg, _ = _cfg(name)
    _, pp = _layer(rcfg, "float32")
    _, xt = _inputs(rcfg, n, "float32")
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        tuple(xt.shape)).astype(np.float32))
    sorted_calls = []
    real_sort = M.sort_pairs
    monkeypatch.setattr(M, "sort_pairs", lambda *a: sorted_calls.append(1)
                        or real_sort(*a))
    grouped = _out_aux_grads(pp, spec, pcfg.d_ff, xt, w)
    assert sorted_calls == [1]
    monkeypatch.setattr(M, "dropless", lambda spec, n: False)
    padded = _out_aux_grads(pp, spec, pcfg.d_ff, xt, w)
    assert sorted_calls == [1]
    assert len(grouped) == len(padded) >= 6
    for got, want in zip(grouped, padded):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n,k,n_experts", [(4096, 8, 40), (32, 2, 4),
                                            (5, 1, 4), (1, 8, 40)])
def test_sort_pairs_is_a_stable_sort_by_expert(n, k, n_experts):
    """``sort_pairs`` orders the pairs by expert and by token within an
    expert, with ``inverse`` its inverse permutation and the run ends the
    running sum of each expert's pairs as int32 offsets; half the tokens
    routed alike, as a router that sends every token to the same experts
    routes them."""
    gen = torch.Generator().manual_seed(n)
    gate_idx = torch.stack([torch.randperm(n_experts, generator=gen)[:k]
                            for _ in range(n)])
    gate_idx[:n // 2] = gate_idx[0]
    order, inverse, ends = M.sort_pairs(gate_idx, n_experts)
    flat_e = gate_idx.reshape(-1)
    assert torch.equal(order, torch.sort(flat_e, stable=True).indices)
    assert torch.equal(inverse[order], torch.arange(n * k))
    assert ends.dtype == torch.int32
    assert torch.equal(ends.long(), torch.cumsum(
        M.expert_counts(gate_idx, n_experts), 0))


def test_a_capacity_under_e_over_k_keeps_the_capacity_path(monkeypatch):
    """Just under E / k (granite's reduced spec: 4 experts top-2, factor
    1.99, so C = 31 at N = 32) the layer keeps the capacity path and drops
    as the reference does: 32 equal tokens fill their two experts, and
    the last token gets nothing. The dropless path's sort is never
    called."""
    rcfg, pcfg = _cfg("granite", capacity_factor=1.99)
    assert not M.dropless(pcfg.moe, 32) and M.capacity(pcfg.moe, 32) == 31
    assert M.dropless(dataclasses.replace(pcfg.moe, capacity_factor=2.0), 32)

    def never(*args):
        raise AssertionError("the dropless path ran")
    monkeypatch.setattr(M, "sort_pairs", never)
    rp, pp = _layer(rcfg, "float32")
    xr, xt = _inputs(rcfg, 32, "float32", repeat=True)
    want = _f32(RM.moe_apply(rp, rcfg.moe, rcfg.d_ff, xr)[0])
    got = _f32(M.moe_apply(pp, pcfg.moe, pcfg.d_ff, xt)[0])
    np.testing.assert_allclose(got, want, **TOL["float32"])
    np.testing.assert_array_equal(got[0, 31], 0.0)
    assert (np.abs(got[0, :31]).sum(-1) > 0).all()


# ---------------------------------------------------------------------------
# the numeric contracts, one test each
# ---------------------------------------------------------------------------

def test_router_stays_float32_in_a_bfloat16_model():
    """A bf16 granite keeps its router in float32, through ``convert`` and
    through ``init_params``; every other leaf is bfloat16. A blanket cast
    to the config's dtype would round the router and move the routing."""
    rcfg = dataclasses.replace(ref_arch(SPECS["granite"]).reduced(),
                               dtype="bfloat16")
    pcfg = dataclasses.replace(get_arch(SPECS["granite"]).reduced(),
                               dtype="bfloat16")
    tree = jax.device_get(RA.build_model(rcfg).init_params(
        jax.random.PRNGKey(0)))
    converted = lm_params_from_reference(tree, pcfg, "cpu")
    drawn = build_model(pcfg).init_params(torch.Generator().manual_seed(0))
    for params in (converted, drawn):
        dtypes = {n: p.dtype for n, p in params.named_parameters()}
        routers = [n for n in dtypes if n.endswith("moe.router")]
        assert len(routers) == pcfg.n_layers
        assert all(dtypes[n] == torch.float32 for n in routers)
        assert {dtypes[n] for n in dtypes if n not in routers} == {
            torch.bfloat16}
    np.testing.assert_array_equal(
        converted.layers[1].moe.router.detach().numpy(),
        np.asarray(tree["layers"]["moe"]["router"][1]))


def test_router_logits_and_softmax_run_in_float32():
    """In a bf16 layer the gate values equal the reference's to float32
    rounding: the bf16 activations are widened before the router's
    product. A product in bfloat16 misses by far more."""
    rcfg, pcfg = _cfg("granite")
    rp, pp = _layer(rcfg, "bfloat16")
    xr, xt = _inputs(rcfg, 32, "bfloat16")
    _, rgv, rgi = _ref_route(rp, rcfg.moe, xr)
    probs, gv, gi = M.route(pp, pcfg.moe, xt)
    assert probs.dtype == gv.dtype == torch.float32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(rgi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rgv), atol=1e-6)
    narrow = torch.softmax((xt @ pp["router"].to(torch.bfloat16)).float(), -1)
    assert (narrow - probs).abs().max() > 1e-4


def test_ties_go_to_the_lower_expert_index():
    """``lax.top_k`` breaks ties toward the lower index: a row of zeros
    gives uniform probabilities over granite's 40 experts and must pick
    experts 0..7, in that order, in both packages."""
    spec = get_arch(SPECS["granite"]).moe
    assert (spec.n_experts, spec.top_k) == (40, 8)
    router = np.random.default_rng(0).standard_normal((16, 40))
    router = router.astype(np.float32)
    x = np.zeros((3, 16), np.float32)
    x[1] = 1.0                            # one row with no tie, between
    _, rgv, rgi = _ref_route({"router": jnp.asarray(router)}, spec,
                             jnp.asarray(x))
    _, gv, gi = M.route({"router": torch.from_numpy(router)}, spec,
                        torch.from_numpy(x))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(rgi))
    for row in (0, 2):
        assert gi[row].tolist() == list(range(8))
        np.testing.assert_allclose(gv[row].numpy(), 1 / 8, rtol=1e-6)


def test_capacity_is_the_reference_expression_for_this_call():
    """``C = max(int(capacity_factor * N * k / E), 1)`` in Python floats in
    the reference's order, N the tokens of this call: granite's decode at
    batch 4 gets C = 1, its 128-token prefill C = 32. At capacity factor
    0.7, 350 tokens and granite's 40 experts top-8, another order gives
    another C."""
    granite = get_arch(SPECS["granite"]).moe
    assert M.capacity(granite, 4) == 1 and M.capacity(granite, 128) == 32
    odd = MoESpec(n_experts=40, top_k=8, capacity_factor=0.7)
    assert M.capacity(odd, 350) == 48
    assert max(int(0.7 * (350 * 8 / 40)), 1) == 49
    for spec in (granite, odd, get_arch(SPECS["llama4"]).moe,
                 get_arch(SPECS["llama4"]).reduced().moe):
        for n in (1, 2, 3, 4, 31, 128, 350, 1000, 4096):
            want = max(int(spec.capacity_factor * n * spec.top_k
                           / spec.n_experts), 1)
            assert M.capacity(spec, n) == want
    # moe_apply sizes C by the tokens it is given: (B, S) = (4, 1)
    rcfg, pcfg = _cfg("granite")
    rp, pp = _layer(rcfg, "float32")
    xr, xt = _inputs(rcfg, 4, "float32")
    for b, s in ((4, 1), (1, 4), (2, 2)):
        want = RM.moe_apply(rp, rcfg.moe, rcfg.d_ff,
                            xr.reshape(b, s, -1))[0]
        got = M.moe_apply(pp, pcfg.moe, pcfg.d_ff, xt.reshape(b, s, -1))[0]
        np.testing.assert_allclose(_f32(got).reshape(4, -1),
                                   _f32(want).reshape(4, -1), **TOL["float32"])


@pytest.mark.parametrize("name", sorted(SPECS))
def test_a_token_whose_experts_are_full_gets_only_the_shared_expert(name):
    """Two equal tokens at C = 1: the second finds every one of its
    experts taken by the first. It gets 0 from the routed experts, plus
    the shared expert where there is one (llama4), in both packages."""
    rcfg, pcfg = _cfg(name)
    rp, pp = _layer(rcfg, "float32")
    xr, xt = _inputs(rcfg, 2, "float32", repeat=True)
    want = _f32(RM.moe_apply(rp, rcfg.moe, rcfg.d_ff, xr)[0])
    got = _f32(M.moe_apply(pp, pcfg.moe, pcfg.d_ff, xt)[0])
    np.testing.assert_allclose(got, want, **TOL["float32"])
    if "shared" in pp:
        shared = _f32(L.mlp(pp["shared"], L.MlpCfg(pcfg.d_model, pcfg.d_ff),
                            xt))
        np.testing.assert_array_equal(got[0, 1], shared[0, 1])
        assert np.abs(got[0, 0] - shared[0, 0]).max() > 1e-3
    else:
        np.testing.assert_array_equal(got[0, 1], 0.0)
        assert np.abs(got[0, 0]).max() > 1e-3


def _combine_case(seed=0, N=64, k=8, E=40, C=6, D=64):
    """Random bf16 expert outputs, distinct experts per token, gate values
    in float32 and a drop pattern: the reference's combine inputs."""
    rng = np.random.default_rng(seed)
    gate_idx = np.stack([rng.permutation(E)[:k] for _ in range(N)])
    gate_vals = rng.dirichlet(np.ones(k), N).astype(np.float32)
    eout = jnp.asarray(rng.standard_normal((E, C, D)), jnp.bfloat16)
    return gate_idx, gate_vals, eout, MoESpec(n_experts=E, top_k=k,
                                              capacity_factor=C * E / (N * k))


def _ref_combine(gate_idx, gate_vals, eout, spec):
    """``src/repro/models/moe.py:67-78`` and ``:92-95``, jitted as the
    reference's layer is."""
    N, k = gate_idx.shape
    E, C, D = eout.shape

    @jax.jit
    def run(gate_idx, gate_vals, eout):
        flat_e = gate_idx.reshape(-1)
        flat_t = jnp.repeat(jnp.arange(N), k)
        flat_w = gate_vals.reshape(-1)
        order = jnp.argsort(flat_e, stable=True)
        se, st, sw = flat_e[order], flat_t[order], flat_w[order]
        counts = jnp.bincount(se, length=E)
        starts = jnp.cumsum(counts) - counts
        pos = jnp.arange(N * k) - starts[se]
        keep = pos < C
        pos_c = jnp.where(keep, pos, 0)
        gathered = eout[se, pos_c]
        gathered = jnp.where(keep[:, None], gathered, 0)
        contrib = gathered * sw[:, None].astype(eout.dtype)
        return jnp.zeros((N, D), dtype=eout.dtype).at[st].add(contrib)
    assert max(int(spec.capacity_factor * N * k / E), 1) == C
    return np.asarray(run(jnp.asarray(gate_idx), jnp.asarray(gate_vals),
                          eout).astype(jnp.float32))


def _port_rows(gate_idx, eout, C):
    gi = torch.from_numpy(gate_idx).long()
    slot, keep = M.dispatch_slots(gi, eout.shape[0], C)
    e = torch.from_numpy(np.array(eout.astype(jnp.float32)))
    e = torch.nn.functional.pad(e.to(torch.bfloat16), (0, 0, 0, 1))
    return gi, e[gi, slot], keep


def test_combine_adds_in_ascending_expert_order_in_the_rows_dtype():
    """The reference scatter-adds expert-sorted contributions, so each
    token's are summed left to right in bf16 in ascending expert order.
    The port's ``combine`` gives the same bits; a float32 sum rounded once,
    or the top-k rank order, gives others."""
    gate_idx, gate_vals, eout, spec = _combine_case()
    want = _ref_combine(gate_idx, gate_vals, eout, spec)
    gi, rows, keep = _port_rows(gate_idx, eout, eout.shape[1])
    assert not keep.all() and keep.any()
    gv = torch.from_numpy(gate_vals)
    got = M.combine(rows, gv, gi)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)

    contrib = rows * gv.to(torch.bfloat16)[..., None]
    wide = contrib.float().sum(1).to(torch.bfloat16)
    by_rank = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        by_rank = by_rank + contrib[:, j]
    for other in (wide, by_rank):
        assert not np.array_equal(other.float().numpy(), want)


def test_combine_rounds_the_gate_weights_before_the_product():
    """``contrib = rows * gate_vals.astype(x.dtype)``: the float32 gate
    weights are rounded to bf16 first. Multiplying in float32 and rounding
    the product gives other bits."""
    gate_idx, gate_vals, eout, spec = _combine_case(seed=1, k=2, E=4, C=20,
                                                   N=32)
    want = _ref_combine(gate_idx, gate_vals, eout, spec)
    gi, rows, _ = _port_rows(gate_idx, eout, eout.shape[1])
    gv = torch.from_numpy(gate_vals)
    np.testing.assert_array_equal(M.combine(rows, gv, gi).float().numpy(),
                                  want)
    unrounded = (rows.float() * gv[..., None]).to(torch.bfloat16)
    asc = torch.argsort(gi, dim=1)
    unrounded = torch.gather(unrounded, 1, asc[..., None].expand_as(rows))
    assert not np.array_equal(
        (unrounded[:, 0] + unrounded[:, 1]).float().numpy(), want)


def test_shared_expert_is_swiglu_whatever_the_activation():
    """The shared expert is ``layers.mlp`` with ``MlpCfg(D, d_ff)``, whose
    activation defaults to SwiGLU: a llama4 config set to GELU still runs
    a SwiGLU shared expert, in the layer and in the whole model."""
    rcfg, pcfg = _cfg("llama4")
    rcfg = dataclasses.replace(rcfg, activation="gelu", dtype="float32")
    pcfg = dataclasses.replace(pcfg, activation="gelu", dtype="float32")
    rp, pp = _layer(rcfg, "float32")
    assert set(pp["shared"]) == {"wg", "wu", "wd"}
    xr, xt = _inputs(rcfg, 8, "float32")
    want = _f32(RM.moe_apply(rp, rcfg.moe, rcfg.d_ff, xr)[0])
    got = _f32(M.moe_apply(pp, pcfg.moe, pcfg.d_ff, xt)[0])
    np.testing.assert_allclose(got, want, **TOL["float32"])
    gelu = L.mlp(pp["shared"], L.MlpCfg(pcfg.d_model, pcfg.d_ff, "gelu"), xt)
    swiglu = L.mlp(pp["shared"], L.MlpCfg(pcfg.d_model, pcfg.d_ff), xt)
    assert (gelu - swiglu).abs().max() > 1e-3

    tree = jax.device_get(RA.build_model(rcfg).init_params(
        jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, rcfg.vocab, (2, 8))
    toks = toks.astype(np.int32)
    ref = RT.forward(tree, rcfg, tokens=jnp.asarray(toks))[0]
    with torch.no_grad():
        port = T.forward(lm_params_from_reference(tree, pcfg, "cpu"), pcfg,
                         torch.from_numpy(toks))[0]
    np.testing.assert_allclose(_f32(port), _f32(ref), **TOL["float32"])


def test_both_impl_strings_run_the_global_path():
    """Without a mesh the reference runs its global path for "gspmd" and
    "shard_map" alike; so does the port, bit for bit. Another string is
    refused by name."""
    rcfg, pcfg = _cfg("granite")
    rp, pp = _layer(rcfg, "bfloat16")
    xr, xt = _inputs(rcfg, 32, "bfloat16")
    outs = {}
    for impl in M.IMPLS:
        want = RM.moe_apply(rp, rcfg.moe, rcfg.d_ff, xr, impl=impl)[0]
        outs[impl] = M.moe_apply(pp, pcfg.moe, pcfg.d_ff, xt, impl=impl)[0]
        np.testing.assert_allclose(_f32(outs[impl]), _f32(want),
                                   **TOL["bfloat16"])
    assert torch.equal(outs["gspmd"], outs["shard_map"])
    assert pcfg.moe_impl in M.IMPLS
    with pytest.raises(ValueError, match="impl must be one of"):
        M.moe_apply(pp, pcfg.moe, pcfg.d_ff, xt, impl="ragged")


def test_decode_differs_from_the_full_forward_and_the_port_follows_each():
    """C is sized by the tokens of each call, so granite's decode (N = 2,
    C = 1, pairs dropped) differs from its full forward (N = 24, C = 15):
    the reference's own decode is not its forward, and the port matches
    the reference in each (float32; decode within the caches' bf16
    tolerance). Both references run op by op, as the port does."""
    rcfg = dataclasses.replace(ref_arch(SPECS["granite"]).reduced(),
                               dtype="float32")
    pcfg = dataclasses.replace(get_arch(SPECS["granite"]).reduced(),
                               dtype="float32")
    rapi, papi = RA.build_model(rcfg), build_model(pcfg)
    tree = jax.device_get(rapi.init_params(jax.random.PRNGKey(0)))
    params = lm_params_from_reference(tree, pcfg, "cpu")
    toks = np.random.default_rng(3).integers(0, rcfg.vocab, (2, 12))
    toks = toks.astype(np.int32)
    with jax.disable_jit():
        ref_full = _f32(RT.forward(tree, rcfg, tokens=jnp.asarray(toks))[0])
        state, ref_steps = RT.init_caches(rcfg, 2, 12), []
        for t in range(12):
            logits, state = rapi.decode_step(tree, state,
                                             jnp.asarray(toks[:, t:t + 1]),
                                             jnp.asarray(t, jnp.int32))
            ref_steps.append(_f32(logits))
    ref_dec = np.stack(ref_steps, 1)
    with torch.no_grad():
        full = _f32(T.forward(params, pcfg, torch.from_numpy(toks))[0])
        state, steps = T.init_caches(pcfg, 2, 12, device="cpu"), []
        for t in range(12):
            logits, state = papi.decode_step(
                params, state, torch.from_numpy(toks[:, t:t + 1]), t)
            steps.append(_f32(logits))
    dec = np.stack(steps, 1)
    assert np.abs(ref_full - ref_dec).max() > 0.1
    np.testing.assert_allclose(full, ref_full, **TOL["float32"])
    np.testing.assert_allclose(dec, ref_dec, **TOL["bfloat16"])

