"""``repro_torch.workloads`` and the model mix of ``repro_torch.serve``
held to the reference (``repro.workloads``, ``benchmarks/bench_serve.py``).

  * the registry: every field of every class, the mix, the weights and the
    seeded input streams equal the reference's; each port oracle is
    bit-exact against the reference oracle (which runs eagerly);
  * each class's traced DFG has the reference trace's signature, and on
    ``"sim"`` (and ``"cuda"`` on the CPU against the reference ``"pallas"``
    in interpret mode) the same inputs give the same values and the same
    ``Tally``;
  * the model-mix soak reproduces ``perf_baseline.json``'s
    ``serve_model`` pins, and its digests equal the reference soak's.

The reference tracer cannot trace ``jnp.clip`` under the installed JAX
(its call primitive is ``jit``; the tracer handles ``pjit``), so
``silu_q`` and ``swiglu_ms`` fail to trace there as the repository
stands. The ``ref_traceable`` fixture swaps the reference's ``_hswish``,
for the test only, for the same arithmetic written with ``lax.min`` /
``lax.max``, which it traces.

A traced class's config class hashes its traced graph (a jaxpr there, an
aten graph here), and a ``"cuda"`` class hashes its backend's name, so
serve digests are compared once each config class is renamed to the
reference class of the same label (:func:`_renamed`); results digests of
the fleet, keyed by label, need no renaming.
"""
import json
import os

import numpy as np
import pytest
from jax import lax

import repro.workloads.kernels as RWK
from benchmarks import bench_serve as rbench
from repro.engine import ArtifactCache as RCache
from repro.engine import Engine as REngine
from repro.frontend import trace as ref_trace
from repro.serve import make_labeled_requests as ref_labeled_requests
from repro.serve import recipe_skip_reason as ref_skip_reason
from repro.serve import serve_classes as ref_serve_classes
from repro.serve.loop import ServeConfig as RServeConfig
from repro.workloads import MODEL_CLASSES as REF_CLASSES
from repro.workloads import MODEL_MIX as REF_MIX
from repro.workloads import model_recipes as ref_model_recipes
from repro.workloads import model_weights as ref_model_weights
from repro_torch import bench_serve as pbench
from repro_torch.convert import dfg_from_reference
from repro_torch.engine import ArtifactCache, Engine
from repro_torch.frontend import trace
from repro_torch.serve import (ServeConfig, make_labeled_requests,
                               poisson_arrival_times, recipe_skip_reason,
                               serve_classes)
from repro_torch.workloads import (MODEL_CLASSES, MODEL_MIX, model_recipes,
                                   model_weights)
from repro_torch.workloads import kernels as WK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "benchmarks", "perf_baseline.json")) as _f:
    _BASE = json.load(_f)
PIN, PIN_LENGTH = _BASE["serve_model"], _BASE["length"]
LABELS = sorted(MODEL_CLASSES)
LENGTH = 32


def _lax_hswish(x):
    t = lax.min(lax.max(x + 3 * RWK.ONE, 0), 6 * RWK.ONE)
    p = (x * t) >> 9
    return (p * RWK.INV6_Q16) >> 16


@pytest.fixture
def ref_traceable(monkeypatch):
    """The reference's ``_hswish`` in a form its tracer takes (test-time
    only; the same int32 arithmetic as ``jnp.clip``)."""
    monkeypatch.setattr(RWK, "_hswish", _lax_hswish)


def _port_engine(backend="sim"):
    kw = {"device": "cpu"} if backend == "cuda" else {}
    return Engine(backend=backend, cache=ArtifactCache(memory_only=True),
                  **kw)


def _ref_engine(backend="sim"):
    return REngine(backend=backend, cache=RCache(memory_only=True))


def _renamed(serve, length, mix, backend="sim"):
    """The port soak's trace and results digests with every config class
    renamed to the reference class of the same label."""
    port = serve_classes(_port_engine(backend), length, mix=mix)
    ref_backend = "pallas" if backend == "cuda" else backend
    ref = ref_serve_classes(_ref_engine(ref_backend), length, mix=mix)
    assert sorted(port) == sorted(ref)
    names = {port[k].config_class: ref[k].config_class for k in port}
    serve.trace = [tuple(names.get(x, x) if isinstance(x, str) else x
                         for x in ev) for ev in serve.trace]
    for tk in serve.served:
        tk.cls = names[tk.cls]
    return serve.trace_digest(), serve.results_digest()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_mix_weights_and_recipes_equal_reference():
    assert MODEL_MIX == REF_MIX
    assert model_weights() == ref_model_weights()
    for length in (1, LENGTH, 4096):
        port, ref = model_recipes(length), ref_model_recipes(length)
        assert list(port) == list(ref)
        for label in port:
            assert port[label][1] == ref[label][1], label
            assert port[label][0].__name__ == ref[label][0].__name__


@pytest.mark.parametrize("label", LABELS)
def test_registry_fields_equal_reference(label):
    wc, rc = MODEL_CLASSES[label], REF_CLASSES[label]
    for field in ("label", "layer", "description", "compile_kwargs",
                  "inputs", "weight", "pallas_skip", "exactness"):
        assert getattr(wc, field) == getattr(rc, field), field
    assert list(wc.inputs) == list(rc.inputs)
    for field in ("build", "oracle", "float_ref"):
        assert getattr(wc, field).__name__ == getattr(rc, field).__name__


def test_constants_equal_reference():
    for name in ("Q", "ONE", "LN_GAIN", "LN_BIAS", "INV6_Q16",
                 "SCORE_SHIFT", "SSM_DECAY_MAX", "REC_A", "REC_B", "REC_TOL",
                 "MOE_W0", "MOE_W1"):
        assert getattr(WK, name) == getattr(RWK, name), name


@pytest.mark.parametrize("label", LABELS)
def test_gen_inputs_and_oracles_equal_reference(label):
    """Equal seeds give equal streams, and each port oracle equals the
    reference oracle bit for bit, at the reference tests' lengths and on
    streams over the whole input range."""
    wc, rc = MODEL_CLASSES[label], REF_CLASSES[label]
    for length, seed in ((LENGTH, 0), (LENGTH, 1), (64, 2), (4096, 3)):
        ins = wc.gen_inputs(length, np.random.default_rng(seed))
        ref_ins = rc.gen_inputs(length, np.random.default_rng(seed))
        assert list(ins) == list(ref_ins)
        for k in ins:
            np.testing.assert_array_equal(ins[k], ref_ins[k])
        got, want = wc.oracle(**ins), rc.oracle(**ref_ins)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {seed}")
        outs = [np.ravel(g) for g in got]
        for a, b in zip(wc.float_ref(ins, outs), rc.float_ref(ref_ins, outs)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# traced DFGs, values and Tally against the reference trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", LABELS)
def test_trace_values_and_tally_equal_reference_on_sim(label,
                                                       ref_traceable):
    wc = MODEL_CLASSES[label]
    g = trace(wc.build(), LENGTH)
    ref_g = ref_trace(REF_CLASSES[label].build(), LENGTH)
    assert g.canonical_signature() == \
        dfg_from_reference(ref_g).canonical_signature()
    assert sorted(g.nodes) == sorted(ref_g.nodes)
    assert list(g.inputs) == list(ref_g.inputs)
    eng, ref_eng = _port_engine(), _ref_engine()
    art = eng.compile(wc.build(), LENGTH, **wc.compile_kwargs)
    ref_art = ref_eng.compile(REF_CLASSES[label].build(), LENGTH,
                              **wc.compile_kwargs)
    assert art.n_shots == ref_art.n_shots
    assert art.features == ref_art.features
    for seed in (0, 1):
        ins = wc.gen_inputs(LENGTH, np.random.default_rng(seed))
        out, ref_out = eng.run(art, ins), ref_eng.run(ref_art, ins)
        assert sorted(out) == sorted(ref_out)
        for k in out:
            np.testing.assert_array_equal(np.asarray(out[k]),
                                          np.asarray(ref_out[k]))
    assert vars(eng.tally) == vars(ref_eng.tally)


@pytest.mark.parametrize("label", [l for l in LABELS
                                   if MODEL_CLASSES[l].pallas_skip is None])
def test_cuda_plain_version_equals_reference_pallas(label, ref_traceable):
    """``Engine(backend="cuda", device="cpu")`` against the reference
    ``"pallas"`` engine (interpret mode): equal values and ``Tally``."""
    wc = MODEL_CLASSES[label]
    eng, ref_eng = _port_engine("cuda"), _ref_engine("pallas")
    art = eng.compile(wc.build(), LENGTH, **wc.compile_kwargs)
    ref_art = ref_eng.compile(REF_CLASSES[label].build(), LENGTH,
                              **wc.compile_kwargs)
    ins = wc.gen_inputs(LENGTH, np.random.default_rng(5))
    out, ref_out = eng.run(art, ins), ref_eng.run(ref_art, ins)
    for k in ref_out:
        np.testing.assert_array_equal(np.asarray(out[k]),
                                      np.asarray(ref_out[k]))
    assert vars(eng.tally) == vars(ref_eng.tally)
    assert eng.stats.lane_batch_failures == 0


@pytest.mark.parametrize("length", [LENGTH, 4096])
def test_cuda_skips_exactly_what_pallas_skips(length, ref_traceable):
    recipes, ref_recipes = model_recipes(length), ref_model_recipes(length)
    for label in LABELS:
        assert recipe_skip_reason(label, length, "cuda", recipes) == \
            ref_skip_reason(label, length, "pallas", ref_recipes) == \
            MODEL_CLASSES[label].pallas_skip, label


# ---------------------------------------------------------------------------
# the model-mix soak
# ---------------------------------------------------------------------------

def test_model_request_streams_match_reference(ref_traceable):
    """Same seed -> same arrival times, weighted class picks and streams."""
    classes = serve_classes(_port_engine(), LENGTH, mix="model")
    ref_classes = ref_serve_classes(_ref_engine(), LENGTH, mix="model")
    rng, ref_rng = np.random.default_rng(4), np.random.default_rng(4)
    times = poisson_arrival_times(rng, 80, 0.2)
    ref_rng.exponential(1.0, 80)             # the same draws as the times
    got = make_labeled_requests(classes, times, LENGTH, rng,
                                model_weights())
    want = ref_labeled_requests(ref_classes, times, LENGTH, ref_rng,
                                ref_model_weights())
    assert [(t, l) for t, l, _ in got] == [(t, l) for t, l, _ in want]
    for (_, _, ins), (_, _, ref_ins) in zip(got, want):
        assert list(ins) == list(ref_ins)
        for k in ins:
            np.testing.assert_array_equal(ins[k], ref_ins[k])


def test_pinned_model_soak_matches_reference(ref_traceable):
    """``perf_baseline.json``'s ``serve_model`` gate on the port: exact
    counts and preemptions, every response re-verified against the
    oracles, the virtual p99 within budget, and both digests equal to the
    reference soak's."""
    kw = dict(seed=PIN["seed"], n_requests=PIN["requests"],
              length=PIN_LENGTH, backend="sim",
              rate_per_us=PIN["rate_per_us"], mix="model")
    serve, rep = pbench.soak(**kw)
    _, ref = rbench.soak(**kw)
    for k in ("served", "rejected", "failed", "preemptions"):
        assert rep[k] == PIN[k] == ref[k], k
    assert rep["oracle_checked"] == rep["served"] == 150
    assert rep["oracle_mismatches"] == 0
    assert rep["latency"]["p99_us"] <= PIN["p99_budget_us"]
    assert rep["latency"]["p99_us"] == ref["latency"]["p99_us"]
    for k in ("batches", "close_reasons", "config_cycles_paid",
              "config_cycles_naive", "now_us"):
        assert rep[k] == ref[k], k
    assert _renamed(serve, PIN_LENGTH, "model") == \
        (ref["trace_digest"], ref["results_digest"])


def test_model_calibration_equals_reference(ref_traceable):
    """The calibrated model-mix capacity equals the reference's, and a
    soak with no rate offers it."""
    mean_us = pbench.calibrate("sim", LENGTH, mix="model")
    assert mean_us == rbench.calibrate("sim", LENGTH, mix="model")[0]
    kw = dict(seed=2, n_requests=24, length=LENGTH, mix="model")
    _, rep = pbench.soak(**kw)
    _, fixed = pbench.soak(rate_per_us=1.0 / mean_us, **kw)
    assert rep["results_digest"] == fixed["results_digest"]
    assert rep["trace_digest"] == fixed["trace_digest"]


def test_cuda_cpu_model_soak_matches_reference_pallas(ref_traceable):
    """The model mix served by the port's ``"cuda"`` backend on the CPU
    against the reference ``"pallas"`` soak (interpret mode): counts, the
    oracle re-verification and, once classes are renamed, both digests.
    A 1 us preemption wait makes ``swiglu_ms``'s plan yield at its shot
    boundaries."""
    kw = dict(seed=3, n_requests=30, length=LENGTH, rate_per_us=0.3,
              mix="model")
    serve, rep = pbench.soak(backend="cuda", device="cpu",
                             config=ServeConfig(preempt_wait_us=1.0), **kw)
    _, ref = rbench.soak(backend="pallas",
                         config=RServeConfig(preempt_wait_us=1.0), **kw)
    for k in ("offered", "served", "rejected", "failed", "preemptions",
              "batches", "close_reasons", "config_cycles_paid",
              "config_cycles_naive", "now_us", "oracle_checked",
              "oracle_mismatches"):
        assert rep[k] == ref[k], k
    assert rep["served"] == rep["oracle_checked"] > 0
    assert rep["oracle_mismatches"] == 0 and rep["preemptions"] >= 1
    assert serve.engine.stats.lane_batches > 0
    assert serve.engine.stats.lane_batch_failures == 0
    assert _renamed(serve, LENGTH, "model", backend="cuda") == \
        (ref["trace_digest"], ref["results_digest"])
