"""The port's serving loop held to the reference ``repro.serve``: the same
``(seed, ServeConfig)`` must give the same request stream, the same
scheduling trace and the same served values in both packages.

  * on ``"sim"`` the port's soak equals the reference's digest for digest,
    the pinned soak of ``benchmarks/perf_baseline.json`` included;
  * ``Engine(backend="cuda", device="cpu")`` (the kernels' plain versions)
    equals the reference ``"pallas"`` soak (Pallas interpret mode): counts,
    skipped classes with their reasons, and both digests once each config
    class is renamed to the reference's class of the same label (a class
    key hashes its backend's name, ``"cuda"`` here and ``"pallas"``
    there, and nothing else differs);
  * the ``"cuda"`` soak's served values equal a single-``Engine.run``
    oracle fed the same stream.
"""
import json
import os

import numpy as np
import pytest

from benchmarks import bench_serve as rbench
from repro.engine import ArtifactCache as RCache
from repro.engine import Engine as REngine
from repro.serve import artifact_skip_reason as ref_artifact_skip
from repro.serve import make_labeled_requests as ref_labeled_requests
from repro.serve import poisson_arrival_times as ref_poisson
from repro.serve import recipe_skip_reason as ref_skip_reason
from repro.serve import serve_classes as ref_serve_classes
from repro.serve.load import class_recipes as ref_class_recipes
from repro.serve.loop import ServeConfig as RServeConfig
from repro.workloads import MODEL_MIX as REF_MODEL_MIX
from repro_torch import bench_serve as pbench
from repro_torch.serve import (ServeConfig, artifact_skip_reason,
                               make_labeled_requests, poisson_arrival_times,
                               recipe_skip_reason, serve_classes)
from repro_torch.serve import load as pload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "benchmarks", "perf_baseline.json")) as _f:
    PIN = json.load(_f)["serve"]
PIN_LENGTH = 64                  # bench_serve.soak's default length


def _digests(rep):
    return rep["trace_digest"], rep["results_digest"]


def _renamed(serve, report, length):
    """The port ``"cuda"`` soak's digests and per-class latencies with
    every config class renamed to the reference ``"pallas"`` class of the
    same label."""
    port = serve_classes(pbench.fresh_engine("cuda", "cpu"), length)
    ref = ref_serve_classes(
        REngine(backend="pallas", cache=RCache(memory_only=True)), length)
    assert sorted(port) == sorted(ref)
    names = {port[k].config_class: ref[k].config_class for k in port}
    serve.trace = [tuple(names.get(x, x) if isinstance(x, str) else x
                         for x in ev) for ev in serve.trace]
    for tk in serve.served:
        tk.cls = names[tk.cls]
    per_class = {names[c]: v
                 for c, v in report["latency"]["per_class"].items()}
    return serve.trace_digest(), serve.results_digest(), per_class


def test_pinned_sim_soak_matches_reference():
    """The reference's pinned serve gate reproduces on the port: exact
    counts, the virtual-time p99 budget, and both digests equal to the
    reference's for the same seed and config."""
    mean_us = pbench.calibrate("sim", PIN_LENGTH)
    ref_mean_us, _ = rbench.calibrate("sim", PIN_LENGTH)
    assert mean_us == ref_mean_us
    rate = PIN["offered_load"] / mean_us
    _, rep = pbench.soak(PIN["seed"], PIN["requests"], PIN_LENGTH, "sim",
                         rate_per_us=rate)
    _, ref = rbench.soak(PIN["seed"], PIN["requests"], PIN_LENGTH, "sim",
                         rate_per_us=rate)
    for k in ("served", "rejected", "failed"):
        assert rep[k] == PIN[k] == ref[k], k
    assert rep["preemptions"] == ref["preemptions"]
    assert rep["latency"]["p99_us"] <= PIN["p99_budget_us"]
    assert rep["latency"] == ref["latency"]
    assert _digests(rep) == _digests(ref)


@pytest.mark.parametrize("seed,bursty,cfg", [
    (1, False, {}),
    (2, True, {}),
    (3, False, {"queue_capacity": 12, "max_batch": 4}),
    (4, True, {"preempt_wait_us": 30.0, "max_wait_us": 150.0}),
    (5, False, {"preempt_wait_us": 1.0, "queue_capacity": 200}),
])
def test_sim_soak_digests_match_reference(seed, bursty, cfg):
    kw = dict(n_requests=80, length=32, backend="sim", rate_per_us=0.2,
              bursty=bursty)
    _, rep = pbench.soak(seed, config=ServeConfig(**cfg), **kw)
    _, ref = rbench.soak(seed, config=RServeConfig(**cfg), **kw)
    for k in ("offered", "served", "rejected", "failed", "preemptions",
              "batches", "close_reasons", "config_cycles_paid",
              "config_cycles_naive", "now_us"):
        assert rep[k] == ref[k], k
    assert _digests(rep) == _digests(ref)


@pytest.mark.parametrize("length", [1, 32, 64, 4096])
def test_cuda_skips_exactly_what_pallas_skips(length):
    recipes, ref_recipes = pload.class_recipes(length), \
        ref_class_recipes(length)
    assert sorted(recipes) == sorted(ref_recipes)
    for label in recipes:
        assert recipe_skip_reason(label, length, "cuda", recipes) == \
            ref_skip_reason(label, length, "pallas", ref_recipes), label
    skipped, ref_skipped = {}, {}
    classes = serve_classes(pbench.fresh_engine("cuda", "cpu"), length,
                            skipped=skipped)
    ref_classes = ref_serve_classes(
        REngine(backend="pallas", cache=RCache(memory_only=True)), length,
        skipped=ref_skipped)
    assert skipped == ref_skipped == {"div_loop": "loop-state+recirculation"}
    assert sorted(classes) == sorted(ref_classes)
    for label, art in classes.items():
        assert artifact_skip_reason(art, length, "cuda") == \
            ref_artifact_skip(ref_classes[label], length, "pallas") is None


def test_model_mix_labels_match_reference_registry():
    from repro_torch.workloads import MODEL_MIX
    assert MODEL_MIX == REF_MODEL_MIX
    assert sorted(pload.mix_recipes(64, "model")) == list(REF_MODEL_MIX)


def test_request_streams_match_reference():
    """Same seed -> same arrival times, class picks and input streams."""
    length = 48
    classes = serve_classes(pbench.fresh_engine("sim"), length)
    ref_classes = ref_serve_classes(
        REngine(cache=RCache(memory_only=True)), length)
    rng, ref_rng = np.random.default_rng(9), np.random.default_rng(9)
    times = poisson_arrival_times(rng, 60, 0.1)
    np.testing.assert_array_equal(times, ref_poisson(ref_rng, 60, 0.1))
    got = make_labeled_requests(classes, times, length, rng)
    want = ref_labeled_requests(ref_classes, times, length, ref_rng)
    assert [(t, label) for t, label, _ in got] == \
        [(t, label) for t, label, _ in want]
    for (_, _, ins), (_, _, ref_ins) in zip(got, want):
        assert sorted(ins) == sorted(ref_ins)
        for k in ins:
            np.testing.assert_array_equal(ins[k], ref_ins[k])


def test_cuda_cpu_soak_matches_reference_pallas():
    """The reference's pallas soak (interpret mode, 24 requests at load
    2.0 of the sim capacity) against the port's cuda backend on the
    CPU."""
    mean_us = pbench.calibrate("sim", PIN_LENGTH)
    rate = PIN["offered_load"] / mean_us
    serve, rep = pbench.soak(PIN["seed"], 24, PIN_LENGTH, "cuda",
                             rate_per_us=rate, device="cpu")
    _, ref = rbench.soak(PIN["seed"], 24, PIN_LENGTH, "pallas",
                         rate_per_us=rate)
    for k in ("offered", "served", "rejected", "failed", "preemptions",
              "batches", "close_reasons", "config_cycles_paid",
              "config_cycles_naive", "now_us"):
        assert rep[k] == ref[k], k
    assert rep["served"] == 24 and rep["failed"] == 0
    assert serve.engine.stats.lane_batches > 0
    assert serve.engine.stats.lane_batch_failures == 0
    trace_digest, results_digest, per_class = _renamed(serve, rep,
                                                       PIN_LENGTH)
    assert (trace_digest, results_digest) == _digests(ref)
    assert per_class == ref["latency"].pop("per_class")
    rep["latency"].pop("per_class")
    assert rep["latency"] == ref["latency"]


@pytest.mark.parametrize("seed,n,load", [(0, 60, 2.0), (3, 40, 0.5)])
def test_cuda_cpu_soak_matches_single_run_oracle(seed, n, load):
    """Every value the cuda soak served (lane-batched flushes and
    preemptible multi-shot plans) equals ``Engine.run`` of the same request
    on a fresh engine: the results digest is rebuilt from the oracle."""
    length = 64
    mean_us = pbench.calibrate("cuda", length, device="cpu")
    rate = load / mean_us
    serve, rep = pbench.soak(seed, n, length, "cuda", rate_per_us=rate,
                             device="cpu")
    assert rep["failed"] == 0 and rep["served"] > 0
    oracle = pbench.fresh_engine("cuda", "cpu")
    oclasses = serve_classes(oracle, length)
    rng = np.random.default_rng(seed)
    times = poisson_arrival_times(rng, n, rate)
    stream = make_labeled_requests(oclasses, times, length, rng)
    by_rid = {tk.rid: tk for tk in serve.served}
    for rid, (_, label, ins) in enumerate(stream):
        tk = by_rid.get(rid)
        if tk is None:
            continue
        for k in ins:                    # the soak served this request
            np.testing.assert_array_equal(tk.inputs[k], ins[k])
        tk.outputs = oracle.run(oclasses[label], ins)
    assert serve.results_digest() == rep["results_digest"]
    assert oracle.stats.lane_batch_failures == 0
