"""``repro_torch.workloads``: the model-layer classes on the port, the
counterpart of ``tests/test_workloads.py``.

  * **registry contract** — eight classes over the transformer / attention
    / SSM / MoE layers, one demand-gated loop and one multi-shot plan, and
    every registered input-stream name matches the traced DFG;
  * **differential gate** — every class bit-exact against its oracle on
    seeded inputs on ``"sim"`` and on ``Engine(backend="cuda",
    device="cpu")`` (the lane kernel's plain version), unless its
    ``pallas_skip`` names why ``"cuda"`` cannot lower it;
  * **capability coverage** — the recipe-level and artifact-level skip
    reasons on ``"cuda"`` equal ``pallas_skip``, and ``serve_classes``
    drops exactly those classes, by name;
  * **float semantics** — each fixed-point kernel within its stated
    tolerance of the float layer op;
  * **soak** — the model mix served by ``ServeEngine`` and a two-fabric
    ``FleetEngine`` under the virtual clock: accounting holds, preemption
    hits the multi-shot class, every response re-verifies against its
    oracle, and digests replay in-process and across OS processes.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import bench_serve as pbench
from repro_torch.engine import ArtifactCache, Engine
from repro_torch.engine.capabilities import FEATURE_DESC, CapabilityError
from repro_torch.serve import (artifact_skip_reason, compile_recipe,
                               mix_recipes, model_classes,
                               recipe_skip_reason, request_inputs,
                               serve_classes)
from repro_torch.workloads import (MODEL_CLASSES, MODEL_MIX, model_recipes,
                                   model_weights, workload_input_gen)

LENGTH = 32
SEEDS = (0, 1, 2)
LABELS = sorted(MODEL_CLASSES)

# one in-memory artifact cache for the module: place & route runs once per
# (class, backend, length) however many tests touch the class
_CACHE = ArtifactCache(memory_only=True)
_ARTS = {}


def _engine(backend="sim"):
    kw = {"device": "cpu"} if backend == "cuda" else {}
    return Engine(backend=backend, cache=_CACHE, **kw)


def _artifact(label, backend="sim", length=LENGTH):
    key = (label, backend, length)
    if key not in _ARTS:
        _ARTS[key] = compile_recipe(_engine(backend), label, length,
                                    model_recipes(length))
    return _ARTS[key]


def _assert_oracle_exact(label, backend, seed, length=LENGTH):
    wc = MODEL_CLASSES[label]
    eng = _engine(backend)
    ins = wc.gen_inputs(length, np.random.default_rng(seed))
    out = eng.run(_artifact(label, backend, length), ins)
    want = wc.oracle(**ins)
    assert len(out) == len(want), (label, sorted(out), len(want))
    for i, w in enumerate(want):
        assert w.dtype == np.int32
        np.testing.assert_array_equal(
            np.ravel(np.asarray(out[f"out{i}"])), np.ravel(w),
            err_msg=f"{label}/{backend} seed={seed} out{i} diverged from "
                    f"the oracle")


# ---------------------------------------------------------------------------
# registry contract
# ---------------------------------------------------------------------------

def test_registry_covers_model_layers():
    assert len(MODEL_CLASSES) == 8
    layers = {wc.layer for wc in MODEL_CLASSES.values()}
    assert layers == {"transformer", "attention", "ssm", "moe"}
    assert MODEL_MIX == tuple(LABELS)
    for label, wc in MODEL_CLASSES.items():
        assert wc.label == label
        assert wc.weight > 0
        assert wc.description and wc.exactness
    assert set(model_weights()) == set(MODEL_CLASSES)
    assert {l: dict(kw) for l, (_, kw) in model_recipes(LENGTH).items()} \
        == {l: dict(wc.compile_kwargs) for l, wc in MODEL_CLASSES.items()}


def test_mix_has_demand_gated_loop_and_multishot():
    arts = {l: _artifact(l) for l in LABELS}
    assert arts["ssm_relax"].dfg.has_recirculation()
    assert arts["swiglu_ms"].n_shots > 1
    assert {l: a.n_shots for l, a in arts.items() if a.n_shots > 1} == \
        {"swiglu_ms": 3, "ssm_relax": 2}


@pytest.mark.parametrize("label", LABELS)
def test_traced_inputs_match_registered_generator(label):
    """The registry's input ranges feed the exact stream names the traced
    DFG consumes, in the same order (the rng-replay contract)."""
    wc = MODEL_CLASSES[label]
    art = _artifact(label)
    assert list(art.dfg.inputs) == list(wc.inputs)
    gen = workload_input_gen(label)
    a = gen(LENGTH, np.random.default_rng(3))
    b = wc.gen_inputs(LENGTH, np.random.default_rng(3))
    for name, (lo, hi) in wc.inputs.items():
        np.testing.assert_array_equal(a[name], b[name])
        assert a[name].dtype == np.int32
        assert a[name].min() >= lo and a[name].max() < hi
    # request_inputs draws a model label's streams from the registry
    c = request_inputs(art, LENGTH, np.random.default_rng(3), label=label)
    for name in wc.inputs:
        np.testing.assert_array_equal(c[name], a[name])
    assert workload_input_gen("relu") is None


# ---------------------------------------------------------------------------
# differential gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", LABELS)
def test_oracle_exact_on_sim(label):
    for seed in SEEDS:
        _assert_oracle_exact(label, "sim", seed)


@pytest.mark.parametrize("label", LABELS)
def test_oracle_exact_on_cuda_plain_version(label):
    wc = MODEL_CLASSES[label]
    if wc.pallas_skip is not None:
        with pytest.raises(CapabilityError) as e:
            _artifact(label, "cuda")
        for feature in wc.pallas_skip.split("+"):
            assert f"[{feature}]" in str(e.value), str(e.value)
        return
    for seed in SEEDS[:2]:
        _assert_oracle_exact(label, "cuda", seed)


@pytest.mark.parametrize("label,length,seed", [
    (label, length, seed) for label in LABELS
    for length, seed in ((16, 11), (64, 12345))])
def test_oracle_exact_across_lengths(label, length, seed):
    """Oracle equivalence is not an artifact of one length or seed."""
    _assert_oracle_exact(label, "sim", seed, length=length)


@pytest.mark.parametrize("label,backend", [
    (label, backend) for label in LABELS for backend in ("sim", "cuda")
    if backend == "sim" or MODEL_CLASSES[label].pallas_skip is None])
def test_float_semantics_within_stated_tolerance(label, backend):
    wc = MODEL_CLASSES[label]
    eng = _engine(backend)
    for seed in SEEDS:
        ins = wc.gen_inputs(LENGTH, np.random.default_rng(seed))
        out = eng.run(_artifact(label, backend), ins)
        outs = [np.ravel(np.asarray(out[f"out{i}"]))
                for i in range(len(out))]
        got, want, atol = wc.float_ref(ins, outs)
        err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
        assert err <= atol, (f"{label} seed={seed}: float deviation "
                             f"{err:.4f} > stated atol {atol}")


# ---------------------------------------------------------------------------
# capability coverage + one source of truth
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", LABELS)
def test_expected_cuda_capability(label):
    """The ``"cuda"`` skip reason, probed on the recipe and on the
    compiled plan, is the registry's ``pallas_skip``: a '+'-join of named
    capability features."""
    wc = MODEL_CLASSES[label]
    recipes = model_recipes(LENGTH)
    reason = recipe_skip_reason(label, LENGTH, "cuda", recipes)
    assert reason == wc.pallas_skip
    assert artifact_skip_reason(_artifact(label), LENGTH,
                                "cuda") == wc.pallas_skip
    assert recipe_skip_reason(label, LENGTH, "sim", recipes) is None
    for feature in (reason or "").split("+"):
        assert not feature or feature in FEATURE_DESC, feature


def test_serve_classes_single_source_of_truth():
    expect_skip = {l: wc.pallas_skip for l, wc in MODEL_CLASSES.items()
                   if wc.pallas_skip is not None}
    assert expect_skip == {"ssm_scan": "loop-state",
                           "ssm_relax": "loop-state+recirculation"}
    skipped = {}
    served = model_classes(_engine("cuda"), LENGTH, skipped=skipped)
    assert skipped == expect_skip
    assert set(served) == set(MODEL_CLASSES) - set(expect_skip)
    assert set(model_classes(_engine(), LENGTH)) == set(MODEL_CLASSES)
    skipped = {}
    both = serve_classes(_engine("cuda"), LENGTH, mix="all",
                         skipped=skipped)
    assert skipped == dict(expect_skip, div_loop="loop-state+recirculation")
    assert len(both) == 6 + 8 - 3


def test_mix_all_merges_and_refuses_label_collisions(monkeypatch):
    merged = mix_recipes(LENGTH, "all")
    assert set(merged) == set(mix_recipes(LENGTH, "paper")) | set(MODEL_MIX)
    assert len(merged) == 14
    from repro_torch.workloads import registry
    monkeypatch.setitem(registry.MODEL_CLASSES, "relu",
                        registry.MODEL_CLASSES["silu_q"])
    with pytest.raises(ValueError, match=r"collide.*\['relu'\]"):
        mix_recipes(LENGTH, "all")


# ---------------------------------------------------------------------------
# serve / fleet soak over the model mix
# ---------------------------------------------------------------------------

def _model_soak(seed=0, n=150):
    return pbench.soak(seed=seed, n_requests=n, length=LENGTH,
                       backend="sim", rate_per_us=0.4, mix="model")


def test_model_mix_serve_soak():
    sv, rep = _model_soak()
    assert rep["offered"] == 150
    assert rep["offered"] == rep["served"] + rep["rejected"] + rep["failed"]
    assert rep["failed"] == 0
    assert len({tk.cls for tk in sv.served}) == len(MODEL_CLASSES)
    assert rep["preemptions"] >= 1
    assert any(tk.artifact.n_shots > 1 for tk in sv.served)
    assert rep["oracle_mismatches"] == 0
    assert rep["oracle_checked"] == rep["served"]
    _, rep2 = _model_soak()
    assert rep["trace_digest"] == rep2["trace_digest"]
    assert rep["results_digest"] == rep2["results_digest"]


def test_verify_model_outputs_counts_a_corrupted_response():
    sv, rep = _model_soak(n=30)
    classes = model_classes(_engine(), LENGTH)
    assert pbench.verify_model_outputs(sv, classes) == (rep["served"], 0)
    tk = sv.served[0]
    tk.outputs = {k: np.asarray(v) + 1 for k, v in tk.outputs.items()}
    assert pbench.verify_model_outputs(sv, classes) == (rep["served"], 1)


def _model_fleet(seed=11, n=60):
    from repro_torch.fleet import fleet_soak, homogeneous
    cfg = homogeneous(2, n_requests=n, rate_per_us=0.3, length=LENGTH,
                      classes=MODEL_MIX,
                      weights=tuple(sorted(model_weights().items())))
    return fleet_soak(seed, cfg, cache=ArtifactCache(memory_only=True))


def test_model_mix_fleet_soak_two_fabrics():
    fleet, rep = _model_fleet()
    assert rep["offered"] == 60
    assert rep["offered"] == rep["served"] + rep["rejected"] + rep["failed"]
    assert rep["failed"] == 0 and rep["unroutable"] == 0
    assert set(rep["placements"]) == set(MODEL_MIX)
    assert len(set(rep["placements"].values())) == 2
    names = {a.name: l for l, a in model_classes(_engine(), LENGTH).items()}
    checked = 0
    for w in fleet.workers:
        for tk in w.serve.served:
            want = MODEL_CLASSES[names[tk.artifact.name]].oracle(**tk.inputs)
            for i, wv in enumerate(want):
                np.testing.assert_array_equal(
                    np.ravel(np.asarray(tk.outputs[f"out{i}"])),
                    np.ravel(wv), err_msg=f"{w.name}/{tk.cls} rid={tk.rid}")
            checked += 1
    assert checked == rep["served"]
    fleet2, rep2 = _model_fleet()
    assert rep["trace_digest"] == rep2["trace_digest"]
    assert fleet.results_digest() == fleet2.results_digest()


def test_model_soak_replays_across_processes():
    prog = (
        "from repro_torch.bench_serve import soak; "
        "from repro_torch.engine import ArtifactCache; "
        "from repro_torch.fleet import fleet_soak, homogeneous; "
        "from repro_torch.workloads import MODEL_MIX, model_weights; "
        "sv, rep = soak(seed=9, n_requests=40, length=32, backend='sim', "
        "rate_per_us=0.4, mix='model'); "
        "cfg = homogeneous(2, n_requests=30, rate_per_us=0.3, length=32, "
        "classes=MODEL_MIX, "
        "weights=tuple(sorted(model_weights().items()))); "
        "fl, frep = fleet_soak(9, cfg, "
        "cache=ArtifactCache(memory_only=True)); "
        "assert rep['oracle_mismatches'] == 0, rep; "
        "print(rep['trace_digest'], rep['results_digest'], "
        "frep['trace_digest'], fl.results_digest())")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               STRELA_CACHE="0")
    digests = set()
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", prog], cwd=root,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        digests.add(out.stdout.strip())
    assert len(digests) == 1, f"cross-process replay diverged: {digests}"
