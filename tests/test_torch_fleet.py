"""``repro_torch.fleet``: the multi-fabric fleet on the port.

The first part is the counterpart of ``tests/test_fleet.py``, test for
test, on the port's classes:

  * **oracle** — a seeded fleet soak's served outputs are bit-exact
    against one plain ``Engine.run`` per request on a single 4x4;
  * **determinism** — the fixed-seed soak (with a scripted mid-soak
    fabric failure) replays bit-identically in-process and across two OS
    processes (trace digest + results digest);
  * **accounting** — offered == served + rejected + failed fleet-wide
    (unroutable rejections included), rids globally unique;
  * **placement** — pins on the measured-cheapest feasible fabric,
    homogeneous ties spread round-robin, deep pinned queues overflow to
    the least-loaded feasible peer, a class no live fabric can serve is
    rejected *by name*;
  * **fault-drain** — killing a fabric moves its backlog to surviving
    peers in rid order, loses nothing, duplicates nothing; a double-kill
    is a no-op;
  * **DSE** — the geometry sweep ranks measured costs and ``provision``
    always yields a fleet that serves the whole mix;
  * **config validation**.

The second part holds the port to the reference ``repro.fleet``:
``perf_baseline.json``'s ``fleet`` pins, ``FleetConfig.digest()``,
``trace_digest`` and ``results_digest`` equal on ``"sim"``, the DSE table,
the model-mix fleet, and the ``"cuda"`` backend on the CPU (its values
equal ``"sim"``'s).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from jax import lax

import repro.workloads.kernels as RWK
from repro.engine import ArtifactCache as RCache
from repro.fleet import FabricSpec as RFabricSpec
from repro.fleet import FleetConfig as RFleetConfig
from repro.fleet import dse as rdse
from repro.fleet import fleet_soak as ref_fleet_soak
from repro.fleet import homogeneous as ref_homogeneous
from repro.serve import serve_classes as ref_serve_classes
from repro.engine import Engine as REngine
from repro_torch.core.fabric import Fabric
from repro_torch.engine import ArtifactCache, Engine
from repro_torch.fleet import (DEFAULT_CLASSES, ClassCost, FabricSpec,
                               FleetConfig, FleetEngine, Router,
                               UnroutableError, fleet_soak, fleet_workload,
                               homogeneous, measure_class_costs)
from repro_torch.fleet import dse
from repro_torch.serve import AdmissionError
from repro_torch.serve.load import serve_classes
from repro_torch.workloads import MODEL_CLASSES, MODEL_MIX, model_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "benchmarks", "perf_baseline.json")) as _f:
    PIN = json.load(_f)["fleet"]
LENGTH = 32
SHORT = ("relu", "vadd", "mac1")


def _cache():
    return ArtifactCache(memory_only=True)


def _soak(seed=7, n=120, rate=0.4, classes=SHORT, fabrics=2, **kw):
    cfg = homogeneous(fabrics, n_requests=n, rate_per_us=rate,
                      classes=classes, length=LENGTH, **kw)
    return fleet_soak(seed, cfg, cache=_cache())


# ---------------------------------------------------------------------------
# oracle + accounting
# ---------------------------------------------------------------------------

def test_fleet_results_bit_exact_vs_single_engine_oracle():
    cfg = homogeneous(3, n_requests=150, rate_per_us=0.5,
                      classes=DEFAULT_CLASSES, length=LENGTH)
    cache = _cache()
    fleet, rep = fleet_soak(9, cfg, cache=cache)
    assert rep["served"] > 0
    # oracle: same arrival stream, one plain Engine.run per request
    ref = Engine(Fabric(), backend="sim", cache=cache)
    classes = serve_classes(ref, LENGTH)
    arrivals = fleet_workload(9, cfg, cache=cache)
    outs = {rid: ref.run(classes[label], inputs)
            for rid, (_, label, inputs) in enumerate(arrivals)}
    for tk in fleet.served_tickets():
        want = outs[tk.rid]
        assert sorted(tk.outputs) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(
                np.asarray(tk.outputs[name]), np.asarray(want[name]),
                err_msg=f"rid {tk.rid} output {name} diverged")


def test_fleet_accounting_no_loss_no_duplicates():
    fleet, rep = _soak(n=200, rate=1.5, queue_capacity=6)
    assert rep["offered"] == 200
    assert rep["served"] + rep["rejected"] + rep["failed"] == 200
    assert rep["rejected"] > 0          # overdriven tiny queues must shed
    rids = [tk.rid for tk in fleet.served_tickets()]
    rids += [tk.rid for w in fleet.workers for tk in w.serve.rejected]
    assert len(rids) == len(set(rids))
    # per-fabric ledgers sum to the fleet totals
    pf = rep["per_fabric"].values()
    assert sum(f["served"] for f in pf) == rep["served"]
    assert sum(f["rejected"] for f in pf) + rep["unroutable"] \
        == rep["rejected"]


def test_fleet_report_shapes():
    _, rep = _soak(n=60)
    assert rep["fabrics"] == 2
    assert set(rep["placements"]) == set(SHORT)
    assert rep["steady_window_us"] and rep["steady_throughput_rps"] > 0
    for f in rep["per_fabric"].values():
        assert f["geometry"] == [4, 4, 4, 4]
        assert 0.0 <= f["utilization"] <= 1.0


# ---------------------------------------------------------------------------
# determinism (in-process and cross-process, with a scripted failure)
# ---------------------------------------------------------------------------

def test_fleet_soak_replays_bit_identically_in_process():
    kw = dict(seed=13, n=150, rate=0.8, fabrics=3,
              fail_at=(("f1", 60.0),))
    f1, r1 = _soak(**kw)
    f2, r2 = _soak(**kw)
    assert r1["trace_digest"] == r2["trace_digest"]
    assert f1.results_digest() == f2.results_digest()
    assert r1["dead"] == ["f1"] and r1["drained"] == r2["drained"]


def test_fleet_cross_process_determinism_with_mid_soak_failure():
    prog = (
        "from repro_torch.engine import ArtifactCache\n"
        "from repro_torch.fleet import fleet_soak, homogeneous\n"
        "cfg = homogeneous(3, n_requests=150, rate_per_us=0.8,\n"
        "                  classes=('relu', 'vadd', 'mac1'), length=32,\n"
        "                  fail_at=(('f1', 60.0),))\n"
        "fleet, rep = fleet_soak(13, cfg,\n"
        "                        cache=ArtifactCache(memory_only=True))\n"
        "print(rep['trace_digest'], fleet.results_digest())\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               STRELA_CACHE="0")
    digests = set()
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", prog], cwd=root,
                             env=env, capture_output=True, text=True,
                             check=True)
        digests.add(out.stdout.strip())
    assert len(digests) == 1, f"cross-process fleet replay diverged: {digests}"
    fleet, rep = _soak(seed=13, n=150, rate=0.8, fabrics=3,
                       fail_at=(("f1", 60.0),))
    here = f"{rep['trace_digest']} {fleet.results_digest()}"
    assert digests == {here}, (digests, here)


# ---------------------------------------------------------------------------
# placement: pins, stealing, unroutable
# ---------------------------------------------------------------------------

def test_pins_prefer_measured_cheapest_geometry():
    cache = _cache()
    ranked = dse.sweep(classes=DEFAULT_CLASSES, length=LENGTH, cache=cache)
    cfg = FleetConfig(fabrics=(
        FabricSpec(name="small", rows=2, cols=2, n_imns=2, n_omns=2),
        FabricSpec(name="big")), classes=DEFAULT_CLASSES, length=LENGTH)
    fleet = FleetEngine(cfg, cache=cache)
    # the sweep and the fleet measured the same physics: each class pins
    # to whichever of the two geometries the sweep ranks cheaper
    for label in DEFAULT_CLASSES:
        best = next(c.geometry for c in ranked[label] if c.feasible)
        want = "small" if best == (2, 2, 2, 2) else "big"
        feas = {c.geometry for c in ranked[label] if c.feasible}
        if (2, 2, 2, 2) not in feas:
            want = "big"                # e.g. div_loop: 4x4 only
        assert fleet.router.pin(label) == want, label


def test_homogeneous_pins_spread_round_robin():
    fleet, _ = _soak(n=10, classes=DEFAULT_CLASSES, fabrics=4,
                     rate=0.05)
    owners = [fleet.router.pin(l) for l in sorted(DEFAULT_CLASSES)]
    # 6 classes over 4 identical fabrics: every fabric gets at least one
    # pin and none gets more than two
    assert set(owners) == {"f0", "f1", "f2", "f3"}
    assert max(owners.count(w) for w in set(owners)) == 2


def test_work_stealing_overflows_deep_pinned_queue():
    fleet, rep = _soak(seed=1, n=200, rate=2.0, classes=("relu",),
                       fabrics=3, steal_depth=2)
    assert rep["steals"] > 0
    stolen_to = {ev[4] for ev in fleet.trace
                 if ev[0] == "route" and ev[5] == "steal"}
    assert stolen_to and "f0" not in stolen_to   # pin is f0; steals go out
    served_by = {w.name: len(w.serve.served) for w in fleet.workers}
    assert sum(1 for n in served_by.values() if n > 0) >= 2


def test_router_steal_picks_least_loaded_feasible_peer():
    costs = {w: {"k": ClassCost(
        label="k", geometry=(4, 4, 4, 4), feasible=True, service_us=1.0)}
        for w in ("a", "b", "c")}
    r = Router(["a", "b", "c"], costs, steal_depth=2)
    assert r.pin("k") == "a"
    name, how = r.place("k", {"a": 5, "b": 1, "c": 1},
                        {"a": 9.0, "b": 4.0, "c": 2.0}, frozenset())
    assert (name, how) == ("c", "steal")
    # below steal_depth the pin holds regardless of load
    assert r.place("k", {"a": 1}, {"a": 9.0}, frozenset()) == ("a", "pin")
    with pytest.raises(UnroutableError):
        r.place("k", {}, {}, frozenset({"a", "b", "c"}))


def test_unroutable_class_rejected_by_name_after_fabric_death():
    # div_loop maps only on the 4x4; kill it mid-soak and every div
    # request after the failure must be rejected with a named error —
    # never silently dropped, never misrouted onto a 2x2
    cfg = FleetConfig(
        fabrics=(FabricSpec(name="s0", rows=2, cols=2, n_imns=2, n_omns=2),
                 FabricSpec(name="s1", rows=2, cols=2, n_imns=2, n_omns=2),
                 FabricSpec(name="big")),
        classes=("relu", "div_loop"), length=LENGTH,
        n_requests=80, rate_per_us=0.2, fail_at=(("big", 100.0),))
    fleet, rep = fleet_soak(3, cfg, cache=_cache())
    assert rep["dead"] == ["big"]
    assert rep["offered"] == 80
    assert rep["served"] + rep["rejected"] + rep["failed"] == 80
    assert fleet.unroutable, "no div arrivals after the failure?"
    for tk in fleet.unroutable:
        assert isinstance(tk.error, AdmissionError)
        assert "div_loop" in str(tk.error)
    # relu kept flowing on the survivors
    assert any(len(w.serve.served) > 0 for w in fleet.workers[:2])


def test_fleet_init_rejects_globally_infeasible_class():
    cfg = FleetConfig(
        fabrics=(FabricSpec(name="s0", rows=2, cols=2, n_imns=2,
                            n_omns=2),),
        classes=("relu", "div_loop"), length=LENGTH)
    with pytest.raises(ValueError, match="div_loop"):
        FleetEngine(cfg, cache=_cache())


# ---------------------------------------------------------------------------
# fault-drain
# ---------------------------------------------------------------------------

def test_fault_drain_loses_nothing_and_keeps_class_fifo():
    fleet, rep = _soak(seed=21, n=250, rate=1.2, fabrics=3,
                       fail_at=(("f0", 50.0),))
    assert rep["offered"] == 250
    assert rep["served"] + rep["rejected"] + rep["failed"] == 250
    assert rep["drained"] > 0 and rep["dead"] == ["f0"]
    rids = [tk.rid for tk in fleet.served_tickets()]
    assert len(rids) == len(set(rids))


def test_fault_drain_requeues_in_rid_order():
    # route a backlog by hand (no pumping, nothing dispatches), then kill
    # f0: every surviving class FIFO must hold its tickets in rid order —
    # drained tickets splice *into* the peers' queues, not onto the end
    cfg = homogeneous(3, n_requests=40, rate_per_us=0.2, classes=SHORT,
                      length=LENGTH)
    cache = _cache()
    fleet = FleetEngine(cfg, cache=cache)
    for t, label, inputs in fleet_workload(21, cfg, cache=cache)[:24]:
        fleet._route(t, label, inputs)
    assert any(q for q in fleet.workers[0].serve._queues.values())
    fleet.fail_fabric("f0", t=1e6)
    assert fleet.drained > 0
    for w in fleet.workers[1:]:
        for cls, q in w.serve._queues.items():
            seq = [tk.rid for tk in q]
            assert seq == sorted(seq), (w.name, cls, seq)


def test_fail_fabric_is_idempotent_and_dead_gets_no_routes():
    fleet, rep = _soak(seed=21, n=250, rate=1.2, fabrics=3,
                       fail_at=(("f0", 50.0),))
    # no route or drain ever targeted the dead fabric after its death
    for ev in fleet.trace:
        if ev[0] == "route" and ev[1] >= 50.0:
            assert ev[4] != "f0", ev
        if ev[0] == "drain":
            assert ev[4] != "f0", ev
    assert fleet.fail_fabric("f0") == []
    assert rep["per_fabric"]["f0"]["alive"] is False


# ---------------------------------------------------------------------------
# DSE + provisioning
# ---------------------------------------------------------------------------

def test_dse_sweep_ranks_real_costs():
    ranked = dse.sweep(classes=("relu", "fft", "div_loop"), length=LENGTH,
                       cache=_cache())
    relu = ranked["relu"]
    assert relu[0].feasible and relu[0].geometry == (2, 2, 2, 2)
    assert [c.service_us for c in relu if c.feasible] == sorted(
        c.service_us for c in relu if c.feasible)
    # fft inverts: needs column width, so 4x4 beats 2x2 hard
    fft = ranked["fft"]
    assert fft[0].geometry == (4, 4, 4, 4)
    # div_loop is 4x4-only, and the infeasible entries carry named errors
    div = ranked["div_loop"]
    assert next(c.geometry for c in div if c.feasible) == (4, 4, 4, 4)
    assert all(c.error for c in div if not c.feasible)


def test_provision_always_covers_the_mix():
    cache = _cache()
    ranked = dse.sweep(classes=DEFAULT_CLASSES, length=LENGTH, cache=cache)
    for n in (1, 2, 4):
        cfg = dse.provision(ranked, n, length=LENGTH)
        assert len(cfg.fabrics) == n
        # must construct: FleetEngine raises if any class is uncovered
        FleetEngine(cfg, cache=cache)
    # short-kernel-heavy weighting pulls in small fabrics but must keep
    # one div_loop-capable 4x4 (the feasibility repair pass)
    cfg = dse.provision(ranked, 4, weights={"relu": 10.0, "vadd": 10.0},
                        length=LENGTH)
    geos = [s.geometry for s in cfg.fabrics]
    assert (4, 4, 4, 4) in geos and (2, 2, 2, 2) in geos


def test_measure_class_costs_names_infeasibility():
    costs, arts = measure_class_costs((2, 2, 2, 2), ("relu", "div_loop"),
                                      LENGTH, 0.01, 8, cache=_cache())
    assert costs["relu"].feasible and "relu" in arts
    assert not costs["div_loop"].feasible and "div_loop" not in arts
    assert costs["div_loop"].error


# ---------------------------------------------------------------------------
# config validation
# ---------------------------------------------------------------------------

def test_fleet_config_validation():
    with pytest.raises(ValueError, match="unique"):
        FleetConfig(fabrics=(FabricSpec(name="x"), FabricSpec(name="x")))
    with pytest.raises(ValueError, match="steal_depth"):
        homogeneous(2, steal_depth=0)
    with pytest.raises(ValueError, match="fail_at"):
        homogeneous(2, fail_at=(("nope", 1.0),))
    with pytest.raises(ValueError, match="weights"):
        homogeneous(2, weights=(("nope", 1.0),))
    with pytest.raises(ValueError):
        FleetConfig(fabrics=())


# ---------------------------------------------------------------------------
# the port against the reference fleet
# ---------------------------------------------------------------------------

def _lax_hswish(x):
    t = lax.min(lax.max(x + 3 * RWK.ONE, 0), 6 * RWK.ONE)
    p = (x * t) >> 9
    return (p * RWK.INV6_Q16) >> 16


def _both(**kw):
    """The same homogeneous config built by both packages."""
    cfg, ref = homogeneous(**kw), ref_homogeneous(**kw)
    assert cfg.digest() == ref.digest() and repr(cfg) == repr(ref)
    return cfg, ref


def test_pinned_fleet_soak_matches_reference():
    """``perf_baseline.json``'s fleet gate on the port: exact counts and
    drains, the virtual p99 within budget, and every digest equal to the
    reference soak's."""
    cfg, ref_cfg = _both(n=PIN["fabrics"], n_requests=PIN["requests"],
                         rate_per_us=PIN["rate_per_us"],
                         fail_at=((PIN["fail_fabric"], PIN["fail_at_us"]),))
    fleet, rep = fleet_soak(PIN["seed"], cfg, cache=_cache())
    ref_fleet, ref = ref_fleet_soak(PIN["seed"], ref_cfg,
                                    cache=RCache(memory_only=True))
    for k in ("served", "rejected", "failed", "drained"):
        assert rep[k] == PIN[k] == ref[k], k
    assert rep["offered"] == PIN["requests"]
    assert rep["dead"] == [PIN["fail_fabric"]] == ref["dead"]
    assert rep["latency"]["p99_us"] <= PIN["p99_budget_us"]
    assert rep["latency"] == ref["latency"]
    assert rep["config_digest"] == ref["config_digest"] == cfg.digest()
    assert rep["trace_digest"] == ref["trace_digest"]
    assert fleet.results_digest() == ref_fleet.results_digest()
    assert rep["placements"] == ref["placements"]
    assert rep["per_fabric"] == ref["per_fabric"]


@pytest.mark.parametrize("seed,kw", [
    (13, dict(n=3, n_requests=150, rate_per_us=0.8, classes=SHORT,
              length=LENGTH, fail_at=(("f1", 60.0),))),
    (1, dict(n=3, n_requests=120, rate_per_us=2.0, classes=("relu",),
             length=LENGTH, steal_depth=2)),
    (21, dict(n=3, n_requests=150, rate_per_us=1.2, length=LENGTH,
              queue_capacity=6, bursty=True, fail_at=(("f0", 50.0),))),
    (5, dict(n=2, n_requests=80, rate_per_us=0.5, length=LENGTH,
             weights=(("fft", 3.0), ("relu", 0.5)))),
])
def test_sim_fleet_digests_equal_reference(seed, kw):
    cfg, ref_cfg = _both(**kw)
    fleet, rep = fleet_soak(seed, cfg, cache=_cache())
    ref_fleet, ref = ref_fleet_soak(seed, ref_cfg,
                                    cache=RCache(memory_only=True))
    for k in ("offered", "served", "rejected", "failed", "unroutable",
              "steals", "drained", "dead", "now_us", "latency",
              "placements", "per_fabric", "trace_digest"):
        assert rep[k] == ref[k], k
    assert fleet.results_digest() == ref_fleet.results_digest()


def test_heterogeneous_fleet_and_dse_equal_reference():
    """The DSE table, a provisioned heterogeneous config and the
    unroutable-rejection soak equal the reference's."""
    table = dse.table(dse.sweep(length=LENGTH, cache=_cache()))
    ref_table = rdse.table(rdse.sweep(length=LENGTH,
                                      cache=RCache(memory_only=True)))
    assert len(table) == len(ref_table)
    assert [{k: v for k, v in r.items() if k != "error"} for r in table] == \
        [{k: v for k, v in r.items() if k != "error"} for r in ref_table]
    assert [bool(r["error"]) for r in table] == \
        [bool(r["error"]) for r in ref_table]
    ranked = dse.sweep(length=LENGTH, cache=_cache())
    ref_ranked = rdse.sweep(length=LENGTH, cache=RCache(memory_only=True))
    w = {"relu": 10.0, "vadd": 10.0}
    assert dse.provision(ranked, 4, weights=w, length=LENGTH).digest() == \
        rdse.provision(ref_ranked, 4, weights=w, length=LENGTH).digest()
    spec = dict(rows=2, cols=2, n_imns=2, n_omns=2)
    kw = dict(classes=("relu", "div_loop"), length=LENGTH, n_requests=80,
              rate_per_us=0.2, fail_at=(("big", 100.0),))
    cfg = FleetConfig(fabrics=(FabricSpec(name="s0", **spec),
                               FabricSpec(name="s1", **spec),
                               FabricSpec(name="big")), **kw)
    ref_cfg = RFleetConfig(fabrics=(RFabricSpec(name="s0", **spec),
                                    RFabricSpec(name="s1", **spec),
                                    RFabricSpec(name="big")), **kw)
    assert cfg.digest() == ref_cfg.digest()
    fleet, rep = fleet_soak(3, cfg, cache=_cache())
    ref_fleet, ref = ref_fleet_soak(3, ref_cfg,
                                    cache=RCache(memory_only=True))
    assert rep["unroutable"] == ref["unroutable"] > 0
    assert rep["trace_digest"] == ref["trace_digest"]
    assert fleet.results_digest() == ref_fleet.results_digest()


def test_model_mix_fleet_equals_reference(monkeypatch):
    """The reference's two-fabric model-mix fleet (tests/test_workloads.py
    ``_model_fleet``) on the port: equal report, equal results digest, and
    an equal trace digest once each worker's config classes are renamed to
    the reference's (a traced class hashes its traced graph)."""
    monkeypatch.setattr(RWK, "_hswish", _lax_hswish)
    kw = dict(n=2, n_requests=60, rate_per_us=0.3, length=LENGTH,
              classes=MODEL_MIX,
              weights=tuple(sorted(model_weights().items())))
    cfg, ref_cfg = _both(**kw)
    fleet, rep = fleet_soak(11, cfg, cache=_cache())
    ref_fleet, ref = ref_fleet_soak(11, ref_cfg,
                                    cache=RCache(memory_only=True))
    for k in ("offered", "served", "rejected", "failed", "unroutable",
              "steals", "drained", "now_us", "latency", "placements",
              "per_fabric"):
        assert rep[k] == ref[k], k
    assert rep["served"] == 60
    assert fleet.results_digest() == ref_fleet.results_digest()
    port = serve_classes(Engine(cache=_cache()), LENGTH, mix="model")
    refc = ref_serve_classes(REngine(cache=RCache(memory_only=True)),
                             LENGTH, mix="model")
    names = {port[l].config_class: refc[l].config_class for l in port}
    assert rep["trace_digest"] != ref["trace_digest"]
    for w in fleet.workers:
        w.serve.trace = [tuple(names.get(x, x) if isinstance(x, str) else x
                               for x in ev) for ev in w.serve.trace]
    assert fleet.trace_digest() == ref["trace_digest"]
    for tk in fleet.served_tickets():
        wc = MODEL_CLASSES[fleet._rid_label[tk.rid]]
        for i, want in enumerate(wc.oracle(**tk.inputs)):
            np.testing.assert_array_equal(
                np.ravel(np.asarray(tk.outputs[f"out{i}"])), np.ravel(want))


CUDA_CLASSES = ("relu", "vadd", "fft", "mac1", "axpby_ms", "attn_score",
                "ln_affine", "moe_gate", "silu_q", "softmax_den",
                "swiglu_ms")


def test_cuda_fleet_on_the_cpu_gives_sim_values():
    """Three ``"cuda"`` fabrics (the lane kernel's plain version) over the
    11 classes ``"cuda"`` lowers, one fabric failing mid-soak: the same
    placements, accounting and results digest as the ``"sim"`` fleet, and
    every value equal to a single-``Engine.run`` oracle."""
    kw = dict(n_requests=90, rate_per_us=0.6, length=LENGTH,
              classes=CUDA_CLASSES, fail_at=(("f1", 40.0),))
    cfg = homogeneous(3, backend="cuda", **kw)
    fleet, rep = fleet_soak(6, cfg, cache=_cache(), device="cpu")
    sim_fleet, sim = fleet_soak(6, homogeneous(3, **kw), cache=_cache())
    assert all(w.engine.device.type == "cpu" for w in fleet.workers)
    assert rep["failed"] == 0 and rep["drained"] > 0
    assert rep["offered"] == 90 == rep["served"] + rep["rejected"] + \
        rep["failed"]
    for k in ("offered", "served", "rejected", "steals", "drained",
              "now_us", "latency", "placements"):
        assert rep[k] == sim[k], k
    assert fleet.results_digest() == sim_fleet.results_digest()
    assert sum(w.engine.stats.lane_batches for w in fleet.workers) > 0
    assert all(w.engine.stats.lane_batch_failures == 0
               for w in fleet.workers)
    oracle = Engine(backend="cuda", device="cpu", cache=_cache())
    arts = serve_classes(oracle, LENGTH, mix="all")
    stream = fleet_workload(6, cfg, cache=_cache())
    for tk in fleet.served_tickets():
        t, label, ins = stream[tk.rid]
        want = oracle.run(arts[label], ins)
        for k in want:
            np.testing.assert_array_equal(np.asarray(tk.outputs[k]),
                                          np.asarray(want[k]))


def test_all_cuda_fleet_refuses_a_loop_class_by_name():
    cfg = homogeneous(2, backend="cuda", classes=("relu", "ssm_relax"),
                      length=LENGTH)
    with pytest.raises(ValueError, match="ssm_relax"):
        FleetEngine(cfg, cache=_cache(), device="cpu")
    costs, _ = measure_class_costs((4, 4, 4, 4), ("ssm_scan",), LENGTH,
                                   0.01, 8, backend="cuda", cache=_cache(),
                                   device="cpu")
    assert not costs["ssm_scan"].feasible
    assert "loop-state" in costs["ssm_scan"].error
