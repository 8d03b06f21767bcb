"""``repro_torch.serve`` on ``Engine(backend="sim")``: the cases of
``tests/test_serve.py``, under the same names, held to the same contracts.

  * **soak** — 500+ seeded mixed requests over six config classes
    (short streaming kernels, a reduction, a multi-shot plan, an
    irregular loop) through the virtual-clock service loop, every served
    response bit-exact against a direct ``Engine.run`` oracle;
  * **determinism** — the fixed-seed soak replays bit-identically (same
    scheduling trace digest, same results digest) in-process and across
    two OS processes;
  * **accounting** — no request is ever lost or duplicated under
    preemption, rejection, and bursty overload: offered ==
    served + rejected + failed, rids unique, queues empty at drain;
  * **ordering** — FIFO within a config class, preserved across
    preemption/resume;
  * **preemption** — shot-boundary preemption strictly improves the
    short-kernel tail vs the same workload with preemption disabled;
  * **admission** — bounded-queue rejections are synchronous, named
    ``AdmissionError``\\ s; backpressure never deadlocks the loop;
  * **liveness** — a stalled backend (silent heartbeat) drains its class
    with named rejections instead of blocking callers forever;
  * **threaded front end** — ``Server.submit``/``Ticket.result`` round-
    trips exact results and drains clean on shutdown.

Property-based sweeps run under hypothesis when installed (CI profile);
seeded equivalents of every property always run regardless.
"""
import dataclasses
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    from hypothesis_stub import given, settings, st
    HAVE_HYPOTHESIS = False

from repro_torch.core import kernels_lib as K
from repro_torch.engine import ArtifactCache, Engine
from repro_torch.serve import (AdmissionError, LivenessProbe, ServeConfig,
                               Server, ServeEngine, VirtualClock,
                               bursty_arrival_times, make_requests,
                               poisson_arrival_times, request_inputs,
                               serve_classes)

LENGTH = 32


def _engine():
    return Engine(cache=ArtifactCache(memory_only=True))


def _workload(seed, n, rate_per_us=0.05, bursty=False, length=LENGTH,
              engine=None):
    engine = engine or _engine()
    classes = serve_classes(engine, length)
    rng = np.random.default_rng(seed)
    if bursty:
        times = bursty_arrival_times(rng, n, burst_size=12, gap_us=60.0)
    else:
        times = poisson_arrival_times(rng, n, rate_per_us)
    return engine, classes, make_requests(classes, times, length, rng)


def _drive(seed, n, cfg=None, **kw):
    engine, classes, reqs = _workload(seed, n, **kw)
    serve = ServeEngine(engine, cfg or ServeConfig())
    report = serve.drive(reqs)
    return serve, classes, report


def _check_accounting(serve, report):
    assert report["offered"] == (report["served"] + report["rejected"] +
                                 report["failed"])
    assert report["in_flight"] == 0, "drain left work behind"
    rids = [t.rid for t in serve.served + serve.rejected + serve.failed]
    assert len(rids) == len(set(rids)), "request duplicated"
    assert len(rids) == report["offered"], "request lost"


def _check_class_fifo(serve):
    """Within a config class, completion order == arrival order (rids are
    assigned in arrival order). Read from the trace so batch-internal
    ordering counts too."""
    by_rid = {t.rid: t for t in serve.served}
    done_order = {}
    for ev in serve.trace:
        if ev[0] == "complete":
            for rid in ev[2]:
                done_order.setdefault(by_rid[rid].cls, []).append(rid)
    for cls, rids in done_order.items():
        assert rids == sorted(rids), f"class {cls} served out of order"


def _check_oracle(serve, classes):
    """Every served response bit-exact vs direct Engine.run on a fresh
    engine (the conformance oracle)."""
    oracle = _engine()
    oclasses = serve_classes(oracle, LENGTH)
    by_name = {a.name: l for l, a in classes.items()}
    for tk in serve.served:
        want = oracle.run(oclasses[by_name[tk.artifact.name]], tk.inputs)
        assert set(want) == set(tk.outputs)
        for k in want:
            np.testing.assert_array_equal(tk.outputs[k], want[k],
                                          err_msg=f"rid {tk.rid} "
                                                  f"({tk.cls}) output {k}")


# ---------------------------------------------------------------------------
# the soak: 500 mixed requests, bit-exact, fully accounted
# ---------------------------------------------------------------------------

def test_soak_500_requests_bit_exact_vs_oracle():
    """>= 500 mixed requests across six config
    classes (incl. the multi-shot plan and the irregular loop) under the
    virtual clock; every served response equals ``Engine.run``; nothing
    lost or duplicated; class FIFO holds."""
    # roomy queue (serve everything) at a rate hot enough that the
    # multi-shot plan gets preempted for waiting short kernels
    cfg = ServeConfig(queue_capacity=600, preempt_wait_us=30.0)
    serve, classes, report = _drive(0, 500, cfg=cfg, rate_per_us=0.3)
    assert len(classes) >= 4
    assert report["served"] == 500 and report["rejected"] == 0
    assert report["preemptions"] > 0, "soak never exercised preemption"
    served_classes = {t.cls for t in serve.served}
    assert len(served_classes) >= 4
    assert any(t.artifact.n_shots > 1 for t in serve.served)
    assert any(t.artifact.dfg.has_recirculation() for t in serve.served)
    _check_accounting(serve, report)
    _check_class_fifo(serve)
    _check_oracle(serve, classes)
    # the service loop is the batching story at traffic level: the soak
    # must pay fewer config cycles than per-request dispatch would
    assert report["config_cycles_paid"] < report["config_cycles_naive"]


def test_soak_replays_bit_identically_in_process():
    s1, _, r1 = _drive(7, 120, bursty=True)
    s2, _, r2 = _drive(7, 120, bursty=True)
    assert r1["trace_digest"] == r2["trace_digest"]
    assert s1.results_digest() == s2.results_digest()
    assert r1["now_us"] == r2["now_us"]


def test_soak_replays_bit_identically_across_processes():
    """The acceptance criterion: same seed -> same scheduling trace and
    same results in a *separate OS process* (no hidden wall-time or
    hash-seed dependence)."""
    prog = ("from repro_torch.bench_serve import soak; "
            "sv, rep = soak(seed=5, n_requests=80, length=32, "
            "backend='sim', rate_per_us=0.05); "
            "print(rep['trace_digest'], rep['results_digest'])")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(root, "src"), root]),
               STRELA_CACHE="0")
    digests = set()
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", prog], cwd=root,
                             env=env, capture_output=True, text=True,
                             check=True)
        digests.add(out.stdout.strip())
    assert len(digests) == 1, f"cross-process replay diverged: {digests}"
    from repro_torch.bench_serve import soak
    _, rep = soak(seed=5, n_requests=80, length=32, backend="sim",
                  rate_per_us=0.05)
    here = f"{rep['trace_digest']} {rep['results_digest']}"
    assert digests == {here}, (digests, here)


# ---------------------------------------------------------------------------
# continuous batching policy
# ---------------------------------------------------------------------------

def test_batch_closes_on_size():
    """max_batch same-class arrivals at t=0 close immediately as one
    full batch."""
    engine = _engine()
    art = engine.compile(K.relu())
    rng = np.random.default_rng(0)
    reqs = [(0.0, art, request_inputs(art, LENGTH, rng))
            for _ in range(4)]
    serve = ServeEngine(engine, ServeConfig(max_batch=4, max_wait_us=1e6))
    rep = serve.drive(reqs)
    assert rep["served"] == 4
    assert rep["close_reasons"].get("size") == 1
    assert rep["batches"] == 1


def test_batch_closes_on_deadline_not_before():
    """A lone under-sized batch waits — and closes at max_wait_us, not
    at drain time, when more traffic is still expected."""
    engine = _engine()
    art = engine.compile(K.relu())
    rng = np.random.default_rng(0)
    reqs = [(0.0, art, request_inputs(art, LENGTH, rng)),
            (5.0, art, request_inputs(art, LENGTH, rng)),
            # far-future arrival keeps can_wait=True at the deadline
            (10_000.0, art, request_inputs(art, LENGTH, rng))]
    serve = ServeEngine(engine, ServeConfig(max_batch=8, max_wait_us=200.0))
    rep = serve.drive(reqs)
    assert rep["served"] == 3
    assert rep["close_reasons"].get("deadline") == 1
    closes = [ev for ev in serve.trace if ev[0] == "close"]
    # first close fires exactly at the head request's deadline, batching
    # both early arrivals together
    assert closes[0][1] == pytest.approx(200.0)
    assert len(closes[0][4]) == 2


def test_mixed_backlog_is_work_conserving():
    """With several classes queued the batcher never idles waiting for a
    fuller batch — it switches (close reason 'switch')."""
    engine = _engine()
    relu, vadd = engine.compile(K.relu()), engine.compile(K.vadd())
    rng = np.random.default_rng(0)
    reqs = [(0.0, relu, request_inputs(relu, LENGTH, rng)),
            (0.5, vadd, request_inputs(vadd, LENGTH, rng))]
    serve = ServeEngine(engine, ServeConfig(max_batch=8, max_wait_us=1e6))
    rep = serve.drive(reqs)
    assert rep["served"] == 2
    assert rep["close_reasons"].get("switch", 0) >= 1


def test_batching_beats_naive_under_load():
    """The serve-level acceptance claim on a plain workload: continuous
    batching pays strictly fewer config cycles than naive dispatch."""
    _, _, rep = _drive(3, 150, rate_per_us=0.2,
                       cfg=ServeConfig(queue_capacity=200))
    assert rep["config_cycles_paid"] < rep["config_cycles_naive"]
    assert rep["config_cycles_saved"] > 0


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

def _latency_tail_workload():
    """One long multi-shot plan at t=0, then a train of short relu
    requests arriving while it executes."""
    engine = _engine()
    plan = engine.compile(K.axpby(3, 5), pe_limit=1)     # 3 shots
    relu = engine.compile(K.relu())
    assert plan.n_shots > 1
    rng = np.random.default_rng(9)
    reqs = [(0.0, plan, request_inputs(plan, 256, rng))]
    reqs += [(1.0 + 0.1 * i, relu, request_inputs(relu, 256, rng))
             for i in range(10)]
    return engine, reqs, relu.config_class


def test_preemption_protects_short_kernel_latency():
    """Preempting the long plan at a shot boundary
    strictly improves the short class's tail latency vs running the plan
    to completion."""
    p99 = {}
    for label, wait in (("preempt", 1.0), ("no_preempt", 1e12)):
        engine, reqs, relu_cls = _latency_tail_workload()
        serve = ServeEngine(engine, ServeConfig(
            max_batch=4, max_wait_us=1e6, preempt_wait_us=wait))
        rep = serve.drive(reqs)
        assert rep["served"] == len(reqs)
        if label == "preempt":
            assert rep["preemptions"] >= 1
        else:
            assert rep["preemptions"] == 0
        # the relu class specifically is what preemption protects
        p99[label] = serve.slo.percentile(99, relu_cls)
    assert p99["preempt"] < p99["no_preempt"]


def test_preempted_plan_result_still_exact():
    engine, reqs, _ = _latency_tail_workload()
    serve = ServeEngine(engine, ServeConfig(max_batch=4, max_wait_us=1e6,
                                            preempt_wait_us=1.0))
    serve.drive(reqs)
    assert serve.preemptions >= 1
    plan_tk = next(t for t in serve.served if t.artifact.n_shots > 1)
    oracle = _engine()
    plan = oracle.compile(K.axpby(3, 5), pe_limit=1)
    want = oracle.run(plan, plan_tk.inputs)
    for k in want:
        np.testing.assert_array_equal(plan_tk.outputs[k], want[k])


def test_resumed_plan_runs_before_newer_same_class_work():
    """A preempted execution is part of its class's FIFO: it resumes
    before any later-arriving request of the same class dispatches."""
    serve, _, _ = _drive(0, 200,
                         cfg=ServeConfig(queue_capacity=300,
                                         preempt_wait_us=30.0),
                         rate_per_us=0.3)
    assert serve.preemptions > 0
    _check_class_fifo(serve)


# ---------------------------------------------------------------------------
# admission control and backpressure
# ---------------------------------------------------------------------------

def test_queue_full_rejects_with_named_error():
    engine = _engine()
    art = engine.compile(K.relu())
    rng = np.random.default_rng(0)
    serve = ServeEngine(engine, ServeConfig(queue_capacity=2))
    kept = [serve.offer(art, request_inputs(art, LENGTH, rng), t=0.0)
            for _ in range(2)]
    tk = serve.offer(art, request_inputs(art, LENGTH, rng), t=0.0)
    assert tk.status == "rejected"
    assert isinstance(tk.error, AdmissionError)
    assert "queue full (2/2)" in str(tk.error)
    assert str(tk.rid) in str(tk.error)
    with pytest.raises(AdmissionError, match="queue full"):
        tk.result()
    assert all(k.status == "queued" for k in kept)


def test_burst_overload_rejects_but_never_deadlocks_or_leaks():
    cfg = ServeConfig(queue_capacity=16, max_batch=4)
    serve, _, rep = _drive(11, 300, cfg=cfg, bursty=True)
    assert rep["rejected"] > 0, "burst never tripped admission control"
    assert rep["served"] > 0
    _check_accounting(serve, rep)
    for tk in serve.rejected:
        assert isinstance(tk.error, AdmissionError)


# ---------------------------------------------------------------------------
# property sweeps: seeded equivalents always run; hypothesis widens them
# ---------------------------------------------------------------------------

def _property_no_loss_no_duplication(seed, bursty, capacity):
    cfg = ServeConfig(queue_capacity=capacity, max_batch=4,
                      max_wait_us=150.0, preempt_wait_us=40.0)
    serve, _, rep = _drive(seed, 60, cfg=cfg, bursty=bursty,
                           rate_per_us=0.15)
    _check_accounting(serve, rep)
    _check_class_fifo(serve)
    for tk in serve.served:
        assert tk.outputs is not None and tk.error is None
    for tk in serve.rejected:
        assert isinstance(tk.error, AdmissionError)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("bursty", [False, True])
def test_no_loss_no_duplication_seeded(seed, bursty):
    _property_no_loss_no_duplication(seed, bursty,
                                     capacity=12 if bursty else 64)


@given(seed=st.integers(0, 2**16), bursty=st.booleans(),
       capacity=st.integers(4, 64))
@settings(max_examples=15, deadline=None)
def test_no_loss_no_duplication_property(seed, bursty, capacity):
    _property_no_loss_no_duplication(seed, bursty, capacity)


@pytest.mark.parametrize("seed", range(4))
def test_replay_determinism_seeded(seed):
    a = _drive(seed, 50, bursty=seed % 2 == 0)
    b = _drive(seed, 50, bursty=seed % 2 == 0)
    assert a[2]["trace_digest"] == b[2]["trace_digest"]
    assert a[0].results_digest() == b[0].results_digest()


# ---------------------------------------------------------------------------
# liveness: stalled backend drains its class with named rejections
# ---------------------------------------------------------------------------

def test_stalled_backend_drains_class(tmp_path):
    import time

    probe = LivenessProbe(str(tmp_path), timeout_s=5.0)
    engine = _engine()
    art = engine.compile(K.relu())
    rng = np.random.default_rng(0)
    serve = ServeEngine(engine, probe=probe)
    # healthy dispatch: heartbeat published, nothing stalled
    serve.offer(art, request_inputs(art, LENGTH, rng), t=0.0)
    serve._dispatch(art.config_class, "drain")
    assert probe.step >= 1
    assert serve.check_liveness(now=time.time()) == []
    # backlog builds while the backend goes silent
    queued = [serve.offer(art, request_inputs(art, LENGTH, rng), t=1.0)
              for _ in range(3)]
    drained = serve.check_liveness(now=time.time() + 6.0)
    assert {t.rid for t in drained} == {t.rid for t in queued}
    for tk in drained:
        assert tk.status == "rejected"
        assert isinstance(tk.error, AdmissionError)
        assert "stalled" in str(tk.error)
    # the drained class refuses new arrivals until reopened
    tk = serve.offer(art, request_inputs(art, LENGTH, rng), t=2.0)
    assert tk.status == "rejected" and "drained" in str(tk.error)
    serve.reopen_class(art.config_class)
    tk = serve.offer(art, request_inputs(art, LENGTH, rng), t=3.0)
    assert tk.status == "queued"
    serve._dispatch(art.config_class, "drain")
    assert tk.status == "done"
    _check_accounting(serve, serve.report())


def test_liveness_probe_roundtrip(tmp_path):
    import time

    probe = LivenessProbe(str(tmp_path), timeout_s=2.0)
    probe.beat()
    assert probe.stalled(now=time.time()) == []
    assert probe.stalled(now=time.time() + 3.0) != []
    probe.beat()
    assert probe.step == 2
    assert probe.stalled(now=time.time()) == []


# ---------------------------------------------------------------------------
# virtual clock + misc unit seams
# ---------------------------------------------------------------------------

def test_virtual_clock_monotonic():
    c = VirtualClock()
    assert c.virtual and c.now() == 0.0
    c.advance(5.0)
    c.advance_to(3.0)                  # never moves backwards
    assert c.now() == 5.0
    with pytest.raises(ValueError, match="backwards"):
        c.advance(-1.0)


def test_drive_requires_virtual_clock():
    from repro_torch.serve import WallClock
    serve = ServeEngine(_engine(), clock=WallClock())
    with pytest.raises(ValueError, match="VirtualClock"):
        serve.drive([])


def test_drive_rejects_unsorted_arrivals():
    engine = _engine()
    art = engine.compile(K.relu())
    rng = np.random.default_rng(0)
    ins = request_inputs(art, LENGTH, rng)
    serve = ServeEngine(engine)
    with pytest.raises(ValueError, match="sorted"):
        serve.drive([(5.0, art, ins), (1.0, art, ins)])


def test_invalid_request_fails_named_not_lost():
    """A request with bad inputs fails with the engine's named error and
    still shows up in the accounting — never silently dropped."""
    engine = _engine()
    art = engine.compile(K.vadd())
    rng = np.random.default_rng(0)
    good = request_inputs(art, LENGTH, rng)
    bad = {"x": good["x"]}                       # missing operand y
    serve = ServeEngine(engine)
    rep = serve.drive([(0.0, art, good), (0.0, art, bad)])
    assert rep["served"] == 1 and rep["failed"] == 1
    tk = serve.failed[0]
    with pytest.raises(Exception, match="missing input"):
        tk.result()
    _check_accounting(serve, rep)


# ---------------------------------------------------------------------------
# threaded always-on front end
# ---------------------------------------------------------------------------

def test_threaded_server_serves_exact_results():
    engine = _engine()
    classes = serve_classes(engine, LENGTH)
    rng = np.random.default_rng(1)
    oracle = _engine()
    oclasses = serve_classes(oracle, LENGTH)
    with Server(engine, ServeConfig(max_wait_us=500.0)) as srv:
        tickets = []
        for _ in range(3):
            for label, art in sorted(classes.items()):
                ins = request_inputs(art, LENGTH, rng)
                tickets.append((label, srv.submit(art, ins)))
        for label, tk in tickets:
            out = tk.result(timeout=60)
            want = oracle.run(oclasses[label], tk.inputs)
            for k in want:
                np.testing.assert_array_equal(out[k], want[k],
                                              err_msg=f"{label}/{k}")
    rep = srv.core.report()
    assert rep["served"] == len(tickets)
    assert not srv._thread.is_alive()


def test_threaded_server_stop_drains_then_refuses():
    engine = _engine()
    art = engine.compile(K.relu())
    rng = np.random.default_rng(2)
    srv = Server(engine)
    tk = srv.submit(art, request_inputs(art, LENGTH, rng))
    rep = srv.stop()
    assert tk.result(timeout=5) is not None
    assert rep["served"] == 1
    with pytest.raises(AdmissionError, match="stopping"):
        srv.submit(art, request_inputs(art, LENGTH, rng))


def test_threaded_server_stop_midplan_still_drains():
    """Regression: stop() while a multi-shot plan is executing. The
    worker's mid-plan ingest callback consumes the _STOP sentinel and
    records it only on the shared flag — the drain loop must fold that
    flag in, or the worker never satisfies its exit condition and stop()
    times out."""
    engine = _engine()
    ms = engine.compile(K.axpby(3, 5), pe_limit=1)
    assert ms.n_shots > 1
    started, release = threading.Event(), threading.Event()
    real_iter = engine.iter_shots

    def gated_iter(handle):
        for i, n in real_iter(handle):
            if i == 0:
                started.set()
                release.wait(10)    # hold the plan mid-flight
            yield i, n

    engine.iter_shots = gated_iter
    srv = Server(engine)
    tk = srv.submit(ms, request_inputs(ms, LENGTH,
                                       np.random.default_rng(3)))
    assert started.wait(10), "plan never started"
    rep = {}
    stopper = threading.Thread(
        target=lambda: rep.update(srv.stop(timeout=15)))
    stopper.start()
    for _ in range(5000):           # wait for _STOP to land in ingress
        if not srv._ingress.empty():
            break
        time.sleep(0.001)
    release.set()                   # shot 0 completes; ingest eats _STOP
    stopper.join(20)
    assert not stopper.is_alive(), "stop() hung mid-plan (drain broken)"
    assert not srv._thread.is_alive()
    assert rep["served"] == 1
    assert tk.result(timeout=5) is not None


def test_threaded_server_stop_rejects_raced_ingress_ticket():
    """Regression: a submit() that passes the _stopping check while
    stop() is completing can strand its ticket in the ingress queue after
    the worker exits. stop() must reject such leftovers by name instead
    of letting result() block forever."""
    from repro_torch.serve import loop as serve_loop
    engine = _engine()
    art = engine.compile(K.relu())
    srv = Server(engine)
    # replicate the race deterministically: retire the worker first...
    srv._stopping = True
    srv._ingress.put(serve_loop._STOP)
    srv._thread.join(15)
    assert not srv._thread.is_alive()
    # ...then enqueue the ticket a raced submit() would have left behind
    tk = serve_loop.Ticket(art, request_inputs(art, LENGTH,
                                               np.random.default_rng(4)))
    srv._ingress.put(tk)
    rep = srv.stop()
    assert tk.status == "rejected"
    with pytest.raises(AdmissionError, match="stopped"):
        tk.result(timeout=1)
    assert rep["rejected"] >= 1


def test_threaded_server_stamps_arrival_at_submit():
    """Regression: wall-clock latency must include ingress-queue wait —
    t_arrival is stamped client-side in submit(), not when the worker
    drains the queue."""
    engine = _engine()
    art = engine.compile(K.relu())
    with Server(engine) as srv:
        t0 = srv.core.clock.now()
        tk = srv.submit(art, request_inputs(art, LENGTH,
                                            np.random.default_rng(5)))
        t1 = srv.core.clock.now()
        assert tk.t_arrival is not None and t0 <= tk.t_arrival <= t1
        tk.result(timeout=30)
    assert tk.t_arrival <= tk.t_done
    assert tk.latency_us >= 0


def test_batch_sweep_stops_at_queued_multishot():
    """Regression: a multi-shot request queued behind single-shot
    requests of the same config class must not be swept into a
    submit/flush batch — it dispatches alone through iter_shots so it
    stays preemptible."""
    engine = _engine()
    relu = engine.compile(K.relu())
    ms = engine.compile(K.axpby(3, 5), pe_limit=1)
    assert ms.n_shots > 1
    # same-class single- and multi-shot artifacts cannot come out of
    # compile() today (the class embeds the compile key), so forge the
    # collision the sweep must survive
    ms = dataclasses.replace(ms, config_class=relu.config_class)
    rng = np.random.default_rng(6)
    reqs = [(0.0, relu, request_inputs(relu, LENGTH, rng)),
            (0.0, relu, request_inputs(relu, LENGTH, rng)),
            (0.0, ms, request_inputs(ms, LENGTH, rng)),
            (0.0, relu, request_inputs(relu, LENGTH, rng))]
    serve = ServeEngine(engine, ServeConfig())
    rep = serve.drive(reqs)
    assert rep["served"] == 4
    ms_rid = 2
    assert any(ev[0] == "shot" and ev[2] == ms_rid for ev in serve.trace), \
        "multi-shot request lost its preemptible iter_shots path"
    for ev in serve.trace:
        if ev[0] == "close" and ms_rid in ev[4]:
            assert ev[4] == (ms_rid,), \
                "multi-shot request swept into a single-shot batch"
    _check_accounting(serve, rep)
    _check_class_fifo(serve)
    oracle = _engine()
    oms = oracle.compile(K.axpby(3, 5), pe_limit=1)
    tk = next(t for t in serve.served if t.rid == ms_rid)
    want = oracle.run(oms, tk.inputs)
    for k in want:
        np.testing.assert_array_equal(tk.outputs[k], want[k])


def test_report_steady_window_bounds_the_service_span():
    """``steady_window_us`` spans first served arrival -> last completion:
    strictly positive, never wider than the wall duration, and the steady
    throughput it implies is at least the wall figure (the wall duration
    additionally counts the lead-in and drain tail: honest
    sustained-rate accounting for the benchmarks)."""
    serve, _, rep = _drive(3, 120, rate_per_us=0.02)
    steady = rep["steady_window_us"]
    assert steady == serve.steady_window_us()
    assert 0 < steady <= rep["now_us"]
    wall_rps = rep["served"] / rep["now_us"]
    assert rep["served"] / steady >= wall_rps
    first = min(tk.t_arrival for tk in serve.served)
    last = max(tk.t_done for tk in serve.served)
    assert steady == pytest.approx(last - first)
    # no served requests -> no window
    empty = ServeEngine(_engine(), ServeConfig())
    empty.drive([])
    assert empty.steady_window_us() is None


# ---------------------------------------------------------------------------
# the model-layer mix: served, and what cannot be served refused by name
# ---------------------------------------------------------------------------

def test_model_mix_and_model_labels_raise_by_name(monkeypatch):
    """``mix="model"``/``"all"`` compile the model-layer classes; an
    unknown mix, a label collision and a traced recipe the frontend cannot
    lower each raise naming what is wrong; a model label draws its
    registered streams and a paper label the generic ones."""
    from repro_torch.frontend import UnsupportedPrimitiveError
    from repro_torch.serve import load, mix_recipes, model_classes
    from repro_torch.workloads import MODEL_CLASSES, MODEL_MIX, registry
    engine = _engine()
    relu = engine.compile(K.relu())
    assert sorted(mix_recipes(LENGTH, "model")) == list(MODEL_MIX)
    assert set(mix_recipes(LENGTH, "all")) == \
        set(mix_recipes(LENGTH, "paper")) | set(MODEL_MIX)
    assert sorted(model_classes(engine, LENGTH)) == list(MODEL_MIX)
    with pytest.raises(ValueError, match="unknown mix 'paper\\+model'"):
        mix_recipes(LENGTH, "paper+model")
    with monkeypatch.context() as m:
        m.setitem(registry.MODEL_CLASSES, "vadd",
                  registry.MODEL_CLASSES["ln_affine"])
        with pytest.raises(ValueError, match=r"collide.*\['vadd'\]"):
            mix_recipes(LENGTH, "all")
    with pytest.raises(UnsupportedPrimitiveError, match="sort"):
        load.recipe_skip_reason("traced", LENGTH, "cuda",
                                {"traced": (lambda: (lambda x: x.sort()[0]),
                                            {})})
    for label in MODEL_MIX:
        got = request_inputs(relu, LENGTH, np.random.default_rng(0),
                             label=label)
        want = MODEL_CLASSES[label].gen_inputs(LENGTH,
                                               np.random.default_rng(0))
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    want = request_inputs(relu, LENGTH, np.random.default_rng(1))
    got = request_inputs(relu, LENGTH, np.random.default_rng(1),
                         label="relu")
    np.testing.assert_array_equal(got["x"], want["x"])
