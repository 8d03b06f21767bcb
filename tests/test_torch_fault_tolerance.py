"""``repro_torch.runtime.fault_tolerance``: the ``Heartbeat`` and
``HealthMonitor`` cases of ``tests/test_fault_tolerance.py``, under the
same names, on the port's copy of the two primitives the serving loop's
liveness probe is built on, and the serving side of the double-drain
idempotency case (``ServeEngine.drain_class``; the fleet is not ported).

Everything runs on explicit ``t``/``now`` overrides — no sleeping, no
wall-clock flakiness.
"""
import os

import numpy as np

from repro_torch.core import kernels_lib as K
from repro_torch.engine import ArtifactCache, Engine
from repro_torch.runtime.fault_tolerance import Heartbeat, HealthMonitor
from repro_torch.serve import AdmissionError, ServeEngine, request_inputs


# ---------------------------------------------------------------------------
# Heartbeat
# ---------------------------------------------------------------------------

def test_heartbeat_publish_and_read(tmp_path):
    hb = Heartbeat(str(tmp_path), host_id=3)
    hb.beat(7, t=100.0)
    mon = HealthMonitor(str(tmp_path), timeout_s=5.0)
    beats = mon.read()
    assert beats == {3: {"step": 7, "t": 100.0}}
    # a later beat atomically replaces the record
    hb.beat(8, t=101.5)
    assert mon.read()[3] == {"step": 8, "t": 101.5}


def test_heartbeat_expiry_on_wall_silence(tmp_path):
    hb = Heartbeat(str(tmp_path), host_id=0)
    hb.beat(1, t=100.0)
    mon = HealthMonitor(str(tmp_path), timeout_s=5.0, step_lag=None)
    assert mon.states(now=104.9) == {0: "live"}
    assert mon.states(now=105.0) == {0: "live"}     # boundary: not > timeout
    assert mon.states(now=105.1) == {0: "stalled"}
    assert mon.stalled(now=200.0) == [0]


def test_heartbeat_clear_retires_host(tmp_path):
    hb = Heartbeat(str(tmp_path), host_id=0)
    hb.beat(1, t=0.0)
    mon = HealthMonitor(str(tmp_path), timeout_s=1.0)
    assert mon.stalled(now=100.0) == [0]
    hb.clear()
    # retired host no longer appears in any verdict — it must not trip
    # the monitor as stalled forever
    assert mon.states(now=100.0) == {}
    assert mon.stalled(now=100.0) == []
    hb.clear()                                       # idempotent
    assert not os.path.exists(hb.path)


# ---------------------------------------------------------------------------
# HealthMonitor verdicts
# ---------------------------------------------------------------------------

def test_monitor_transitions_live_stalled_recovered(tmp_path):
    hb = Heartbeat(str(tmp_path), host_id=2)
    mon = HealthMonitor(str(tmp_path), timeout_s=10.0, step_lag=None)
    hb.beat(1, t=0.0)
    assert mon.states(now=5.0) == {2: "live"}
    assert mon.states(now=20.0) == {2: "stalled"}
    hb.beat(2, t=21.0)                               # host recovers
    assert mon.states(now=25.0) == {2: "live"}


def test_monitor_step_lag_flags_trailing_host(tmp_path):
    a, b = Heartbeat(str(tmp_path), 0), Heartbeat(str(tmp_path), 1)
    mon = HealthMonitor(str(tmp_path), timeout_s=1e9, step_lag=5)
    a.beat(100, t=0.0)
    b.beat(96, t=0.0)
    assert mon.states(now=0.0) == {0: "live", 1: "live"}   # lag 4 <= 5
    b.beat(94, t=0.0)
    assert mon.states(now=0.0) == {0: "live", 1: "stalled"}
    assert mon.stalled(now=0.0) == [1]


def test_monitor_step_lag_none_judges_wall_only(tmp_path):
    # serving-side mode: fabric workers legitimately diverge in dispatch
    # count, so arbitrary step lag must never flag a fresh heartbeat
    a, b = Heartbeat(str(tmp_path), 0), Heartbeat(str(tmp_path), 1)
    mon = HealthMonitor(str(tmp_path), timeout_s=5.0, step_lag=None)
    a.beat(10_000, t=100.0)
    b.beat(1, t=100.0)
    assert mon.states(now=101.0) == {0: "live", 1: "live"}
    b.beat(2, t=101.0)
    assert mon.states(now=105.5) == {0: "stalled", 1: "live"}


def test_monitor_ignores_corrupt_heartbeat(tmp_path):
    Heartbeat(str(tmp_path), 0).beat(1, t=0.0)
    with open(os.path.join(str(tmp_path), "host_00001.hb"), "w") as f:
        f.write("not json{")
    mon = HealthMonitor(str(tmp_path), timeout_s=5.0)
    assert set(mon.read()) == {0}
    assert mon.states(now=1.0) == {0: "live"}


def test_monitor_empty_and_missing_directory(tmp_path):
    mon = HealthMonitor(str(tmp_path / "nope"), timeout_s=5.0)
    assert mon.read() == {}
    assert mon.states(now=0.0) == {}
    assert mon.stalled(now=0.0) == []


# ---------------------------------------------------------------------------
# double-drain idempotency
# ---------------------------------------------------------------------------


def test_serve_drain_class_twice_is_idempotent():
    engine = Engine(cache=ArtifactCache(memory_only=True))
    relu, vadd = engine.compile(K.relu()), engine.compile(K.vadd())
    serve = ServeEngine(engine)
    rng = np.random.default_rng(11)
    # park a few requests in the queues without dispatching
    for i, art in enumerate((relu, vadd, relu, relu)):
        serve.offer(art, request_inputs(art, 32, rng), t=float(i))
    first = serve.drain_class(relu.config_class, "test stall")
    assert len(first) == 3 and all(isinstance(tk.error, AdmissionError)
                                   for tk in first)
    assert serve.drain_class(relu.config_class, "test stall") == []
    # rejected ledger saw each ticket exactly once
    rids = [tk.rid for tk in serve.rejected]
    assert len(rids) == len(set(rids)) == 3
    assert serve.report()["in_flight"] == 1          # vadd still queued
