"""Liveness primitives of the fault-tolerance runtime (counterpart of
``repro.runtime.fault_tolerance``, whose ``Heartbeat`` and
``HealthMonitor`` are copied here verbatim).

  * **heartbeats** — each host publishes a monotonic step heartbeat;
    ``HealthMonitor.stalled()`` flags hosts whose heartbeat lags the fleet
    (dead node or crashed process).

Heartbeats are files and monitors are pure functions of them. The serving
loop's :class:`repro_torch.serve.LivenessProbe` is built on both. The
training side of the reference module (``StragglerDetector``,
``elastic_remesh``, ``TrainSupervisor``) belongs to the LM stack and is
not ported yet.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------

class Heartbeat:
    """File-per-host heartbeat (stands in for the cluster KV store)."""

    def __init__(self, directory: str, host_id: int):
        self.path = os.path.join(directory, f"host_{host_id:05d}.hb")
        os.makedirs(directory, exist_ok=True)

    def beat(self, step: int, t: Optional[float] = None) -> None:
        """Publish one liveness record. ``t`` overrides the wall stamp
        for deterministic tests (defaults to ``time.time()``)."""
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step,
                       "t": time.time() if t is None else float(t)}, f)
        os.replace(tmp, self.path)

    def clear(self) -> None:
        """Retire this host: remove its heartbeat file so the monitor
        stops judging it (a drained fleet fabric is *retired*, not
        stalled — it must not keep tripping the monitor forever)."""
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


class HealthMonitor:
    """Flags hosts whose heartbeat lags the fleet.

    Two lag signals, independently gated:

      * **wall timeout** — no beat for more than ``timeout_s``;
      * **step lag** — the host's step trails the fleet max by more than
        ``step_lag``. Pass ``step_lag=None`` to disable: fleet fabric
        workers legitimately diverge in dispatch count (a fabric pinned
        to a rare config class beats less often), so the serving-side
        monitor judges on wall silence only.
    """

    def __init__(self, directory: str, timeout_s: float = 120.0,
                 step_lag: Optional[int] = 5):
        self.dir = directory
        self.timeout_s = timeout_s
        self.step_lag = step_lag

    def read(self) -> Dict[int, Dict]:
        out = {}
        if not os.path.isdir(self.dir):
            return out
        for name in os.listdir(self.dir):
            if name.endswith(".hb"):
                try:
                    with open(os.path.join(self.dir, name)) as f:
                        out[int(name[5:10])] = json.load(f)
                except (json.JSONDecodeError, ValueError):
                    continue
        return out

    def states(self, now: Optional[float] = None) -> Dict[int, str]:
        """Per-host health verdicts: ``{host_id: 'live' | 'stalled'}``.
        A host with no heartbeat file simply does not appear (retired or
        never started)."""
        beats = self.read()
        if not beats:
            return {}
        now = now if now is not None else time.time()
        max_step = max(b["step"] for b in beats.values())
        out = {}
        for host, b in beats.items():
            lagged = self.step_lag is not None and \
                b["step"] < max_step - self.step_lag
            out[host] = "stalled" if (now - b["t"] > self.timeout_s
                                      or lagged) else "live"
        return out

    def stalled(self, now: Optional[float] = None) -> List[int]:
        return sorted(h for h, s in self.states(now).items()
                      if s == "stalled")
