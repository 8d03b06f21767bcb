"""Fault tolerance runtime (counterpart of
``repro.runtime.fault_tolerance``, whose ``Heartbeat``, ``HealthMonitor``
and ``StragglerDetector`` are copied here verbatim).

  * **checkpoint/restart** — ``TrainSupervisor.on_step`` saves every
    ``save_every`` steps and ``resume_or_init`` restores the latest
    checkpoint (``repro_torch.checkpoint``, the reference's format);
  * **heartbeats** — each host publishes a monotonic step heartbeat;
    ``HealthMonitor.stalled()`` flags hosts whose heartbeat lags the fleet
    (dead node or crashed process);
  * **straggler detection** — per-step wall times; a step slower than
    ``factor`` x the window's median is recorded.

Heartbeats are files and monitors are pure functions of them. The serving
loop's :class:`repro_torch.serve.LivenessProbe` is built on both. One
deliberate difference from the reference: ``TrainSupervisor.on_step``
takes the state as a zero-argument callable, called only on a save step,
so the trainer builds the reference-layout host tree only when a save is
due. :func:`elastic_remesh` places a restored host tree on a mesh of any
shape as DTensors: the checkpoint holds the global layout, so a restore
onto another mesh is pure data movement.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.runtime.partition import P, filter_spec, placements


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


# ---------------------------------------------------------------------------
# straggler detection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerDetector:
    factor: float = 2.0
    window: int = 50

    def __post_init__(self):
        self._times: List[float] = []
        self.events: List[Dict] = []

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step was a straggler."""
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        med = float(np.median(self._times))
        is_straggler = len(self._times) >= 10 and dt > self.factor * med
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "median": med})
        return is_straggler


# ---------------------------------------------------------------------------
# elastic re-mesh
# ---------------------------------------------------------------------------

def elastic_remesh(host_tree: Any, new_mesh, specs: Any) -> Any:
    """Re-shard a host-memory checkpoint onto a (possibly different) mesh.

    Because checkpoints are stored in global layout, scaling from N to M
    ranks is a ``distribute_tensor`` of each leaf (rank 0's values) with
    the new mesh's placements of its spec. ``None`` leaves stay None;
    ``specs`` has the tree's structure with a :class:`P` at each leaf."""
    names = tuple(new_mesh.mesh_dim_names)

    def put(x, spec):
        if x is None:
            return None
        t = torch.as_tensor(x).to(new_mesh.device_type)
        return distribute_tensor(t, new_mesh,
                                 placements(filter_spec(spec, names),
                                            new_mesh))

    def walk(x, spec):
        if isinstance(x, dict):
            return {k: walk(v, spec[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)) and not isinstance(spec, P):
            out = [walk(v, s) for v, s in zip(x, spec)]
            return type(x)(*out) if hasattr(x, "_fields") else type(x)(out)
        return put(x, spec)
    return walk(host_tree, specs)


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------

class TrainSupervisor:
    """Glues checkpointing, heartbeats and straggler handling to the loop."""

    def __init__(self, ckpt, hb_dir: str, host_id: int = 0,
                 save_every: int = 100, straggler_factor: float = 2.0):
        self.ckpt = ckpt
        self.hb = Heartbeat(hb_dir, host_id)
        self.monitor = HealthMonitor(hb_dir)
        self.straggler = StragglerDetector(straggler_factor)
        self.save_every = save_every
        self._last_t: Optional[float] = None

    def on_step(self, step: int, state: Callable[[], Any],
                extra: Optional[Dict] = None) -> Dict:
        """After step ``step``: a heartbeat, the straggler check, and on a
        save step an async save of ``state()``."""
        now = time.time()
        info: Dict[str, Any] = {}
        if self._last_t is not None:
            info["straggler"] = self.straggler.record(step, now - self._last_t)
        self._last_t = now
        self.hb.beat(step)
        if step > 0 and step % self.save_every == 0:
            self.ckpt.save_async(step, state(), extra)
            info["saved"] = True
        stalled = self.monitor.stalled(now)
        if stalled:
            info["stalled_hosts"] = stalled
        return info

    def resume_or_init(self, template: Any):
        step = self.ckpt.latest_step()
        if step is None:
            return None, 0, {}
        return self.ckpt.restore(template, step)
