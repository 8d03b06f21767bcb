"""Liveness probing for the serving loop.

Reuses the seed runtime's fault-tolerance primitives
(``repro_torch.runtime.fault_tolerance``): the service loop publishes a
file-based :class:`Heartbeat` after every completed dispatch unit (batch
or shot), and a :class:`HealthMonitor` flags the worker as stalled when
the heartbeat goes quiet for longer than ``timeout_s``. On a stall the
serving engine drains the stalled class's queue with **named rejections**
(``AdmissionError`` spelling out the stall) instead of letting callers
block forever — DESIGN.md §14's liveness rule.
"""
from __future__ import annotations

from typing import List, Optional


class LivenessProbe:
    """Heartbeat publisher + stall detector over one serve worker.

    ``beat()`` is called by the service loop at every dispatch boundary;
    ``stalled(now)`` answers from the on-disk heartbeats (pass an explicit
    ``now`` for deterministic tests). The fault-tolerance runtime is
    imported lazily, as in the reference, where that module pulls in jax.
    """

    def __init__(self, directory: str, timeout_s: float = 5.0,
                 host_id: int = 0):
        from repro_torch.runtime.fault_tolerance import (HealthMonitor,
                                                         Heartbeat)
        self.directory = directory
        self.timeout_s = timeout_s
        self.host_id = host_id
        self._hb = Heartbeat(directory, host_id)
        # wall silence is the liveness signal; step lag is disabled —
        # serve workers (and fleet fabric workers even more so)
        # legitimately diverge in dispatch count
        self._monitor = HealthMonitor(directory, timeout_s=timeout_s,
                                      step_lag=None)
        self._step = 0

    def beat(self) -> int:
        """Publish one liveness step (monotonic)."""
        self._step += 1
        self._hb.beat(self._step)
        return self._step

    def retire(self) -> None:
        """Remove this worker's heartbeat: a deliberately-drained fabric
        must stop tripping the monitor."""
        self._hb.clear()

    @property
    def step(self) -> int:
        return self._step

    def stalled(self, now: Optional[float] = None) -> List[int]:
        """Host ids whose heartbeat lags; non-empty means the worker (or a
        peer) is stalled. ``now`` is Unix time (``time.time`` domain)."""
        return self._monitor.stalled(now)
