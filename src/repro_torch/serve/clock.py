"""Clocks for the serving loop: virtual (deterministic replay) and wall.

All serve-layer time is in **microseconds**. The virtual clock is the
testing contract of DESIGN.md §14: under a :class:`VirtualClock` every
scheduling decision of :class:`repro_torch.serve.ServeEngine` is a pure
function of (workload seed, config) — service time advances by the
engine's modeled cycle counts (``us_per_cycle``), never by host wall
time, so a soak run replays bit-identically across processes and
machines.
"""
from __future__ import annotations

import time


class VirtualClock:
    """Deterministic discrete-event clock. Time only moves when the
    service loop advances it (arrival gaps, modeled service time)."""

    __slots__ = ("_now",)

    def __init__(self, t0: float = 0.0):
        self._now = float(t0)

    def now(self) -> float:
        return self._now

    def advance(self, dt_us: float) -> float:
        if dt_us < 0:
            raise ValueError(f"virtual clock cannot run backwards "
                             f"(dt={dt_us})")
        self._now += dt_us
        return self._now

    def advance_to(self, t_us: float) -> float:
        self._now = max(self._now, float(t_us))
        return self._now

    @property
    def virtual(self) -> bool:
        return True


class WallClock:
    """Real time (``time.perf_counter`` in microseconds). ``advance*`` are
    no-ops: wall time flows on its own while the engine executes."""

    __slots__ = ("_t0",)

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def advance(self, dt_us: float) -> float:
        return self.now()

    def advance_to(self, t_us: float) -> float:
        return self.now()

    @property
    def virtual(self) -> bool:
        return False
