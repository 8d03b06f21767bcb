"""Fleet configuration: fabric geometry specs + scheduling policy knobs
(counterpart of ``repro.fleet.config``, unchanged: the digest of a config
equals the reference's).

A :class:`FleetConfig` fully determines a fleet soak together with the
workload seed (DESIGN.md §15): fabric geometries, per-fabric serving
policy, the work-stealing threshold, the calibration/serving stream
length, the served class mix, and any scripted mid-soak fabric failures
all live here, so ``FleetEngine.trace_digest()`` is a pure function of
``(seed, FleetConfig)`` — the same replay contract the single-fabric
``ServeEngine`` keeps, extended across N fabrics.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

from repro_torch.serve.loop import ServeConfig

#: the six-class paper serve mix (short streaming kernels, a reduction,
#: a multi-shot plan, an irregular loop)
DEFAULT_CLASSES: Tuple[str, ...] = (
    "relu", "vadd", "fft", "mac1", "axpby_ms", "div_loop")


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    """One fabric worker: a name plus the geometry its engine is built
    around. Heterogeneous fleets mix specs — that is the aligned-
    provisioning lever (give fft a wide fabric, give the short kernels a
    small one whose config path is cheaper)."""

    name: str
    rows: int = 4
    cols: int = 4
    n_imns: int = 4
    n_omns: int = 4
    backend: str = "sim"

    @property
    def geometry(self) -> Tuple[int, int, int, int]:
        return (self.rows, self.cols, self.n_imns, self.n_omns)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Everything that shapes a fleet soak besides the workload seed."""

    fabrics: Tuple[FabricSpec, ...]
    steal_depth: int = 6            # pinned-queue depth that triggers
    #                                 overflow onto the least-loaded peer
    max_batch: int = 8              # per-fabric ServeConfig knobs
    max_wait_us: float = 400.0
    queue_capacity: int = 64        # per fabric
    preempt_wait_us: float = 150.0
    us_per_cycle: float = 0.01
    slo_p99_us: Optional[float] = None
    length: int = 64                # request stream length (also used to
    #                                 calibrate the placement cost model)
    classes: Tuple[str, ...] = DEFAULT_CLASSES
    fail_at: Tuple[Tuple[str, float], ...] = ()   # scripted failures:
    #                                 (fabric name, virtual t_us) pairs
    # workload shape — lives here (not in ``fleet_soak``) so the fleet
    # trace digest is a pure function of (seed, FleetConfig) alone
    n_requests: int = 200
    rate_per_us: float = 0.05       # offered arrival rate
    bursty: bool = False
    burst_size: int = 8
    weights: Tuple[Tuple[str, float], ...] = ()   # class-mix bias

    def __post_init__(self):
        if not self.fabrics:
            raise ValueError("FleetConfig needs at least one FabricSpec")
        names = [s.name for s in self.fabrics]
        if len(set(names)) != len(names):
            raise ValueError(f"fabric names must be unique, got {names}")
        if not (0 < self.steal_depth <= self.queue_capacity):
            raise ValueError(
                f"steal_depth must be in (0, queue_capacity="
                f"{self.queue_capacity}], got {self.steal_depth}")
        for name, t in self.fail_at:
            if name not in names:
                raise ValueError(f"fail_at names unknown fabric {name!r} "
                                 f"(have {names})")
        for label, _ in self.weights:
            if label not in self.classes:
                raise ValueError(f"weights name unknown class {label!r} "
                                 f"(have {list(self.classes)})")

    def serve_config(self) -> ServeConfig:
        """The per-fabric-worker serving policy."""
        return ServeConfig(max_batch=self.max_batch,
                           max_wait_us=self.max_wait_us,
                           queue_capacity=self.queue_capacity,
                           preempt_wait_us=self.preempt_wait_us,
                           us_per_cycle=self.us_per_cycle,
                           slo_p99_us=self.slo_p99_us)

    def digest(self) -> str:
        """Content digest of the whole config — frozen dataclass reprs
        are deterministic, so this names the replay identity."""
        return hashlib.sha1(repr(self).encode()).hexdigest()


def homogeneous(n: int, rows: int = 4, cols: int = 4,
                n_imns: Optional[int] = None, n_omns: Optional[int] = None,
                backend: str = "sim", **kw) -> FleetConfig:
    """``n`` identical fabrics (default 4x4) — the scale-out baseline the
    DSE-provisioned heterogeneous fleet is benchmarked against."""
    n_imns = cols if n_imns is None else n_imns
    n_omns = cols if n_omns is None else n_omns
    specs = tuple(FabricSpec(name=f"f{i}", rows=rows, cols=cols,
                             n_imns=n_imns, n_omns=n_omns, backend=backend)
                  for i in range(n))
    return FleetConfig(fabrics=specs, **kw)
