"""Multi-fabric fleet scale-out for the serving engine (counterpart of
``repro.fleet``; DESIGN.md §15).

``repro_torch.fleet`` shards the serve request stream across N independent
``Engine`` instances ("fabric workers"), each with its own geometry,
artifact cache namespace, and per-class FIFO state:

  * :class:`FleetConfig` / :class:`FabricSpec` — fleet shape + policy;
  * :class:`FleetEngine` — the deterministic fleet scheduler (class-
    affinity placement, work-stealing, fault-drain);
  * :func:`fleet_soak` — the shared seeded end-to-end soak entry point;
  * :mod:`repro_torch.fleet.dse` — geometry design-space exploration +
    aligned provisioning.

A ``"cuda"`` fabric runs its batches through the CUDA lane kernel on the
device given to :class:`FleetEngine` / :func:`fleet_soak` (the card unless
the caller names another; ``device="cpu"`` takes the plain versions). The
device is an argument of those calls, never a :class:`FabricSpec` field:
``FleetConfig.digest()`` hashes the config's repr, and it equals the
reference's only while the dataclasses are the same.
"""
from repro_torch.fleet.config import (DEFAULT_CLASSES, FabricSpec,
                                      FleetConfig, homogeneous)
from repro_torch.fleet.placement import (ClassCost, Router,
                                         UnroutableError,
                                         measure_class_costs)
from repro_torch.fleet.scheduler import (FabricWorker, FleetEngine,
                                         fleet_soak, fleet_workload)

__all__ = [
    "DEFAULT_CLASSES", "FabricSpec", "FleetConfig", "homogeneous",
    "ClassCost", "Router", "UnroutableError", "measure_class_costs",
    "FabricWorker", "FleetEngine", "fleet_soak", "fleet_workload",
]
