"""Design-space exploration over fabric geometry, per config class
(counterpart of ``repro.fleet.dse``).

The paper's fabric is one fixed 4x4 mesh; a *fleet* gets to choose N
geometries. This module makes that choice measured instead of guessed
(DESIGN.md §15): :func:`sweep` compiles every serve class against every
candidate geometry (rows x cols x IMNs x OMNs) and replays one seeded
request through the fast timing simulation — reusing the artifact cache,
so a sweep re-run is nearly free — producing a ranked cost table per
class. :func:`provision` then turns that table into a concrete
heterogeneous :class:`FleetConfig` ("aligned provisioning"): fabric slots
are allocated to geometries in proportion to the weighted demand of the
classes that prefer them, with a feasibility repair pass guaranteeing
every class keeps at least one fabric it can map to (``div_loop`` does
not exist below 4x4).

Why this is a real lever on this fabric family: the configuration fetch
path scales with fabric rows, so small kernels are measurably cheaper on
small fabrics (relu: 125 cycles on 2x2 vs 135 on 4x4), while
column-hungry kernels invert hard (fft: 996 cycles on 2x2, 342 on 4x4).
A fleet that pins each class to its measured-best geometry beats the same
number of uniform 4x4 fabrics on tail latency for short-kernel-heavy
mixes — the claim ``benchmarks/bench_fleet.py`` pins.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.engine.cache import ArtifactCache
from repro_torch.fleet.config import (DEFAULT_CLASSES, FabricSpec,
                                      FleetConfig)
from repro_torch.fleet.placement import ClassCost, measure_class_costs

Geometry = Tuple[int, int, int, int]

#: the default candidate set: small/cheap-config, wide-but-shallow,
#: mid-square, and the paper's full 4x4
CANDIDATE_GEOMETRIES: Tuple[Geometry, ...] = (
    (2, 2, 2, 2), (2, 4, 4, 4), (3, 3, 3, 3), (4, 4, 4, 4))


def sweep(classes: Sequence[str] = DEFAULT_CLASSES, length: int = 64,
          us_per_cycle: float = 0.01, max_batch: int = 8,
          geometries: Sequence[Geometry] = CANDIDATE_GEOMETRIES,
          backend: str = "sim", cache: Optional[ArtifactCache] = None,
          device=None) -> Dict[str, List[ClassCost]]:
    """Measure every class on every candidate geometry.

    Returns ``{label: [ClassCost, ...]}`` ranked cheapest-first
    (infeasible geometries sort last, carrying their named error). All
    compiles and timing traces land in ``cache``, so the fleet built from
    the result re-uses them. ``device`` is where a ``"cuda"`` sweep's
    probe engines run."""
    cache = cache if cache is not None else ArtifactCache(memory_only=True)
    per_label: Dict[str, List[ClassCost]] = {l: [] for l in classes}
    for geo in geometries:
        costs, _ = measure_class_costs(geo, classes, length, us_per_cycle,
                                       max_batch, backend=backend,
                                       cache=cache, device=device)
        for label in classes:
            per_label[label].append(costs[label])
    for label in classes:
        per_label[label].sort(
            key=lambda c: (not c.feasible, c.service_us, c.geometry))
    return per_label


def table(ranked: Dict[str, List[ClassCost]]) -> List[Dict]:
    """The sweep as flat JSON-ready rows (benchmarks persist this)."""
    rows = []
    for label in sorted(ranked):
        for rank, c in enumerate(ranked[label]):
            rows.append({
                "class": label, "rank": rank,
                "geometry": list(c.geometry), "feasible": c.feasible,
                "service_us": None if not c.feasible
                else round(c.service_us, 4),
                "exec_cycles": c.exec_cycles,
                "config_cycles": c.config_cycles,
                "error": c.error,
            })
    return rows


def provision(ranked: Dict[str, List[ClassCost]], n_fabrics: int,
              weights: Optional[Dict[str, float]] = None,
              backend: str = "sim", **config_kw) -> FleetConfig:
    """Aligned provisioning: turn a sweep into a concrete N-fabric
    :class:`FleetConfig`.

    Fabric slots go to geometries in proportion to the weighted demand of
    the classes whose measured-best geometry they are (largest-remainder
    apportionment — deterministic). A repair pass then guarantees
    feasibility coverage: if some class has no feasible geometry among
    the provisioned slots, the slot of the least-demanded geometry is
    re-assigned to that class's best feasible geometry, so the resulting
    fleet can always serve the whole mix."""
    if n_fabrics < 1:
        raise ValueError(f"n_fabrics must be >= 1, got {n_fabrics}")
    labels = sorted(ranked)
    infeasible = [l for l in labels
                  if not any(c.feasible for c in ranked[l])]
    if infeasible:
        raise ValueError(f"class(es) {infeasible} infeasible on every "
                         f"swept geometry — widen the candidate set")
    demand: Dict[Geometry, float] = {}
    best: Dict[str, Geometry] = {}
    for l in labels:
        g = next(c.geometry for c in ranked[l] if c.feasible)
        best[l] = g
        demand[g] = demand.get(g, 0.0) + \
            (weights.get(l, 1.0) if weights else 1.0)
    total = sum(demand.values())
    # largest-remainder apportionment over the demanded geometries
    geos = sorted(demand, key=lambda g: (-demand[g], g))
    quota = {g: demand[g] / total * n_fabrics for g in geos}
    slots = {g: int(quota[g]) for g in geos}
    leftover = n_fabrics - sum(slots.values())
    for g in sorted(geos, key=lambda g: (-(quota[g] - slots[g]), g)):
        if leftover <= 0:
            break
        slots[g] += 1
        leftover -= 1
    # feasibility repair: every class needs >= 1 provisioned fabric it
    # can actually map to
    def provisioned() -> List[Geometry]:
        return [g for g in geos for _ in range(slots[g])]

    for l in labels:
        feas = {c.geometry for c in ranked[l] if c.feasible}
        if not feas.intersection(provisioned()):
            donor = min((g for g in geos if slots[g] > 0),
                        key=lambda g: (demand[g], g))
            slots[donor] -= 1
            g = best[l]
            if g not in slots:
                geos.append(g)
                demand.setdefault(g, 0.0)
                slots[g] = 0
            slots[g] += 1
    fabrics = tuple(
        FabricSpec(name=f"f{i}", rows=g[0], cols=g[1], n_imns=g[2],
                   n_omns=g[3], backend=backend)
        for i, g in enumerate(provisioned()))
    if weights and "weights" not in config_kw:
        config_kw["weights"] = tuple(sorted(weights.items()))
    return FleetConfig(fabrics=fabrics, classes=tuple(labels), **config_kw)
