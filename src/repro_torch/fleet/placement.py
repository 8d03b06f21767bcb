"""Class-affinity placement: the fleet's cost model + router (counterpart
of ``repro.fleet.placement``).

Placement answers one question per arriving request: *which fabric runs
it?* The answer is driven by a **measured** cost model, not a guess —
geometry genuinely changes modeled cost on this fabric family (the config
fetch path scales with rows, so a 2x2 serves relu ~8% cheaper than a 4x4;
fft needs column width and costs ~3x more on a 2x2; ``div_loop`` does not
map below a 4x4 at all). The model is built once per fleet by compiling
every class recipe against every fabric geometry and replaying one seeded
request through a throwaway engine, so the cost of a class on a fabric is
the same quantity the serving clock will charge: modeled execution cycles
times ``us_per_cycle``, plus the amortized share of the configuration
fetch a continuous batch pays.

The :class:`Router` then pins each class to its cheapest feasible fabric
(**class affinity** — keeps each fabric's continuous batcher fed with
same-class runs, which is where the serve loop's config-amortization
wins live) and **work-steals** past the pin when the pinned fabric's
queue is deep: overflow goes to the least-loaded feasible live peer. Both decisions are
pure functions of (cost table, queue state), so the fleet trace digest
stays a pure function of (seed, FleetConfig).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClassCost:
    """Measured cost of one config class on one fabric geometry."""

    label: str
    geometry: Tuple[int, int, int, int]
    feasible: bool
    service_us: float = float("inf")   # modeled batch-amortized us/request
    exec_cycles: int = 0               # total modeled cycles of one run
    config_cycles: int = 0             # full (cold) configuration fetch
    n_shots: int = 1
    error: str = ""                    # why infeasible (named diagnostic)


def measure_class_costs(geometry: Tuple[int, int, int, int],
                        labels: Sequence[str], length: int,
                        us_per_cycle: float, max_batch: int,
                        backend: str = "sim", cache=None, device=None
                        ) -> Tuple[Dict[str, ClassCost], Dict[str, object]]:
    """Compile every class recipe against ``geometry`` and measure one
    seeded request through a throwaway engine.

    Returns ``(costs, artifacts)``; an infeasible class (compile or
    capability failure — e.g. ``div_loop`` below 4x4) gets a named
    ``ClassCost(feasible=False)`` and no artifact. The throwaway engine
    shares the caller's artifact cache, so fleet workers (and later
    processes) reuse the compile + timing traces instead of repeating
    them; its cycle tally never touches any worker's ledger.

    ``service_us`` amortizes the cold configuration fetch across a full
    ``max_batch`` — the steady-state quantity the continuous batcher
    actually charges — so the router compares fabrics on what serving
    them costs, not on worst-case cold dispatch. ``device`` is where a
    ``"cuda"`` probe engine runs (ignored by other backends).
    """
    from repro_torch.core.fabric import Fabric
    from repro_torch.engine.scheduler import Engine
    from repro_torch.serve.load import (compile_recipe, mix_recipes,
                                  request_inputs)

    rows, cols, n_imns, n_omns = geometry
    kw = {"device": device} if backend == "cuda" else {}
    eng = Engine(Fabric(rows=rows, cols=cols, n_imns=n_imns,
                        n_omns=n_omns), backend=backend, cache=cache, **kw)
    # the full label namespace (paper + model-layer classes), so fleet
    # configs can mix both without a second resolution path
    recipes = mix_recipes(length, "all")
    costs: Dict[str, ClassCost] = {}
    artifacts: Dict[str, object] = {}
    rng = np.random.default_rng(0)     # fixed probe seed: the cost table
    #                                    must not depend on the soak seed
    for label in labels:
        if label not in recipes:
            raise ValueError(f"unknown config class {label!r} "
                             f"(have {sorted(recipes)})")
        try:
            art = compile_recipe(eng, label, length, recipes)
            before = eng.tally.total
            eng.run(art, request_inputs(art, length, rng, label=label))
            exec_cycles = eng.tally.total - before
        except Exception as e:
            costs[label] = ClassCost(
                label=label, geometry=geometry, feasible=False,
                error=f"{type(e).__name__}: {e}")
            continue
        cfg = art.config_cycles()
        # a cold run measured above includes the full config fetch; the
        # batcher pays it once per max_batch same-class requests
        amortized = exec_cycles - cfg + cfg / max(1, max_batch)
        costs[label] = ClassCost(
            label=label, geometry=geometry, feasible=True,
            service_us=amortized * us_per_cycle,
            exec_cycles=int(exec_cycles), config_cycles=int(cfg),
            n_shots=art.n_shots)
        artifacts[label] = art
    return costs, artifacts


class UnroutableError(RuntimeError):
    """No live fabric in the fleet can serve a class — named rejection,
    mirroring ``AdmissionError``'s style."""


class Router:
    """Deterministic class-affinity placement over an ordered worker set.

    ``ranked[label]`` is the full feasibility-filtered preference list.
    Ties on cost (homogeneous fleets) break by a per-class *rotated*
    worker index, so six classes over four identical fabrics pin
    round-robin instead of piling onto worker 0.
    """

    def __init__(self, workers: Sequence[str],
                 costs: Dict[str, Dict[str, ClassCost]],
                 steal_depth: int):
        # costs: {worker_name: {label: ClassCost}}
        self.workers = list(workers)
        self.steal_depth = steal_depth
        self.ranked: Dict[str, List[str]] = {}
        labels = sorted({l for per in costs.values() for l in per})
        for rank, label in enumerate(labels):
            feas = [(costs[w][label].service_us, i, w)
                    for i, w in enumerate(self.workers)
                    if label in costs[w] and costs[w][label].feasible]
            feas.sort()
            # rotate every equal-cost run by the label's rank: classes
            # that tie on cost (homogeneous fleets, or the small-fabric
            # tier of a heterogeneous one) spread their pins round-robin
            # across the tied fabrics instead of piling onto the first —
            # and rare classes land packed two-to-a-fabric, where the
            # work-conserving switch-close serves them early instead of
            # each idling a whole fabric until its batch deadline
            order: List[str] = []
            i = 0
            while i < len(feas):
                j = i
                while j < len(feas) and feas[j][0] == feas[i][0]:
                    j += 1
                run = [w for _, _, w in feas[i:j]]
                k = rank % len(run)
                order.extend(run[k:] + run[:k])
                i = j
            self.ranked[label] = order

    def pin(self, label: str) -> Optional[str]:
        """The class's home fabric (cheapest feasible), ignoring health."""
        r = self.ranked.get(label)
        return r[0] if r else None

    def feasible(self, label: str) -> List[str]:
        return list(self.ranked.get(label, ()))

    def place(self, label: str, depths: Dict[str, int],
              loads: Dict[str, float], dead: frozenset
              ) -> Tuple[str, str]:
        """Route one request: returns ``(worker_name, 'pin' | 'steal')``.

        The pinned fabric is the first live entry of the preference list.
        When its queue depth has reached ``steal_depth`` the request
        overflows to the least-loaded feasible live peer (ties break by
        preference rank — still deterministic). Raises
        :class:`UnroutableError` when no live fabric can serve the class.
        """
        live = [w for w in self.ranked.get(label, ()) if w not in dead]
        if not live:
            raise UnroutableError(
                f"class {label!r} has no live feasible fabric "
                f"(preference {self.ranked.get(label, [])}, "
                f"dead {sorted(dead)})")
        pinned = live[0]
        if len(live) == 1 or depths.get(pinned, 0) < self.steal_depth:
            return pinned, "pin"
        victim = min(live, key=lambda w: (loads.get(w, 0.0),
                                          live.index(w)))
        if victim == pinned:
            return pinned, "pin"
        return victim, "steal"
