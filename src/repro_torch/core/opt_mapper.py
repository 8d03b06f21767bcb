"""Cost-driven optimizing place & route: simulated annealing over mappings.

The greedy mapper (``core.mapper``) returns the *first* placement that
routes; nothing pulls it toward the two costs that actually price a
mapping in this system:

  * **steady-state II / total cycles** — a placement that starves a join
    (reconvergent operand paths whose FU-stage skew exceeds the elastic-
    buffer slack of the shallow path) inflates the initiation interval,
    and every inflated cycle multiplies by the stream length;
  * **config footprint** — every PE carrying route-through traffic costs
    five configuration words, and multi-shot traffic pays that fetch on
    every reconfiguration (Sec. V-B) — the rearm cost the engine's
    config-class batching exists to amortize.

This module anneals over the mapping state (PE placement + IMN/OMN column
binding), re-routing each move with the shared negotiated router and
scoring it with a cheap congestion/criticality model; whenever the cheap
model finds a new best state ("accepted plateau"), the candidate is
*validated* by the fast elastic simulator on short deterministic probe
streams — cheap enough to sit in the inner loop for 4x4–8x8
fabrics. A candidate is only ever adopted when, on **every** probe, it is

  * value-bit-exact with the greedy baseline, and
  * never cycle-worse,

so ``anneal_map`` is a strict refinement: the greedy mapping itself stays
the answer whenever nothing provably cheaper is found. Selection among
admissible candidates minimizes ``sim_cycles + w_config *
config_cycles`` — the weighted objective multi-shot plans care about.

Observability (``STRELA_OBS=1``): the whole search runs inside a
``pnr.anneal`` span, with ``pnr.anneal.moves_tried`` / ``moves_accepted``
/ ``temp_steps`` / ``validations`` counters.
"""
from __future__ import annotations

import math
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core import dfg as D
from repro_torch.core.fabric import FU_INS, Fabric
from repro_torch.core.isa import config_cycles
from repro_torch.core.mapper import (Mapping, MappingError, Signal, _depths,
                                     default_seed, map_dfg, route_signals)

# probe stream lengths used for simulation-validated plateaus; two lengths
# make "never cycle-worse" evidence structural (fill + slope), not a
# single-length coincidence
PROBE_LENGTHS = (24, 48)

# a candidate validation simulation that exceeds this budget is simply
# rejected (runaway irregular-loop mappings must not stall compilation)
_VALIDATE_MAX_CYCLES = 200_000


def default_moves() -> int:
    """Anneal move budget: ``STRELA_ANNEAL_MOVES`` in the env, else 240."""
    return int(os.environ.get("STRELA_ANNEAL_MOVES", "240"))


# ---------------------------------------------------------------------------
# cheap incremental cost model (guides the anneal; sim validates plateaus)
# ---------------------------------------------------------------------------

def _route_ebs(routes: Dict[Signal, "object"], edge_dest, e) -> int:
    """Registered elastic-buffer stations on one edge's claimed path.

    Each IN_* port and FU input along the route is a 2-slot EB; the count
    prices the *buffering slack* of the path (fall-through EBs add no
    latency, but their capacity is what absorbs reconvergence skew)."""
    sig = (e.src, e.src_port)
    route = routes.get(sig)
    if route is None:
        return 0
    dst = edge_dest.get((e.src, e.src_port, e.dst, e.dst_port))
    if dst is None or dst not in route.parent:
        return 0
    n = 0
    for res in route.path_to(dst):
        if res.port.startswith("IN_") or res.port in FU_INS:
            n += 1
    return n


def mapping_cost(g: D.DFG, fabric: Fabric, place, routes, edge_dest,
                 depth: Dict[str, int], w_config: float = 1.0,
                 w_skew: float = 48.0, w_len: float = 0.05
                 ) -> Tuple[float, int]:
    """(cheap cost, active-PE count) of one routed mapping state.

    Three terms, mirroring the objective the validator measures for real:

      * ``config_cycles(active PEs)`` — the reconfiguration footprint
        (functional + route-through PEs, exactly ``Mapping.active_pes``);
      * a **criticality/skew** penalty: for every join, operands arriving
        from different pipeline depths must be absorbed by the EB slack of
        the shallow path — any deficit backpressures the shared fork
        upstream and inflates II, so deficits dominate the cost;
      * total claimed route hops — a light congestion tiebreaker pulling
        routes (and therefore active PEs and fork pressure) short.
    """
    active = set(place.values())
    hops = 0
    for route in routes.values():
        for res in route.parent:
            if 0 <= res.r < fabric.rows and 0 <= res.c < fabric.cols:
                active.add((res.r, res.c))
            hops += 1
    cost = w_config * config_cycles(len(active)) + w_len * hops

    skew = 0
    for n in g.nodes:
        ops = [e for e in g.in_edges(n)
               if not e.back and g.nodes[e.src].kind != D.CONST]
        if len(ops) < 2:
            continue
        arr = [(depth.get(e.src, 0), _route_ebs(routes, edge_dest, e))
               for e in ops]
        dmax = max(d for d, _ in arr)
        for d, ebs in arr:
            deficit = (dmax - d) - 2 * ebs        # 2 slots per EB station
            if deficit > 0:
                skew += deficit
    return cost + w_skew * skew, len(active)


# ---------------------------------------------------------------------------
# simulation-validated plateaus
# ---------------------------------------------------------------------------

def probe_inputs(g: D.DFG, seed: int,
                 lengths: Tuple[int, ...] = PROBE_LENGTHS
                 ) -> List[Dict[str, np.ndarray]]:
    """Deterministic probe streams (one dict per probe length).

    Recirculation graphs draw small non-negative values so data-dependent
    trip counts stay bounded — the same convention the benchmarks use."""
    rng = np.random.default_rng((seed & 0xFFFFFFFF) ^ 0x5EED)
    lo, hi = (0, 100) if g.has_recirculation() else (-64, 64)
    return [{n: rng.integers(lo, hi, ln).astype(np.int32) for n in g.inputs}
            for ln in lengths]


def _probe_sims(m: Mapping, probes: List[Dict[str, np.ndarray]]):
    """Fast-sim every probe; None if any probe deadlocks/diverges."""
    from repro_torch.core.elastic_sim import simulate
    out = []
    for ins in probes:
        try:
            out.append(simulate(m, ins, max_cycles=_VALIDATE_MAX_CYCLES))
        except RuntimeError:
            return None
    return out


def _admissible(cand_sims, base_sims) -> bool:
    """Never cycle-worse AND value-bit-exact vs the baseline, per probe."""
    for cs, bs in zip(cand_sims, base_sims):
        if cs.cycles > bs.cycles:
            return False
        if set(cs.outputs) != set(bs.outputs):
            return False
        for k, v in bs.outputs.items():
            if not np.array_equal(cs.outputs[k], v):
                return False
    return True


# ---------------------------------------------------------------------------
# the annealer
# ---------------------------------------------------------------------------

def _propose(rng: random.Random, fabric: Fabric, place, imn_of, omn_of,
             funcs: List[str]):
    """One mutated (place, imn_of, omn_of) copy. Move set:

      * relocate — move one functional node to a free PE;
      * swap     — exchange the PEs of two functional nodes;
      * imn/omn  — rebind one stream to another memory-node column
                   (swapping with the current holder when occupied).
    """
    place, imn_of, omn_of = dict(place), dict(imn_of), dict(omn_of)
    r = rng.random()
    if r < 0.45 or len(funcs) < 2:
        n = funcs[rng.randrange(len(funcs))]
        used = set(place.values())
        free = [(rr, cc) for rr in range(fabric.rows)
                for cc in range(fabric.cols) if (rr, cc) not in used]
        if not free:
            return None
        place[n] = free[rng.randrange(len(free))]
    elif r < 0.80:
        a, b = rng.sample(funcs, 2)
        place[a], place[b] = place[b], place[a]
    elif r < 0.90 and imn_of:
        names = sorted(imn_of)
        n = names[rng.randrange(len(names))]
        col = rng.randrange(fabric.n_imns)
        holder = next((k for k, v in imn_of.items() if v == col), None)
        if holder is not None:
            imn_of[holder] = imn_of[n]
        imn_of[n] = col
    elif omn_of:
        names = sorted(omn_of)
        n = names[rng.randrange(len(names))]
        col = rng.randrange(fabric.n_omns)
        holder = next((k for k, v in omn_of.items() if v == col), None)
        if holder is not None:
            omn_of[holder] = omn_of[n]
        omn_of[n] = col
    else:
        return None
    return place, imn_of, omn_of


def anneal_map(g: D.DFG, fabric: Optional[Fabric] = None,
               seed: Optional[int] = None,
               baseline: Optional[Mapping] = None,
               moves: Optional[int] = None,
               w_config: float = 1.0,
               t0: float = 24.0, t1: float = 0.4,
               n_steps: int = 24,
               max_validations: int = 24,
               extra_probes: Optional[List[Dict[str, np.ndarray]]] = None,
               restarts: int = 400) -> Mapping:
    """Anneal a mapping of ``g``; returns a mapping that is never
    cycle-worse than — and value-bit-exact with — the greedy ``baseline``
    (computed here when not supplied) on every validation probe.

    ``extra_probes``: additional input-stream dicts validated alongside
    the default probes — profile-guided clients (the mapper gate, the
    benchmarks) pass their real workload so the never-worse guarantee
    holds on exactly the streams they will measure.
    """
    fabric = fabric or Fabric()
    seed = default_seed() if seed is None else seed
    moves = default_moves() if moves is None else moves
    if baseline is None:
        baseline = map_dfg(g, fabric, seed=seed, restarts=restarts,
                           optimize="greedy")

    probes = probe_inputs(g, seed) + list(extra_probes or [])
    base_sims = _probe_sims(baseline, probes)
    depth = _depths(g)
    funcs = sorted(baseline.place)

    with obs.span("pnr.anneal", kernel=g.name, moves=moves) as sp:
        if base_sims is None:
            # the greedy netlist itself deadlocks on the probes (a liveness
            # limit of 2-slot EBs on some corpus graphs): stay semantics-
            # identical to greedy rather than silently "fixing" behavior
            sp.set(outcome="baseline_deadlock")
            return baseline

        base_cycles = sum(s.cycles for s in base_sims)
        base_score = base_cycles + w_config * baseline.config_cycles()
        best_score, best_mapping = base_score, baseline

        cur = (dict(baseline.place), dict(baseline.imn_of),
               dict(baseline.omn_of))
        cur_routes, cur_dest = baseline.routes, baseline.edge_dest
        cur_cost, _ = mapping_cost(g, fabric, cur[0], cur_routes, cur_dest,
                                   depth, w_config=w_config)
        best_cost = cur_cost

        rng = random.Random((seed * 1_000_003) ^ 0xA11EA1ED)
        tried = accepted = validations = improved = 0
        moves_per_step = max(1, moves // n_steps)
        for step in range(n_steps):
            frac = step / max(n_steps - 1, 1)
            temp = t0 * (t1 / t0) ** frac
            obs.inc("pnr.anneal.temp_steps")
            for _ in range(moves_per_step):
                tried += 1
                prop = _propose(rng, fabric, *cur, funcs)
                if prop is None:
                    continue
                try:
                    routes2, dest2 = route_signals(
                        g, fabric, prop[0], prop[1], prop[2],
                        random.Random(rng.getrandbits(32)), depth=depth)
                except MappingError:
                    continue
                cost2, _ = mapping_cost(g, fabric, prop[0], routes2, dest2,
                                        depth, w_config=w_config)
                d = cost2 - cur_cost
                if d > 0 and rng.random() >= math.exp(-d / max(temp, 1e-9)):
                    continue
                cur, cur_routes, cur_dest, cur_cost = \
                    prop, routes2, dest2, cost2
                accepted += 1
                if cost2 >= best_cost or validations >= max_validations:
                    continue
                # accepted plateau: the cheap model claims a new best —
                # validate with the real simulator before believing it
                best_cost = cost2
                validations += 1
                obs.inc("pnr.anneal.validations")
                cand = Mapping(g, fabric, dict(prop[0]), dict(prop[1]),
                               dict(prop[2]), routes2, dest2)
                cand_sims = _probe_sims(cand, probes)
                if cand_sims is None or not _admissible(cand_sims,
                                                        base_sims):
                    continue
                score = sum(s.cycles for s in cand_sims) \
                    + w_config * cand.config_cycles()
                if score < best_score:
                    best_score, best_mapping = score, cand
                    improved += 1
        obs.inc("pnr.anneal.moves_tried", tried)
        obs.inc("pnr.anneal.moves_accepted", accepted)
        sp.set(tried=tried, accepted=accepted, validations=validations,
               adopted=best_mapping is not baseline,
               score_delta=base_score - best_score)
    return best_mapping
