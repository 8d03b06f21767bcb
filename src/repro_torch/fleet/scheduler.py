"""Multi-fabric fleet scale-out: shard the serve stream across N engines
(counterpart of ``repro.fleet.scheduler``).

:class:`FleetEngine` runs one :class:`~repro_torch.serve.loop.ServeEngine`
per :class:`~repro_torch.fleet.config.FabricSpec` — each fabric worker owns
its own engine, virtual clock, per-class FIFO state, and geometry-specific
compiled artifacts — and shards an arrival stream across them
(DESIGN.md §15):

  * **placement** — a class-affinity
    :class:`~repro_torch.fleet.placement.Router` pins each config class to
    the fabric whose *measured* cost model says it is cheapest there
    (modeled cycles x ``us_per_cycle`` plus the amortized configuration
    share), and work-steals overflow onto the least-loaded feasible peer
    once the pinned queue is ``steal_depth`` deep;
  * **fault-drain** — :meth:`fail_fabric` marks a fabric dead mid-soak and
    moves every queued and shot-paused request to surviving peers (rid
    order preserved, artifacts re-bound to the peer's geometry, no loss,
    no duplicates); heartbeat-driven failure goes through
    :meth:`check_health` over ``runtime/fault_tolerance``'s
    :class:`HealthMonitor`;
  * **determinism** — every fleet decision (route, steal, fail, drain,
    unroutable) lands in the fleet trace, each worker keeps its own
    serve trace, and :meth:`trace_digest` folds all of them together, so
    the digest is a pure function of ``(seed, FleetConfig)`` and replays
    bit-identically across processes.

The whole fleet is one discrete-event simulation: the global event list
(arrivals + scripted failures) is walked in time order, and between
events every live worker is *pumped* — dispatched while it has decisions
to make, then advanced to the event frontier. Values never depend on
which fabric served a request (the functional executor computes them),
which is what makes the fleet digest-comparable against a single-engine
oracle running the same request stream.

The port adds one argument to :class:`FleetEngine` and :func:`fleet_soak`:
``device``, where every ``"cuda"`` fabric's engine and cost probe run.
"""
from __future__ import annotations

import hashlib
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.engine.cache import ArtifactCache
from repro_torch.engine.scheduler import Engine
from repro_torch.core.fabric import Fabric
from repro_torch.serve.clock import VirtualClock
from repro_torch.serve.loop import AdmissionError, ServeEngine, Ticket
from repro_torch.fleet.config import FabricSpec, FleetConfig
from repro_torch.fleet.placement import (ClassCost, Router, UnroutableError,
                                   measure_class_costs)


class _PhantomArtifact:
    """Stand-in artifact for a ticket the fleet rejected before any fabric
    could own it (unroutable class) — carries just what :class:`Ticket`
    and the rejection message read."""

    __slots__ = ("name", "config_class")

    def __init__(self, label: str):
        self.name = label
        self.config_class = label


class FabricWorker:
    """One fabric of the fleet: spec + engine + serving state machine."""

    __slots__ = ("spec", "engine", "serve", "artifacts", "costs", "alive",
                 "busy_us", "probe")

    def __init__(self, spec: FabricSpec, serve_cfg, cache,
                 costs: Dict[str, ClassCost], artifacts: Dict[str, object],
                 probe=None, device=None):
        self.spec = spec
        rows, cols, n_imns, n_omns = spec.geometry
        kw = {"device": device} if spec.backend == "cuda" else {}
        self.engine = Engine(Fabric(rows=rows, cols=cols, n_imns=n_imns,
                                    n_omns=n_omns),
                             backend=spec.backend, cache=cache, **kw)
        self.serve = ServeEngine(self.engine, serve_cfg,
                                 clock=VirtualClock(), probe=probe)
        self.artifacts = artifacts
        self.costs = costs
        self.alive = True
        self.busy_us = 0.0
        self.probe = probe

    @property
    def name(self) -> str:
        return self.spec.name


class FleetEngine:
    """Deterministic fleet scheduler over N fabric workers.

    ``hb_dir`` wires the fault-tolerance runtime's file heartbeats under
    the fleet: each worker publishes a beat per dispatch unit (through its
    ``LivenessProbe``) and :meth:`check_health` fails any fabric the
    :class:`HealthMonitor` flags as stalled. Scripted failures
    (``FleetConfig.fail_at``) need no heartbeat machinery and keep the
    soak fully virtual. ``device`` is where every ``"cuda"`` fabric runs
    (the card unless the caller names another)."""

    def __init__(self, config: FleetConfig,
                 cache: Optional[ArtifactCache] = None,
                 hb_dir: Optional[str] = None, timeout_s: float = 5.0,
                 device=None):
        self.cfg = config
        self.cache = cache if cache is not None \
            else ArtifactCache(memory_only=True)
        self.monitor = None
        probes: List[Optional[object]] = [None] * len(config.fabrics)
        if hb_dir is not None:
            from repro_torch.serve.health import LivenessProbe
            from repro_torch.runtime.fault_tolerance import HealthMonitor
            probes = [LivenessProbe(hb_dir, timeout_s=timeout_s, host_id=i)
                      for i in range(len(config.fabrics))]
            self.monitor = HealthMonitor(hb_dir, timeout_s=timeout_s,
                                         step_lag=None)
        # one cost-model measurement per distinct (geometry, backend) —
        # a homogeneous fleet compiles its class mix exactly once, and
        # the throwaway probe engines never touch any worker's tally
        serve_cfg = config.serve_config()
        memo: Dict[tuple, tuple] = {}
        self.workers: List[FabricWorker] = []
        for spec, probe in zip(config.fabrics, probes):
            gk = (spec.geometry, spec.backend)
            if gk not in memo:
                memo[gk] = measure_class_costs(
                    spec.geometry, config.classes, config.length,
                    config.us_per_cycle, config.max_batch,
                    backend=spec.backend, cache=self.cache, device=device)
            costs, artifacts = memo[gk]
            self.workers.append(FabricWorker(spec, serve_cfg, self.cache,
                                             costs, artifacts, probe,
                                             device))
        self._by_name = {w.name: w for w in self.workers}
        # globally unique, arrival-ordered request ids: every worker's
        # ServeEngine draws from ONE shared counter
        shared_ids = itertools.count()
        for w in self.workers:
            w.serve._ids = shared_ids
        self.router = Router([w.name for w in self.workers],
                             {w.name: w.costs for w in self.workers},
                             config.steal_depth)
        infeasible = sorted(l for l in config.classes
                            if not self.router.feasible(l))
        if infeasible:
            raise ValueError(
                f"no fabric in the fleet can serve class(es) {infeasible} "
                f"— geometries {[s.geometry for s in config.fabrics]}")
        self.dead: set = set()
        self.trace: List[tuple] = []
        self.unroutable: List[Ticket] = []
        self._rid_label: Dict[int, str] = {}
        self._owner: Dict[int, str] = {}
        self.steals = 0
        self.drained = 0

    # -- helpers -----------------------------------------------------------
    def _trace(self, kind: str, t: float, *args) -> None:
        self.trace.append((kind, round(float(t), 6)) + args)

    def _live(self) -> List[FabricWorker]:
        return [w for w in self.workers if w.alive]

    def _depths(self) -> Dict[str, int]:
        return {w.name: w.serve._depth + len(w.serve._paused)
                for w in self._live()}

    def _load_us(self, w: FabricWorker, t: float) -> float:
        """Modeled backlog of one worker at global time ``t``: how far its
        clock already ran ahead plus the modeled service time of every
        queued / paused request (the steal tie-breaker)."""
        load = max(0.0, w.serve.clock.now() - t)
        for q in w.serve._queues.values():
            for tk in q:
                load += w.costs[self._rid_label[tk.rid]].service_us
        for ex in w.serve._paused.values():
            load += w.costs[self._rid_label[ex.ticket.rid]].service_us
        return load

    def _gauge(self, w: FabricWorker) -> None:
        obs.set_gauge(f"fleet.{w.name}.queue_depth",
                      w.serve._depth + len(w.serve._paused))

    # -- the fleet discrete-event loop -------------------------------------
    def drive(self, arrivals: Sequence[Tuple[float, str, Dict]]) -> Dict:
        """Serve a labeled arrival schedule ``[(t_us, label, inputs)...]``
        merged with the config's scripted failures; returns
        :meth:`report`."""
        for (a, _, _), (b, _, _) in zip(arrivals, arrivals[1:]):
            if b < a:
                raise ValueError("arrivals must be sorted by time")
        # kind 0 (failure) sorts before kind 1 (arrival) at equal t: a
        # request arriving the instant a fabric dies must not land on it
        events: List[tuple] = [(float(t), 0, i, ("fail", name))
                               for i, (name, t) in enumerate(self.cfg.fail_at)]
        events += [(float(t), 1, i, ("arrive", label, inputs))
                   for i, (t, label, inputs) in enumerate(arrivals)]
        events.sort(key=lambda e: e[:3])
        for t, _, _, ev in events:
            self._pump(t_limit=t, can_wait=True)
            if ev[0] == "fail":
                self.fail_fabric(ev[1], t=t)
            else:
                self._route(t, ev[1], ev[2])
        self._pump(t_limit=None, can_wait=False)
        return self.report()

    def _pump(self, t_limit: Optional[float], can_wait: bool) -> None:
        """Advance every live worker to the event frontier: dispatch while
        the worker's batcher has a decision, otherwise step its clock to
        the next batch deadline (never past ``t_limit``). Workers share no
        state mid-pump, so pumping them in fleet order is deterministic.

        After ``_pump(t)`` every live worker's clock is >= ... at least
        ``t`` (idle workers land exactly on it; a dispatch may overshoot),
        which keeps causality clean: a request routed at ``t`` is never
        served before it arrived."""
        for w in self._live():
            serve = w.serve
            while True:
                now = serve.clock.now()
                if t_limit is not None and now >= t_limit:
                    break
                pick = serve._pick(now, can_wait=can_wait)
                if pick is not None:
                    serve._dispatch(pick[0], pick[1])
                    w.busy_us += serve.clock.now() - now
                    self._gauge(w)
                    continue
                if t_limit is None:
                    break               # drained: no work, no more events
                nxt = t_limit
                dl = serve._next_deadline()
                if dl is not None:
                    nxt = min(nxt, dl)
                if nxt <= now:
                    # float plateau: ``head + max_wait_us`` rounds down to
                    # ``now`` while the expiry comparison still judges the
                    # head not-yet-due by one ulp — the clock cannot move
                    # and _pick never fires. The head IS at its deadline
                    # within float precision: serve it instead of spinning.
                    work = serve._work_classes()
                    heads = {c: serve._head_arrival(c) for c in work}
                    serve._dispatch(min(work, key=lambda c: (heads[c], c)),
                                    "deadline")
                    w.busy_us += serve.clock.now() - now
                    self._gauge(w)
                    continue
                serve.clock.advance_to(nxt)
                if nxt >= t_limit:
                    break

    def _route(self, t: float, label: str, inputs: Dict) -> Ticket:
        """Place one arrival on a fabric (or reject it by name)."""
        try:
            name, how = self.router.place(
                label, self._depths(),
                {w.name: self._load_us(w, t) for w in self._live()},
                frozenset(self.dead))
        except UnroutableError as e:
            # never entered any worker: fleet-level named rejection with
            # full accounting (offered == served+rejected+failed holds
            # fleet-wide including these)
            tk = Ticket(_PhantomArtifact(label), inputs)
            tk.t_arrival = t
            tk._reject(AdmissionError(str(e)), t)
            self.unroutable.append(tk)
            self._trace("unroutable", t, label)
            obs.inc("fleet.unroutable")
            return tk
        w = self._by_name[name]
        tk = w.serve.offer(w.artifacts[label], inputs, t=t)
        self._rid_label[tk.rid] = label
        self._owner[tk.rid] = name
        self._trace("route", t, tk.rid, label, name, how)
        if how == "steal":
            self.steals += 1
            obs.inc("fleet.steals")
        self._gauge(w)
        return tk

    # -- fault drain -------------------------------------------------------
    def fail_fabric(self, name: str, t: Optional[float] = None,
                    reason: str = "scripted failure") -> List[Ticket]:
        """Mark a fabric dead and drain its backlog to surviving peers.

        Idempotent (a second failure of the same fabric is a no-op).
        Queued and shot-paused requests move in rid order; each is
        re-bound to the target peer's geometry-specific artifact and
        re-inserted in rid order (``ServeEngine.requeue``), so class-FIFO
        completion order and the no-loss/no-duplicate invariant survive.
        A paused plan restarts from shot zero on the peer — re-execution
        is bit-exact, so no partial shot state needs to move. Requests
        with no surviving feasible fabric are rejected by name. Returns
        the moved tickets."""
        w = self._by_name[name]
        if not w.alive:
            return []
        w.alive = False
        self.dead.add(name)
        now = w.serve.clock.now() if t is None else float(t)
        if w.probe is not None:
            w.probe.retire()    # a dead fabric must stop tripping the
            #                     monitor as "stalled" forever
        moved: List[Ticket] = []
        for cls in list(w.serve._paused):
            ex = w.serve._paused.pop(cls)
            moved.append(ex.ticket)
        for q in w.serve._queues.values():
            while q:
                moved.append(q.popleft())
                w.serve._depth -= 1
        moved.sort(key=lambda tk: tk.rid)
        self._trace("fail", now, name, len(moved))
        obs.inc("fleet.failures")
        placed = []
        for tk in moved:
            label = self._rid_label[tk.rid]
            try:
                peer_name, how = self.router.place(
                    label, self._depths(),
                    {p.name: self._load_us(p, now) for p in self._live()},
                    frozenset(self.dead))
            except UnroutableError as e:
                tk._reject(AdmissionError(
                    f"fabric {name} failed ({reason}) and {e}"), now)
                w.serve.rejected.append(tk)
                self._trace("drain_reject", now, tk.rid, label)
                continue
            peer = self._by_name[peer_name]
            tk.artifact = peer.artifacts[label]
            tk.cls = tk.artifact.config_class
            peer.serve.requeue(tk)
            self._owner[tk.rid] = peer_name
            self._trace("drain", now, tk.rid, label, peer_name)
            self._gauge(peer)
            placed.append(tk)
        self.drained += len(placed)
        obs.inc("fleet.drains", len(placed))
        self._gauge(w)
        return moved

    def check_health(self, now: Optional[float] = None) -> List[str]:
        """Heartbeat-driven failure: consult the fault-tolerance
        ``HealthMonitor`` and fail every fabric it flags as stalled.
        Returns the names failed on this call."""
        if self.monitor is None:
            return []
        failed = []
        states = self.monitor.states(now)
        for i, w in enumerate(self.workers):
            if w.alive and states.get(i) == "stalled":
                self.fail_fabric(w.name, reason="heartbeat stalled")
                failed.append(w.name)
        return failed

    # -- observability / replay contract -----------------------------------
    def served_tickets(self) -> List[Ticket]:
        out = [tk for w in self.workers for tk in w.serve.served]
        out.sort(key=lambda tk: tk.rid)
        return out

    def trace_digest(self) -> str:
        """sha1 over (config digest, fleet decisions, every worker's serve
        trace) — the fleet half of the replay contract."""
        h = hashlib.sha1()
        h.update(self.cfg.digest().encode())
        for ev in self.trace:
            h.update(repr(ev).encode())
        for w in self.workers:
            h.update(w.name.encode())
            h.update(w.serve.trace_digest().encode())
        return h.hexdigest()

    def results_digest(self) -> str:
        """sha1 over every served request's outputs in global rid order,
        keyed by class *label* (labels are geometry-independent, unlike
        config classes) — this is the digest a single-engine oracle
        running the same request stream must reproduce bit-exactly."""
        h = hashlib.sha1()
        for tk in self.served_tickets():
            h.update(f"{tk.rid}|{self._rid_label[tk.rid]}".encode())
            for name in sorted(tk.outputs):
                h.update(name.encode())
                h.update(np.ascontiguousarray(
                    np.asarray(tk.outputs[name], dtype=np.int64)).tobytes())
        return h.hexdigest()

    def report(self) -> Dict:
        served = self.served_tickets()
        offered = sum(w.serve.offered for w in self.workers) \
            + len(self.unroutable)
        rejected = sum(len(w.serve.rejected) for w in self.workers) \
            + len(self.unroutable)
        failed = sum(len(w.serve.failed) for w in self.workers)
        now = max(w.serve.clock.now() for w in self.workers)
        steady = None
        if served:
            steady = max(tk.t_done for tk in served) \
                - min(tk.t_arrival for tk in served)
        lat = np.asarray([tk.latency_us for tk in served]) \
            if served else np.asarray([0.0])
        per_fabric = {}
        for w in self.workers:
            per_fabric[w.name] = {
                "geometry": list(w.spec.geometry),
                "alive": w.alive,
                "offered": w.serve.offered,
                "served": len(w.serve.served),
                "rejected": len(w.serve.rejected),
                "failed": len(w.serve.failed),
                "batches": w.serve.batches,
                "preemptions": w.serve.preemptions,
                "now_us": w.serve.clock.now(),
                "busy_us": w.busy_us,
                "utilization": w.busy_us / now if now > 0 else 0.0,
                "pinned": sorted(l for l in self.cfg.classes
                                 if self.router.pin(l) == w.name),
            }
            if obs.enabled():
                w.engine.stats.publish(prefix=f"fleet.{w.name}.engine.")
                obs.set_gauge(f"fleet.{w.name}.utilization",
                              per_fabric[w.name]["utilization"])
        return {
            "config_digest": self.cfg.digest(),
            "fabrics": len(self.workers),
            "offered": offered,
            "served": len(served),
            "rejected": rejected,
            "failed": failed,
            "unroutable": len(self.unroutable),
            "steals": self.steals,
            "drained": self.drained,
            "dead": sorted(self.dead),
            "now_us": now,
            "steady_window_us": steady,
            "throughput_rps": len(served) / now * 1e6 if now > 0 else 0.0,
            "steady_throughput_rps":
                len(served) / steady * 1e6 if steady else 0.0,
            "latency": {
                "count": len(served),
                "mean_us": float(np.mean(lat)),
                "p50_us": float(np.percentile(lat, 50)),
                "p95_us": float(np.percentile(lat, 95)),
                "p99_us": float(np.percentile(lat, 99)),
                "max_us": float(np.max(lat)),
            },
            "placements": {l: self.router.pin(l)
                           for l in sorted(self.cfg.classes)},
            "per_fabric": per_fabric,
            "trace_digest": self.trace_digest(),
        }


def fleet_workload(seed: int, config: FleetConfig, cache=None
                   ) -> List[Tuple[float, str, Dict]]:
    """The seeded labeled arrival stream a :class:`FleetEngine` soak
    serves — a pure function of ``(seed, config)``.

    Inputs are synthesized against reference 4x4 artifacts (input-stream
    shape depends only on the DFG, which is geometry-independent), so the
    identical stream can be replayed through a single-engine oracle for
    digest comparison."""
    from repro_torch.serve.load import (bursty_arrival_times, compile_recipe,
                                  make_labeled_requests, mix_recipes,
                                  poisson_arrival_times)
    cache = cache if cache is not None else ArtifactCache(memory_only=True)
    ref = Engine(Fabric(), backend="sim", cache=cache)
    recipes = mix_recipes(config.length, "all")
    missing = [l for l in config.classes if l not in recipes]
    if missing:
        raise ValueError(f"unknown config class(es) {missing}")
    classes = {l: compile_recipe(ref, l, config.length, recipes)
               for l in config.classes}
    rng = np.random.default_rng(seed)
    if config.bursty:
        times = bursty_arrival_times(
            rng, config.n_requests, config.burst_size,
            gap_us=config.burst_size / config.rate_per_us)
    else:
        times = poisson_arrival_times(rng, config.n_requests,
                                      config.rate_per_us)
    weights = dict(config.weights) if config.weights else None
    return make_labeled_requests(classes, times, config.length, rng,
                                 weights)


def fleet_soak(seed: int, config: FleetConfig, cache=None,
               hb_dir: Optional[str] = None, timeout_s: float = 5.0,
               device=None) -> Tuple["FleetEngine", Dict]:
    """One end-to-end deterministic fleet soak: build the fleet, generate
    the seeded workload, drive it (scripted failures included), return
    ``(fleet, report)``. The single entry point tests, benchmarks, and
    the cross-process replay harness share. ``device`` is where the
    ``"cuda"`` fabrics run; the workload's reference engine is ``"sim"``
    whatever the fabrics' backend."""
    cache = cache if cache is not None else ArtifactCache(memory_only=True)
    fleet = FleetEngine(config, cache=cache, hb_dir=hb_dir,
                        timeout_s=timeout_s, device=device)
    report = fleet.drive(fleet_workload(seed, config, cache=cache))
    return fleet, report
