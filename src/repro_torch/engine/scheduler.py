"""The execution engine: artifact dispatch with config-class batching
(counterpart of ``repro.engine.scheduler``).

The paper's central performance lever is amortization: multi-shot traffic
wins (115.96 vs 72.68 MOPs/mW, Table II) exactly when reconfiguration and
stream re-arm costs are shared across work. ``Engine`` applies that lever
at the request level:

  * ``run(artifact, inputs)`` — *naive per-request dispatch*. Between
    independent requests the fabric cannot be assumed to still hold the
    caller's configuration (another tenant may have claimed it), so every
    run pays a full configuration fetch plus re-arm.
  * ``submit(...)`` / ``flush()`` — *batched dispatch*. Queued requests
    are grouped by their artifact's config class (stable within a class,
    classes ordered by first arrival); consecutive shots sharing a fabric
    configuration pay only the re-arm preamble
    (``SYNC + 14*streams_changed + 5*config_words``) instead of a full
    reconfiguration. The scheduler may reorder *across* classes only —
    requests are independent by contract (data-dependent phases flush
    between submissions).

Backends differ only in their *value substrate* (``ShotRunner.value_fn``):
``sim`` computes values with the functional executor, ``cuda`` with the
hand-written CUDA fabric interpreter (``kernels/fabric_reduce.run_dfg``) on
the engine's device. Cycle accounting is identical — the timing simulation
is value-independent for static-rate shots and memoized per config class,
so the cuda path reports the same measured cycles as sim. Eligibility is declared, not
special-cased: every artifact carries its required capability features and
``Engine`` validates them against the backend's capability set
(``engine/capabilities.py``), raising diagnostics that name the offending
feature.

On the cuda backend, ``flush()`` additionally coalesces consecutive
same-artifact single-shot requests into one **lane-batched** kernel grid
(``run_dfg_lanes``, mirroring the simulator's ``simulate_lanes``): a
config-class batch costs one kernel launch instead of N (its reductions
close in the same pass; a second, fold launch runs only for lanes longer
than 4096 elements), with one host-to-device copy per input stream and
one device-to-host copy per output.

The public API stays numpy in, numpy out, as in the reference. The cuda
backend runs on the card unless the caller passes ``device="cpu"`` (the
tests do), where the kernels' plain PyTorch versions compute the values.

All cycle accounting lands in the shared ``ShotRunner`` tally;
``EngineStats`` additionally tracks what the same requests would have cost
one-by-one, so the batching savings are directly observable.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.fabric import Fabric
from repro_torch.core.multishot import ShotRunner, Tally
from repro_torch.engine import capabilities
from repro_torch.engine.artifact import ArtifactError, CompiledArtifact
from repro_torch.engine.cache import ArtifactCache, default_cache
from repro_torch.engine import compiler


def _resolve_device(device) -> torch.device:
    """The cuda backend's device: the card unless the caller names
    another. Never a silent move to the CPU: asking for the card (or
    asking for nothing) without one raises here, at construction."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Engine(backend='cuda') needs a CUDA device and none is "
            "available; pass device='cpu' to run the kernels' plain "
            "versions on the CPU")
    return dev


@dataclasses.dataclass
class EngineStats:
    """Batching observability: actual vs naive-dispatch configuration cost.

    Re-based on ``repro_torch.obs`` without breaking this public API:
    the dataclass fields stay authoritative and always update; when the
    obs metrics registry is enabled every increment is mirrored into the
    ``engine.*`` counters/gauges (see ``Engine._execute`` / ``flush``),
    and :meth:`publish` snapshots the whole struct into the registry so
    exporters see the same numbers clients read here.
    """

    requests: int = 0
    flushes: int = 0
    config_cycles_paid: int = 0       # what the batched schedule charged
    config_cycles_naive: int = 0      # what one-by-one dispatch would charge
    lane_batches: int = 0             # kernel grids serving > 1 request
    lane_requests: int = 0            # requests served inside those grids
    lane_batch_failures: int = 0      # grids that fell back to per-request

    @property
    def config_cycles_saved(self) -> int:
        return self.config_cycles_naive - self.config_cycles_paid

    def publish(self, registry=None,
                prefix: str = "engine.stats.") -> None:
        """Snapshot every field into the obs metrics registry as
        ``<prefix>*`` gauges (no-op when obs is disabled).

        The default prefix keeps the single-engine metric names; a fleet
        (``repro_torch.fleet``) publishes each fabric worker's stats under
        ``fleet.<fabric>.engine.`` so N engines never collide on one
        gauge."""
        registry = registry if registry is not None else obs.registry()
        if registry is None:
            return
        for f in dataclasses.fields(self):
            registry.gauge(f"{prefix}{f.name}").set(getattr(self, f.name))
        registry.gauge(f"{prefix}config_cycles_saved").set(
            self.config_cycles_saved)


class Handle:
    """Future-like result slot for a submitted request."""

    __slots__ = ("artifact", "inputs", "streams_changed", "layout",
                 "pe_config_words", "_outputs", "_done")

    def __init__(self, artifact: CompiledArtifact,
                 inputs: Dict[str, np.ndarray], streams_changed: int,
                 layout: Tuple[int, ...], pe_config_words: int):
        self.artifact = artifact
        self.inputs = inputs
        self.streams_changed = streams_changed
        self.layout = layout
        self.pe_config_words = pe_config_words
        self._outputs: Optional[Dict[str, np.ndarray]] = None
        self._done = False

    def result(self) -> Dict[str, np.ndarray]:
        if not self._done:
            raise ArtifactError("request not yet executed; call "
                                "Engine.flush() first")
        return self._outputs


class Engine:
    """One compile -> artifact -> run pipeline over a fixed fabric geometry.

    Wraps a ``ShotRunner`` (owned or caller-provided) so existing cycle
    accounting, per-class mapping reuse, and simulation memoization apply
    unchanged; adds artifact compilation, the persistent cache, and the
    batched request scheduler.
    """

    def __init__(self, fabric: Optional[Fabric] = None, backend: str = "sim",
                 with_timing: bool = True,
                 runner: Optional[ShotRunner] = None,
                 cache: Optional[ArtifactCache] = None,
                 mapper: Optional[str] = None,
                 device: Union[str, torch.device, None] = None):
        if backend not in capabilities.CAPS:
            raise ValueError(f"backend must be one of "
                             f"{capabilities.BACKENDS}, got {backend!r}")
        if runner is not None:
            self.runner = runner
            self.fabric = runner.fabric if fabric is None else fabric
        else:
            self.fabric = fabric or Fabric()
            self.runner = ShotRunner(with_timing=with_timing,
                                     fabric=self.fabric)
        # engine-resolved value substrate, bound to the runner only for
        # the duration of each dispatch (a ShotRunner may be shared by
        # engines of different backends — never mutate it permanently)
        from repro_torch.core.executor import execute
        if backend == "cuda":
            from repro_torch.kernels.fabric_reduce import run_dfg
            self.device = _resolve_device(device)
            self._value_fn = functools.partial(run_dfg, device=self.device)
        else:
            self.device = None
            self._value_fn = execute
        self.backend = backend
        self.cache = cache if cache is not None else default_cache()
        # None = resolve per compile from STRELA_MAPPER (so one Engine can
        # follow the env); a concrete value pins every compile it issues
        self.mapper = mapper
        self.stats = EngineStats()
        self._queue: List[Handle] = []
        self._flushing = False

    # -- compile -----------------------------------------------------------
    def compile(self, fn_or_dfg, length: Optional[int] = None,
                **kw) -> CompiledArtifact:
        kw.setdefault("fabric", self.fabric)
        kw.setdefault("backend", self.backend)
        kw.setdefault("cache", self.cache)
        if self.mapper is not None:
            kw.setdefault("mapper", self.mapper)
        return compiler.compile(fn_or_dfg, length, **kw)

    # -- dispatch ----------------------------------------------------------
    def prepare(self, artifact: CompiledArtifact,
                inputs: Dict[str, np.ndarray], *,
                streams_changed: Optional[int] = None,
                layout: Tuple[int, ...] = (),
                pe_config_words: int = 0) -> Handle:
        """Validate a request and build its :class:`Handle` WITHOUT
        queueing it — the entry point for callers that drive execution
        themselves (:meth:`iter_shots`, a serving loop).

        All capability validation happens here, where the stream length is
        first known — a request that cannot run on this backend must fail
        before it is accepted anywhere, never mid-dispatch."""
        self._check(artifact)
        missing = [n for n in artifact.dfg.inputs if n not in inputs]
        if missing:
            raise ValueError(f"{artifact.name}: missing input stream(s) "
                             f"{missing}")
        if inputs:
            lengths = {int(np.asarray(v).shape[0]) for v in inputs.values()}
            if len(lengths) != 1:
                raise ValueError(
                    f"{artifact.name}: all input streams must share a "
                    f"length, got {sorted(lengths)}")
            if self.backend != "sim":
                # every shot of a plan executes at the request length:
                # partition cuts only at rate-1 signals, so a reduction's
                # shortened emission stream can never cross a shot
                # boundary (it drains to a final OUTPUT within its shot)
                (length,) = lengths
                for shot in artifact.plan.shots:
                    capabilities.check_stream_length(shot.dfg, length,
                                                     self.backend)
        if streams_changed is None:
            g = artifact.dfg
            streams_changed = len(g.inputs) + len(g.outputs)
        return Handle(artifact, inputs, streams_changed, layout,
                      pe_config_words)

    def submit(self, artifact: CompiledArtifact,
               inputs: Dict[str, np.ndarray], *,
               streams_changed: Optional[int] = None,
               layout: Tuple[int, ...] = (),
               pe_config_words: int = 0) -> Handle:
        """Queue one request; execution happens at the next ``flush()``.

        Re-entrancy contract (pinned by tests/test_engine.py): a
        ``submit()`` issued while a ``flush()`` is in progress — e.g. from
        a value-substrate callback — queues safely for the NEXT flush; it
        is never folded into the flush already running."""
        h = self.prepare(artifact, inputs, streams_changed=streams_changed,
                         layout=layout, pe_config_words=pe_config_words)
        self._queue.append(h)
        obs.set_gauge("engine.queue_depth", len(self._queue))
        return h

    def cancel(self, h: Handle) -> bool:
        """Remove a queued, not-yet-executed request. Returns whether the
        handle was actually queued (an executed or unknown handle is a
        no-op — results are never revoked)."""
        for i, q in enumerate(self._queue):
            if q is h:
                del self._queue[i]
                obs.set_gauge("engine.queue_depth", len(self._queue))
                return True
        return False

    def flush(self, on_batch=None) -> List[Handle]:
        """Execute all queued requests, batched by config class.

        On the cuda backend, consecutive same-artifact single-shot
        requests with equal stream lengths additionally dispatch as one
        lane-batched kernel grid; cycle accounting still runs
        per-request through the runner (each lane occupies the model
        fabric for its own shot).

        ``on_batch``: optional batch-close hook — called once per
        config-class group, after every request of the group executed,
        as ``on_batch(config_class, handles)``. A serving layer
        and tests use it to observe exactly how the scheduler grouped a
        flush without re-deriving the grouping.

        ``flush()`` is not re-entrant: a nested call (from a hook or a
        value substrate) raises ``ArtifactError`` naming the violation
        instead of double-dispatching the queue."""
        if self._flushing:
            raise ArtifactError(
                "re-entrant flush(): flush() called while a flush is "
                "already dispatching; submit() during a flush queues for "
                "the next one instead")
        if not self._queue:
            return []
        queue, self._queue = self._queue, []
        self._flushing = True
        obs.set_gauge("engine.queue_depth", 0)
        # stable group-by: classes keep first-arrival order, requests keep
        # arrival order within their class
        class_rank: Dict[str, int] = {}
        class_size: Dict[str, int] = {}
        for h in queue:
            cls = h.artifact.config_class
            class_rank.setdefault(cls, len(class_rank))
            class_size[cls] = class_size.get(cls, 0) + 1
        queue.sort(key=lambda h: class_rank[h.artifact.config_class])
        if obs.enabled():
            for n in class_size.values():
                obs.observe("engine.batch_size", n)
        current: List[Handle] = []       # the unit a raise would poison
        group: List[Handle] = []         # running config-class group (hook)
        with obs.span("schedule.flush", requests=len(queue),
                      classes=len(class_rank), backend=self.backend):
            try:
                i = 0
                while i < len(queue):
                    if on_batch is not None and group and \
                            group[0].artifact.config_class != \
                            queue[i].artifact.config_class:
                        on_batch(group[0].artifact.config_class, group)
                        group = []
                    batch = [queue[i]]
                    if self.backend == "cuda" and \
                            queue[i].artifact.n_shots == 1:
                        la = self._lane_lengths(queue[i])
                        j = i + 1
                        while j < len(queue) and \
                                self._lane_compatible(queue[i], queue[j], la):
                            batch.append(queue[j])
                            j += 1
                    outs_list = None
                    if len(batch) > 1:
                        current = batch
                        try:
                            outs_list = self._run_lanes(batch)
                        except Exception:
                            # the grid fails as a unit with no way to tell
                            # which lane is at fault: fall back to
                            # per-request dispatch so only the actually-bad
                            # request is affected — counted, so a systematic
                            # grid regression (batching silently lost) is
                            # observable in the stats
                            self.stats.lane_batch_failures += 1
                            obs.inc("engine.lane_batch_failures")
                            outs_list = None
                    if outs_list is not None:
                        self.stats.lane_batches += 1
                        self.stats.lane_requests += len(batch)
                        obs.inc("engine.lane_batches")
                        obs.observe("engine.lane_occupancy", len(batch))
                        for h, outs in zip(batch, outs_list):
                            current = [h]
                            self._execute(h, outs=outs)
                    else:
                        for h in batch:
                            current = [h]
                            self._execute(h)
                    group.extend(batch)
                    i += len(batch)
                if on_batch is not None and group:
                    on_batch(group[0].artifact.config_class, group)
            except Exception:
                # never strand accepted requests — but never retry the unit
                # that raised either (re-queuing the poisoned request would
                # wedge every flush behind it forever)
                poisoned = {id(h) for h in current}
                self._queue = [h for h in queue
                               if not h._done and id(h) not in poisoned] \
                    + self._queue
                obs.set_gauge("engine.queue_depth", len(self._queue))
                raise
            finally:
                self._flushing = False
        self.stats.flushes += 1
        obs.inc("engine.flushes")
        if obs.enabled():
            obs.set_gauge("engine.rearm_cycles_saved",
                          self.stats.config_cycles_saved)
            self.stats.publish()
        return queue

    def run(self, artifact: CompiledArtifact,
            inputs: Dict[str, np.ndarray], *,
            streams_changed: Optional[int] = None,
            layout: Tuple[int, ...] = (),
            pe_config_words: int = 0) -> Dict[str, np.ndarray]:
        """Naive per-request dispatch: execute now, assuming a cold fabric."""
        h = self.submit(artifact, inputs, streams_changed=streams_changed,
                        layout=layout, pe_config_words=pe_config_words)
        self._queue.pop()
        self.runner.invalidate_config()
        self._execute(h)
        return h.result()

    def iter_shots(self, h: Handle):
        """Execute a prepared request one shot at a time — the engine's
        **preemption points**.

        Yields ``(shot_index, n_shots)`` after each shot completes; between
        two ``next()`` calls the caller may dispatch arbitrary other work
        through this engine (the resumed shot then pays a reconfiguration,
        exactly as real preemption would). After exhaustion ``h.result()``
        holds the bit-exact outputs — intermediate shot streams live in the
        suspended generator, so interleaving never corrupts them. Cycle and
        stats accounting matches :meth:`flush` dispatching the same handle.
        """
        art = h.artifact
        paid = 0            # config cycles charged to THIS request's shots
        t0 = time.perf_counter() if obs.enabled() else 0.0
        self.stats.config_cycles_naive += art.config_cycles()
        for shot in art.plan.shots:
            self.runner.seed_mapping(shot.key, shot.mapping)
        for (key, length, layout, n_banks), tr in art.timing_traces.items():
            self.runner.seed_trace(key, length, layout, tr)
        plan = art.plan
        env = {(name, "out"): np.asarray(h.inputs[name], dtype=np.int32)
               for name in plan.dfg.inputs}
        results: Dict[str, np.ndarray] = {}
        n = plan.n_shots
        for i, shot in enumerate(plan.shots):
            prev_value_fn = self.runner.value_fn
            self.runner.value_fn = self._value_fn
            shot_before = self.runner.tally.config
            try:
                with obs.span(f"dispatch.{self.backend}", kernel=art.name,
                              config_class=art.config_class, shot=i,
                              shots=n):
                    if n == 1:
                        ins = {iname: np.asarray(h.inputs[iname],
                                                 dtype=np.int32)
                               for iname, _ in shot.inputs}
                        outs = self.runner.run_shot(
                            shot.key, shot.dfg, ins,
                            streams_changed=h.streams_changed,
                            pe_config_words=h.pe_config_words,
                            layout=h.layout, config_class=art.config_class)
                    else:
                        ins = {iname: env[sig] for iname, sig in shot.inputs}
                        outs = self.runner.run_shot(
                            shot.key, shot.dfg, ins,
                            streams_changed=len(shot.inputs) +
                            len(shot.outputs),
                            config_class=shot.key)
            finally:
                self.runner.value_fn = prev_value_fn
            # charge only this shot's config fetches — interleaved foreign
            # work between two yields must never bill this request
            paid += self.runner.tally.config - shot_before
            for oname, sig in shot.outputs:
                env[sig] = outs[oname]
            for orig, oname in shot.finals.items():
                results[orig] = outs[oname]
            if n == 1:
                h._outputs = outs
            yield i, n
        if n > 1:
            missing = [o for o in plan.dfg.outputs if o not in results]
            if missing:
                raise ArtifactError(
                    f"{art.name}: plan never produced {missing}")
            h._outputs = {o: results[o] for o in plan.dfg.outputs}
        h._done = True
        self.stats.requests += 1
        self.stats.config_cycles_paid += paid
        if t0:
            obs.observe("engine.request_latency_us",
                        (time.perf_counter() - t0) * 1e6)
            obs.inc("engine.requests")
            obs.inc("engine.config_cycles_paid", paid)
            obs.inc("engine.config_cycles_naive", art.config_cycles())
        self._harvest_traces(art)

    # -- internals ---------------------------------------------------------
    def _check(self, artifact: CompiledArtifact) -> None:
        geo = compiler.geometry_of(self.fabric)
        if artifact.geometry != geo:
            raise ArtifactError(
                f"{artifact.name}: artifact compiled for geometry "
                f"{artifact.geometry}, engine fabric is {geo}")
        # declared capability gate: diagnostics name the offending features
        capabilities.check_backend(artifact.features, self.backend,
                                   artifact.name)

    @staticmethod
    def _lane_lengths(h: Handle) -> set:
        return {np.asarray(v).shape[0] for v in h.inputs.values()}

    def _lane_compatible(self, a: Handle, b: Handle, la: set) -> bool:
        """Can ``b`` ride the same lane-batched grid as the batch head
        ``a`` (whose length set ``la`` the caller computed once)?"""
        if b.artifact.key != a.artifact.key or b.artifact.n_shots != 1:
            return False
        return self._lane_lengths(b) == la

    def _run_lanes(self, batch: List[Handle]) -> List[Dict[str, np.ndarray]]:
        """One kernel grid for N same-artifact requests."""
        from repro_torch.kernels.fabric_reduce import run_dfg_lanes
        g = batch[0].artifact.plan.shots[0].dfg
        ins = [{k: np.asarray(h.inputs[k], dtype=np.int32)
                for k in g.inputs} for h in batch]
        return run_dfg_lanes(g, ins, device=self.device)

    def _execute(self, h: Handle,
                 outs: Optional[Dict[str, np.ndarray]] = None) -> None:
        art = h.artifact
        before = self.runner.tally.config
        t0 = time.perf_counter() if obs.enabled() else 0.0
        self.stats.config_cycles_naive += art.config_cycles()
        for shot in art.plan.shots:
            self.runner.seed_mapping(shot.key, shot.mapping)
        for (key, length, layout, n_banks), tr in art.timing_traces.items():
            self.runner.seed_trace(key, length, layout, tr)
        prev_value_fn = self.runner.value_fn
        self.runner.value_fn = self._value_fn
        try:
            with obs.span(f"dispatch.{self.backend}", kernel=art.name,
                          config_class=art.config_class,
                          shots=art.n_shots):
                if art.n_shots == 1:
                    shot = art.plan.shots[0]
                    ins = {iname: np.asarray(h.inputs[iname], dtype=np.int32)
                           for iname, _ in shot.inputs}
                    h._outputs = self.runner.run_shot(
                        shot.key, shot.dfg, ins,
                        streams_changed=h.streams_changed,
                        pe_config_words=h.pe_config_words, layout=h.layout,
                        config_class=art.config_class, outs=outs)
                else:
                    h._outputs = art.plan.run(h.inputs, runner=self.runner)
        finally:
            self.runner.value_fn = prev_value_fn
        h._done = True
        self.stats.requests += 1
        paid = self.runner.tally.config - before
        self.stats.config_cycles_paid += paid
        if t0:
            obs.observe("engine.request_latency_us",
                        (time.perf_counter() - t0) * 1e6)
            obs.inc("engine.requests")
            obs.inc("engine.config_cycles_paid", paid)
            obs.inc("engine.config_cycles_naive", art.config_cycles())
        self._harvest_traces(art)

    def _harvest_traces(self, art: CompiledArtifact) -> None:
        """Persist timing traces the runner recorded for this artifact's
        shots: the first execution of a static-rate shot pays one cycle
        simulation, every later dispatch — in this process or any other —
        replays the trace from the artifact cache."""
        fresh = self.runner.fresh_traces()
        if not fresh:
            return
        shot_keys = {s.key for s in art.plan.shots}
        added = False
        for tkey, tr in fresh.items():
            if tkey[0] in shot_keys and tkey not in art.timing_traces:
                art.timing_traces[tkey] = tr
                added = True
        if added:
            self.cache.put(art)

    # -- observability -----------------------------------------------------
    @property
    def tally(self) -> Tally:
        return self.runner.tally

    def pending(self) -> int:
        return len(self._queue)
