"""The always-on serving engine: async ingestion, continuous config-class
batching, shot-boundary preemption, admission control (DESIGN.md §14).

``Engine.submit/flush`` amortizes reconfiguration only *within one
synchronous flush* — the library-call shape. :class:`ServeEngine` turns
that into a service: requests arrive asynchronously, are admitted against
a bounded queue (named ``AdmissionError`` rejections = backpressure),
grouped **continuously** by config class in per-class FIFO queues, and
dispatched by a rolling batcher that closes a batch on

  * **size**     — the class accumulated ``max_batch`` requests;
  * **deadline** — the class's oldest request waited ``max_wait_us``;
  * **switch**   — other classes have work too (work-conserving under a
                   mixed backlog; the open batch never holds the fabric
                   hostage);
  * **drain**    — no further arrivals can come (shutdown flush).

Long requests (multi-shot plans) execute through
``Engine.iter_shots`` and are **preempted at shot boundaries** whenever
another class's head request has waited ``preempt_wait_us`` — protecting
short-kernel latency; the preempted plan resumes later (paying the
reconfiguration preemption really costs) with bit-exact results.

Determinism: under a :class:`~repro_torch.serve.clock.VirtualClock` the loop
is a discrete-event simulation — service time is the engine's modeled cycle
count times ``us_per_cycle``, and every decision lands in ``self.trace``,
whose sha1 (:meth:`ServeEngine.trace_digest`) replays identically across
processes for the same seed. :class:`Server` wraps the same state machine
in a worker thread + ingress queue for real wall-clock operation.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import queue as _queue
import threading
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.serve.clock import VirtualClock, WallClock
from repro_torch.serve.slo import SLOTracker


class AdmissionError(RuntimeError):
    """A request the service refused to take on — bounded-queue
    backpressure or a drained (stalled) class. The message names the
    class, the reason, and the capacity involved, mirroring the
    ``CapabilityError`` style of naming every offending condition."""


# ticket lifecycle states
QUEUED, RUNNING, DONE, REJECTED, FAILED = (
    "queued", "running", "done", "rejected", "failed")


class Ticket:
    """One request's journey through the service. Thread-safe completion:
    ``result()`` blocks on an event in wall-clock mode and returns
    immediately in virtual mode (completion is synchronous there)."""

    __slots__ = ("rid", "artifact", "inputs", "cls", "t_arrival", "t_done",
                 "status", "outputs", "error", "_ev")

    def __init__(self, artifact, inputs: Dict[str, np.ndarray]):
        self.rid: Optional[int] = None          # assigned at offer()
        self.artifact = artifact
        self.inputs = inputs
        self.cls: str = artifact.config_class
        self.t_arrival: Optional[float] = None
        self.t_done: Optional[float] = None
        self.status = QUEUED
        self.outputs: Optional[Dict[str, np.ndarray]] = None
        self.error: Optional[BaseException] = None
        self._ev = threading.Event()

    @property
    def latency_us(self) -> Optional[float]:
        if self.t_done is None or self.t_arrival is None:
            return None
        return self.t_done - self.t_arrival

    def _complete(self, outputs: Dict[str, np.ndarray], t: float) -> None:
        self.outputs, self.t_done, self.status = outputs, t, DONE
        self._ev.set()

    def _reject(self, err: BaseException, t: float) -> None:
        self.error, self.t_done, self.status = err, t, REJECTED
        self._ev.set()

    def _fail(self, err: BaseException, t: float) -> None:
        self.error, self.t_done, self.status = err, t, FAILED
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None
               ) -> Dict[str, np.ndarray]:
        if not self._ev.wait(timeout):
            raise TimeoutError(f"request {self.rid} ({self.cls}) still "
                               f"pending after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.outputs


@dataclasses.dataclass
class ServeConfig:
    """Serving policy knobs. Times are serve-clock microseconds."""

    max_batch: int = 8              # batch-close on size
    max_wait_us: float = 400.0      # batch-close deadline (head-of-line age)
    queue_capacity: int = 64        # admission bound across all classes
    preempt_wait_us: float = 150.0  # waiting head age that preempts a plan
    us_per_cycle: float = 0.01      # modeled fabric clock (100 MHz)
    slo_p99_us: Optional[float] = None   # report-only budget


class _Exec:
    """A preemptible in-flight execution (one multi-shot request)."""

    __slots__ = ("ticket", "handle", "gen", "shot_i", "n_shots")

    def __init__(self, ticket: Ticket, handle, gen):
        self.ticket = ticket
        self.handle = handle
        self.gen = gen
        self.shot_i = -1
        self.n_shots = ticket.artifact.n_shots


def _noop_ingest(now: float) -> None:
    return None


class ServeEngine:
    """Deterministic single-worker serving state machine over an
    :class:`repro_torch.engine.Engine`.

    Drive it one of two ways: :meth:`drive` (discrete-event loop under a
    ``VirtualClock`` — tests, benchmarks, replay) or via :class:`Server`
    (worker thread + ingress queue under a ``WallClock``). The engine
    passed in is owned exclusively by this service — nothing else may
    submit to it."""

    def __init__(self, engine, config: Optional[ServeConfig] = None,
                 clock=None, probe=None):
        self.engine = engine
        self.cfg = config or ServeConfig()
        self.clock = clock or VirtualClock()
        self.probe = probe
        self.slo = SLOTracker(self.cfg.slo_p99_us)
        self._queues: Dict[str, Deque[Ticket]] = {}
        self._paused: Dict[str, _Exec] = {}
        self._stalled: set = set()
        self._depth = 0
        self._ids = itertools.count()
        self._last_class: Optional[str] = None
        self.trace: List[tuple] = []
        self.served: List[Ticket] = []
        self.rejected: List[Ticket] = []
        self.failed: List[Ticket] = []
        self.offered = 0
        self.preemptions = 0
        self.batches = 0
        self.close_reasons: Dict[str, int] = {}

    # -- ingestion ---------------------------------------------------------
    def offer(self, artifact, inputs: Dict[str, np.ndarray],
              t: Optional[float] = None,
              ticket: Optional[Ticket] = None) -> Ticket:
        """Admit (or reject) one arriving request. ``t`` is the arrival
        time (defaults to the clock); rejection is synchronous and named.
        """
        tk = ticket if ticket is not None else Ticket(artifact, inputs)
        tk.rid = next(self._ids)
        now = self.clock.now() if t is None else float(t)
        tk.t_arrival = now
        self.offered += 1
        self._trace("arrive", now, tk.rid, tk.cls)
        if tk.cls in self._stalled:
            return self._refuse(tk, now, AdmissionError(
                f"{tk.artifact.name}: class {tk.cls} is drained (stalled "
                f"backend) — request {tk.rid} rejected"))
        if self._depth >= self.cfg.queue_capacity:
            return self._refuse(tk, now, AdmissionError(
                f"{tk.artifact.name}: queue full "
                f"({self._depth}/{self.cfg.queue_capacity}) — request "
                f"{tk.rid} rejected (class {tk.cls})"))
        self._queues.setdefault(tk.cls, deque()).append(tk)
        self._depth += 1
        obs.set_gauge("serve.queue_depth", self._depth)
        return tk

    def requeue(self, tk: Ticket) -> None:
        """Re-admit an already-admitted ticket drained from a failed peer
        (fleet fault-drain, DESIGN.md §15) WITHOUT re-counting it as
        offered or re-assigning its rid.

        The ticket keeps its original arrival stamp (queue age keeps
        counting toward deadlines and preemption), and it is inserted
        into its class FIFO in rid order, so class-FIFO completion order
        survives a drain. A paused multi-shot ticket restarts from shot
        zero here — re-execution is bit-exact, so no partial state needs
        to move."""
        now = self.clock.now()
        tk.status = QUEUED
        q = self._queues.setdefault(tk.cls, deque())
        pos = len(q)
        while pos > 0 and q[pos - 1].rid > tk.rid:
            pos -= 1
        q.insert(pos, tk)
        self._depth += 1
        self._trace("requeue", now, tk.rid, tk.cls)
        obs.set_gauge("serve.queue_depth", self._depth)

    def _refuse(self, tk: Ticket, now: float,
                err: AdmissionError) -> Ticket:
        tk._reject(err, now)
        self.rejected.append(tk)
        self._trace("reject", now, tk.rid, tk.cls)
        obs.inc("serve.rejections")
        return tk

    # -- scheduling --------------------------------------------------------
    def _head_arrival(self, cls: str) -> float:
        ex = self._paused.get(cls)
        if ex is not None:
            return ex.ticket.t_arrival
        return self._queues[cls][0].t_arrival

    def _work_classes(self) -> List[str]:
        return sorted(c for c in set(self._queues) | set(self._paused)
                      if self._paused.get(c) is not None
                      or self._queues.get(c))

    def _pick(self, now: float, can_wait: bool
              ) -> Optional[Tuple[str, str]]:
        """Choose the next (config class, batch-close reason) to dispatch,
        or None to keep accumulating. Deterministic: ties break on
        (head arrival, class name)."""
        work = self._work_classes()
        if not work:
            return None
        heads = {c: self._head_arrival(c) for c in work}
        expired = [c for c in work if now - heads[c] >= self.cfg.max_wait_us]
        if expired:
            return min(expired, key=lambda c: (heads[c], c)), "deadline"
        # sticky: keep the fabric on its current class while it has work
        cls = self._last_class if self._last_class in heads \
            else min(work, key=lambda c: (heads[c], c))
        if self._paused.get(cls) is not None:
            # a paused plan must not resume past the very backlog that
            # earned its preemption — yield to the waiting class first
            if len(work) > 1 and self._preempt_due(cls, now):
                other = min((c for c in work if c != cls),
                            key=lambda c: (heads[c], c))
                if self._paused.get(other) is not None:
                    return other, "resume"
                return other, "switch"
            return cls, "resume"
        if len(self._queues.get(cls, ())) >= self.cfg.max_batch:
            return cls, "size"
        if len(work) > 1:
            return cls, "switch"       # mixed backlog: work-conserving
        if not can_wait:
            return cls, "drain"        # nothing else will ever arrive
        return None                    # lone small batch: accumulate

    def _next_deadline(self) -> Optional[float]:
        work = self._work_classes()
        if not work:
            return None
        return min(self._head_arrival(c) for c in work) + \
            self.cfg.max_wait_us

    def _preempt_due(self, running_cls: str, now: float) -> bool:
        for c in self._work_classes():
            if c != running_cls and \
                    now - self._head_arrival(c) >= self.cfg.preempt_wait_us:
                return True
        return False

    # -- execution ---------------------------------------------------------
    def _dispatch(self, cls: str, reason: str,
                  ingest: Callable[[float], None] = _noop_ingest) -> None:
        now = self.clock.now()
        if reason == "resume" or self._paused.get(cls) is not None:
            ex = self._paused.pop(cls)
            self._trace("resume", now, ex.ticket.rid, ex.shot_i + 1)
            self._run_exec(ex, ingest)
        else:
            q = self._queues[cls]
            if q[0].artifact.n_shots > 1:
                # preemptible unit: one plan at a time through iter_shots
                tk = q.popleft()
                self._depth -= 1
                self._close(now, cls, reason, [tk])
                self._start_exec(tk, ingest)
            else:
                batch = []
                while q and len(batch) < self.cfg.max_batch \
                        and q[0].artifact.n_shots == 1:
                    # a queued multi-shot plan ends the sweep: it must go
                    # through iter_shots to stay preemptible
                    batch.append(q.popleft())
                self._depth -= len(batch)
                self._close(now, cls, reason, batch)
                self._run_batch(batch)
        self._last_class = cls
        obs.set_gauge("serve.queue_depth", self._depth)

    def _close(self, now: float, cls: str, reason: str,
               batch: Sequence[Ticket]) -> None:
        self.batches += 1
        self.close_reasons[reason] = self.close_reasons.get(reason, 0) + 1
        self._trace("close", now, cls, reason,
                    tuple(tk.rid for tk in batch))
        obs.inc("serve.batches_closed")
        obs.inc(f"serve.batch_close.{reason}")
        obs.observe("serve.batch_size", len(batch))

    def _run_batch(self, batch: List[Ticket]) -> None:
        """One continuous-batcher unit: same-class single-shot requests
        through ``Engine.submit``/``flush`` (cuda additionally lane-
        batches them into one grid). Service time = modeled cycles."""
        before = self.engine.tally.total
        handles = []
        for tk in batch:
            tk.status = RUNNING
            try:
                handles.append(self.engine.submit(tk.artifact, tk.inputs))
            except Exception as e:              # named capability/validation
                handles.append(None)
                self._fail(tk, e)
        try:
            self.engine.flush()
        except Exception as e:
            for tk, h in zip(batch, handles):
                if h is not None and not h._done:
                    self.engine.cancel(h)
                    self._fail(tk, e)
        self.clock.advance(
            (self.engine.tally.total - before) * self.cfg.us_per_cycle)
        done_t = self.clock.now()
        completed = []
        for tk, h in zip(batch, handles):
            if h is not None and h._done:
                tk._complete(h.result(), done_t)
                self.served.append(tk)
                self.slo.record(tk.cls, tk.latency_us)
                completed.append(tk.rid)
        if completed:
            self._trace("complete", done_t, tuple(completed))
        if self.probe is not None:
            self.probe.beat()

    def _start_exec(self, tk: Ticket,
                    ingest: Callable[[float], None]) -> None:
        tk.status = RUNNING
        try:
            h = self.engine.prepare(tk.artifact, tk.inputs)
        except Exception as e:
            self._fail(tk, e)
            return
        self._run_exec(_Exec(tk, h, self.engine.iter_shots(h)), ingest)

    def _run_exec(self, ex: _Exec,
                  ingest: Callable[[float], None]) -> None:
        """Advance a preemptible execution shot by shot until it finishes
        or a waiting class earns a preemption."""
        tk = ex.ticket
        while True:
            before = self.engine.tally.total
            try:
                i, n = next(ex.gen)
            except StopIteration:
                now = self.clock.now()
                tk._complete(ex.handle.result(), now)
                self.served.append(tk)
                self.slo.record(tk.cls, tk.latency_us)
                self._trace("complete", now, (tk.rid,))
                return
            except Exception as e:
                self._fail(tk, e)
                return
            ex.shot_i = i
            self.clock.advance(
                (self.engine.tally.total - before) * self.cfg.us_per_cycle)
            now = self.clock.now()
            self._trace("shot", now, tk.rid, i)
            if self.probe is not None:
                self.probe.beat()
            ingest(now)       # arrivals that landed during this shot
            if i + 1 < n and self._preempt_due(tk.cls, now):
                self._paused[tk.cls] = ex
                self.preemptions += 1
                self._trace("preempt", now, tk.rid, i + 1)
                obs.inc("serve.preemptions")
                return

    def _fail(self, tk: Ticket, err: BaseException) -> None:
        now = self.clock.now()
        tk._fail(err, now)
        self.failed.append(tk)
        self._trace("fail", now, tk.rid, type(err).__name__)
        obs.inc("serve.failures")

    # -- liveness ----------------------------------------------------------
    def check_liveness(self, now: Optional[float] = None) -> List[Ticket]:
        """Consult the probe; on a stall, drain the stalled (= last
        dispatched) class's queue with named rejections. Returns the
        drained tickets."""
        if self.probe is None or not self.probe.stalled(now):
            return []
        cls = self._last_class
        if cls is None:
            return []
        return self.drain_class(
            cls, f"backend stalled (no heartbeat for "
                 f">{self.probe.timeout_s}s)")

    def drain_class(self, cls: str, reason: str) -> List[Ticket]:
        """Reject every queued (and paused) request of ``cls`` with a
        named ``AdmissionError``; future arrivals of the class are
        refused until :meth:`reopen_class`."""
        now = self.clock.now()
        drained: List[Ticket] = []
        ex = self._paused.pop(cls, None)
        if ex is not None:
            drained.append(ex.ticket)
        q = self._queues.get(cls)
        while q:
            drained.append(q.popleft())
            self._depth -= 1
        self._stalled.add(cls)
        for tk in drained:
            self._refuse(tk, now, AdmissionError(
                f"class {cls} drained: {reason} — request {tk.rid} "
                f"rejected"))
        self._trace("drain", now, cls, len(drained))
        obs.inc("serve.drains")
        obs.set_gauge("serve.queue_depth", self._depth)
        return drained

    def reopen_class(self, cls: str) -> None:
        self._stalled.discard(cls)

    # -- the deterministic discrete-event loop -----------------------------
    def drive(self, arrivals: Sequence[Tuple[float, object, Dict]]) -> Dict:
        """Serve a whole arrival schedule ``[(t_us, artifact, inputs)...]``
        under the virtual clock; returns :meth:`report`.

        This is the replayable mode: with the same arrivals (same seed)
        the scheduling trace and every output are bit-identical across
        processes."""
        if not self.clock.virtual:
            raise ValueError("drive() requires a VirtualClock; use Server "
                             "for wall-clock operation")
        pending = list(arrivals)
        for (a, _, _), (b, _, _) in zip(pending, pending[1:]):
            if b < a:
                raise ValueError("arrivals must be sorted by time")
        i = 0

        def ingest(now: float) -> None:
            nonlocal i
            while i < len(pending) and pending[i][0] <= now:
                t, art, ins = pending[i]
                i += 1
                self.offer(art, ins, t=t)

        while True:
            now = self.clock.now()
            ingest(now)
            pick = self._pick(now, can_wait=i < len(pending))
            if pick is not None:
                self._dispatch(pick[0], pick[1], ingest)
                continue
            if i < len(pending):            # idle: jump to the next event
                nxt = pending[i][0]
                dl = self._next_deadline()
                if dl is not None:
                    nxt = min(nxt, dl)
                if nxt <= now:
                    # float plateau: ``head + max_wait_us`` rounds down to
                    # ``now`` while _pick's expiry comparison still judges
                    # the head not-yet-due by one ulp — advance_to cannot
                    # move the clock and the loop would spin forever. The
                    # head IS at its deadline within float precision:
                    # dispatch it. (Every arrival <= now was already
                    # ingested, so nxt <= now implies the deadline side.)
                    work = self._work_classes()
                    heads = {c: self._head_arrival(c) for c in work}
                    self._dispatch(min(work, key=lambda c: (heads[c], c)),
                                   "deadline", ingest)
                    continue
                self.clock.advance_to(nxt)
                continue
            break                           # no work, no future arrivals
        return self.report()

    # -- observability -----------------------------------------------------
    def _trace(self, kind: str, t: float, *args) -> None:
        self.trace.append((kind, round(float(t), 6)) + args)

    def trace_digest(self) -> str:
        h = hashlib.sha1()
        for ev in self.trace:
            h.update(repr(ev).encode())
        return h.hexdigest()

    def results_digest(self) -> str:
        """sha1 over every served request's outputs in rid order — the
        value half of the replay contract."""
        h = hashlib.sha1()
        for tk in sorted(self.served, key=lambda t: t.rid):
            h.update(f"{tk.rid}|{tk.cls}".encode())
            for name in sorted(tk.outputs):
                h.update(name.encode())
                h.update(np.ascontiguousarray(
                    np.asarray(tk.outputs[name], dtype=np.int64)).tobytes())
        return h.hexdigest()

    def steady_window_us(self) -> Optional[float]:
        """Width of the steady-state service window: first arrival of any
        *served* (admitted-and-completed) request to the last completion.
        The wall figure (``now_us``) additionally counts the pre-traffic
        lead-in and the drain tail after the final admission, so
        ``served / now_us`` understates sustained throughput — under
        light load most of the wall duration is drain (throughput below
        the offered rate with zero rejections). ``None`` until something
        was served."""
        if not self.served:
            return None
        t0 = min(tk.t_arrival for tk in self.served)
        t1 = max(tk.t_done for tk in self.served)
        return t1 - t0

    def report(self) -> Dict:
        st = self.engine.stats
        return {
            "offered": self.offered,
            "served": len(self.served),
            "rejected": len(self.rejected),
            "failed": len(self.failed),
            "in_flight": self._depth + len(self._paused),
            "preemptions": self.preemptions,
            "batches": self.batches,
            "close_reasons": dict(sorted(self.close_reasons.items())),
            "config_cycles_paid": st.config_cycles_paid,
            "config_cycles_naive": st.config_cycles_naive,
            "config_cycles_saved": st.config_cycles_saved,
            "now_us": self.clock.now(),
            "steady_window_us": self.steady_window_us(),
            "latency": self.slo.report(),
            "trace_digest": self.trace_digest(),
        }


_STOP = object()


class Server:
    """Always-on wall-clock front end: a worker thread drains a thread-safe
    ingress queue into a :class:`ServeEngine` under a ``WallClock``.

    ``submit()`` never blocks the caller on execution — it enqueues and
    returns a :class:`Ticket` whose ``result(timeout)`` waits for
    completion; admission control (bounded queue, named rejections)
    happens on the worker, and the rejection surfaces through the same
    ticket. Use as a context manager; exit stops the worker after a final
    drain flush, so no accepted request is ever lost."""

    def __init__(self, engine, config: Optional[ServeConfig] = None,
                 probe=None, poll_s: float = 0.002):
        self.core = ServeEngine(engine, config, clock=WallClock(),
                                probe=probe)
        self._ingress: _queue.Queue = _queue.Queue()
        self._poll = poll_s
        self._stopping = False
        self._thread = threading.Thread(target=self._run,
                                        name="strela-serve", daemon=True)
        self._thread.start()

    # -- client side -------------------------------------------------------
    def submit(self, artifact, inputs: Dict[str, np.ndarray]) -> Ticket:
        if self._stopping:
            raise AdmissionError(
                f"{artifact.name}: server is stopping — request refused")
        tk = Ticket(artifact, inputs)
        # stamp arrival client-side so ingress-queue wait counts toward
        # latency and max_wait_us/preempt_wait_us aging
        tk.t_arrival = self.core.clock.now()
        self._ingress.put(tk)
        return tk

    def stop(self, timeout: Optional[float] = 30.0) -> Dict:
        """Drain-and-stop: everything already accepted (or sitting in the
        ingress queue) is served before the worker exits."""
        self._stopping = True
        self._ingress.put(_STOP)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("serve worker failed to drain and stop")
        # a submit() that raced past the _stopping check may have enqueued
        # after the worker's final drain — reject it by name, don't strand it
        now = self.core.clock.now()
        while True:
            try:
                item = self._ingress.get_nowait()
            except _queue.Empty:
                break
            if item is not _STOP:
                self.core._refuse(item, now, AdmissionError(
                    f"{item.artifact.name}: server stopped — request "
                    f"refused"))
        return self.core.report()

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        if self._thread.is_alive():
            self.stop()

    # -- worker side -------------------------------------------------------
    def _drain_ingress(self, block: bool) -> bool:
        """Move ingress items into the core; returns whether _STOP was
        seen."""
        stop = False
        try:
            item = self._ingress.get(timeout=self._poll) if block \
                else self._ingress.get_nowait()
        except _queue.Empty:
            return False
        while True:
            if item is _STOP:
                stop = True
            else:
                self.core.offer(item.artifact, item.inputs,
                                t=item.t_arrival, ticket=item)
            try:
                item = self._ingress.get_nowait()
            except _queue.Empty:
                return stop

    def _ingest_cb(self, now: float) -> None:
        if self._drain_ingress(block=False):
            self._stopping = True

    def _run(self) -> None:
        stopping = False
        while True:
            if self._drain_ingress(block=not stopping):
                stopping = True
            # _ingest_cb may have consumed _STOP mid-plan and recorded it
            # only on the shared flag — fold it in or the drain never ends
            stopping = stopping or self._stopping
            now = self.core.clock.now()
            self.core.check_liveness()
            pick = self.core._pick(now, can_wait=not stopping)
            if pick is not None:
                self.core._dispatch(pick[0], pick[1], self._ingest_cb)
                continue
            if stopping and self._ingress.empty() and \
                    not self.core._work_classes():
                return
