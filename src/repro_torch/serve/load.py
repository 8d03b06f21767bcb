"""Seeded load generation: arrival processes + mixed-kernel workloads
(counterpart of ``repro.serve.load``).

Everything here is a pure function of a ``numpy.random.default_rng`` seed,
so a generated workload — arrival times, class choices, stream contents —
is bit-identical across processes. That is half of the replay contract
(the other half is the virtual clock in ``serve/clock.py``).

Arrival processes:
  * :func:`poisson_arrival_times` — open-loop Poisson (exponential gaps at
    a fixed offered rate), the classic independent-users model;
  * :func:`bursty_arrival_times` — clustered arrivals (bursts of near-
    simultaneous requests separated by exponential quiet gaps), the
    adversarial case for admission control and batch-close deadlines.

Workload construction: :func:`serve_classes` compiles a request-class mix
on a caller's engine — the paper mix (short streaming kernels, a
reduction, a multi-shot plan, an irregular loop), the model-layer mix
(``mix="model"``, the transformer/SSM/MoE classes of
``repro_torch.workloads``), or both (``mix="all"``); :func:`make_requests`
assigns a seeded class choice + input streams to each arrival time.

Backend eligibility has ONE source of truth: every mix flows through
:func:`mix_recipes` + :func:`recipe_skip_reason` (which defers to
``engine.capabilities.backend_skip_reason``), so a class that a backend
cannot lower is dropped with a *named* reason everywhere — serve soaks,
fleet placement, and the benchmarks can never silently disagree about
which classes a backend serves.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import dfg as D
from repro_torch.core import kernels_lib as K


def poisson_arrival_times(rng: np.random.Generator, n: int,
                          rate_per_us: float, t0: float = 0.0
                          ) -> np.ndarray:
    """``n`` open-loop Poisson arrival times (us) at ``rate_per_us``."""
    if rate_per_us <= 0:
        raise ValueError(f"rate_per_us must be positive, got {rate_per_us}")
    gaps = rng.exponential(1.0 / rate_per_us, n)
    return t0 + np.cumsum(gaps)


def bursty_arrival_times(rng: np.random.Generator, n: int, burst_size: int,
                         gap_us: float, intra_us: float = 0.5,
                         t0: float = 0.0) -> np.ndarray:
    """``n`` arrivals in bursts of ``burst_size``: requests inside a burst
    land ``intra_us`` apart, bursts are separated by exponential quiet
    periods with mean ``gap_us``."""
    if burst_size < 1:
        raise ValueError(f"burst_size must be >= 1, got {burst_size}")
    times: List[float] = []
    t = float(t0)
    while len(times) < n:
        t += float(rng.exponential(gap_us))
        for i in range(min(burst_size, n - len(times))):
            times.append(t + i * intra_us)
        t = times[-1]
    return np.asarray(times[:n])


def class_recipes(length: int, include_loops: bool = True,
                  include_multishot: bool = True) -> Dict[str, tuple]:
    """The standard serve workload mix as uncompiled recipes:
    ``{label: (dfg_builder, compile_kwargs)}``.

    The indirection exists for the multi-fabric fleet
    (``repro_torch.fleet``): each fabric worker compiles the same recipes
    against its *own* geometry, and a recipe whose compile fails on a
    small fabric (e.g. ``div_loop`` needs a 4x4) marks the class
    infeasible there instead of killing the whole mix."""
    recipes: Dict[str, tuple] = {
        "relu": (K.relu, {}),
        "vadd": (K.vadd, {}),
        "fft": (K.fft_butterfly, {}),
        "mac1": (lambda: K.mac1(length), {}),
    }
    if include_multishot:
        recipes["axpby_ms"] = (lambda: K.axpby(3, 5), {"pe_limit": 1})
    if include_loops:
        recipes["div_loop"] = (lambda: K.div_loop(7), {})
    return recipes


def mix_recipes(length: int, mix: str = "paper",
                include_loops: bool = True,
                include_multishot: bool = True) -> Dict[str, tuple]:
    """Uncompiled recipes of a named class mix — ``"paper"`` (the 6
    standard classes above), ``"model"`` (the transformer/SSM/MoE layer
    classes of ``repro_torch.workloads``), or ``"all"`` (both; the
    namespace the fleet resolves arbitrary ``FleetConfig.classes``
    against).

    A recipe factory returns either a ready
    :class:`~repro_torch.core.dfg.DFG` (paper classes) or a Python function
    for ``repro_torch.frontend`` to trace (model classes) —
    :func:`compile_recipe` dispatches on the result."""
    if mix == "paper":
        return class_recipes(length, include_loops=include_loops,
                             include_multishot=include_multishot)
    from repro_torch.workloads import model_recipes
    if mix == "model":
        return model_recipes(length)
    if mix == "all":
        merged = class_recipes(length, include_loops=include_loops,
                               include_multishot=include_multishot)
        models = model_recipes(length)
        clash = sorted(set(merged) & set(models))
        if clash:
            raise ValueError(f"model class labels collide with the paper "
                             f"mix: {clash}")
        merged.update(models)
        return merged
    raise ValueError(f"unknown mix {mix!r}; expected 'paper', 'model' "
                     f"or 'all'")


def compile_recipe(engine, label: str, length: int,
                   recipes: Dict[str, tuple]):
    """Compile one recipe on ``engine`` — a DFG-returning factory compiles
    directly, a traced-function factory gets the stream ``length``."""
    fn, kw = recipes[label]
    obj = fn()
    if isinstance(obj, D.DFG):
        return engine.compile(obj, **kw)
    return engine.compile(obj, length, **kw)


# (mix, label, length, backend) -> named skip reason or None; tracing a
# recipe to probe eligibility is cheap but not free, and soaks re-probe
# the same mixes at every load point
_SKIP_MEMO: Dict[tuple, Optional[str]] = {}


def recipe_skip_reason(label: str, length: int, backend: str,
                       recipes: Dict[str, tuple]) -> Optional[str]:
    """The named reason ``backend`` cannot serve class ``label`` at
    ``length`` (capability features joined with '+', per
    ``engine.capabilities.backend_skip_reason``), or None when it must.
    Probed on the uncompiled recipe — trace only, no place & route."""
    if backend == "sim":
        return None                 # the semantic reference takes the IR
    key = (label, length, backend)
    if key not in _SKIP_MEMO:
        from repro_torch.engine.capabilities import backend_skip_reason
        fn, _ = recipes[label]
        obj = fn()
        if not isinstance(obj, D.DFG):
            from repro_torch.frontend import trace
            obj = trace(obj, length)
        _SKIP_MEMO[key] = backend_skip_reason(obj, length, backend)
    return _SKIP_MEMO[key]


def artifact_skip_reason(artifact, length: int,
                         backend: str) -> Optional[str]:
    """Post-compile twin of :func:`recipe_skip_reason`: the named reason
    ``backend`` cannot run a compiled artifact (plan-level features, so
    multi-shot partitioning is included), or None."""
    from repro_torch.engine.capabilities import (CapabilityError,
                                                 check_stream_length,
                                                 missing_features)
    missing = missing_features(artifact.features, backend)
    if missing:
        return "+".join(missing)
    if backend != "sim":
        try:
            for shot in artifact.plan.shots:
                check_stream_length(shot.dfg, length, backend)
        except CapabilityError:
            return "segmented-reduction"
    return None


def serve_classes(engine, length: int,
                  include_loops: Optional[bool] = None,
                  include_multishot: bool = True, mix: str = "paper",
                  skipped: Optional[Dict[str, str]] = None
                  ) -> Dict[str, object]:
    """Compile a workload mix on ``engine``; returns
    ``{label: CompiledArtifact}``.

    The paper mix covers the scheduling shapes the traffic story needs:
    short streaming kernels (relu/vadd/fft — the latency-sensitive class),
    a reduction (mac1), a multi-shot plan (axpby under ``pe_limit=1`` —
    the preemptible long request), and an irregular loop (div_loop,
    data-dependent trip count). ``mix="model"`` compiles the
    transformer/SSM/MoE layer classes of ``repro_torch.workloads`` instead.

    Classes the engine's backend cannot lower are dropped with a *named*
    reason (collected into ``skipped`` when given) via
    :func:`recipe_skip_reason` — capability routing lives here, once, so
    callers never hand-maintain per-backend class lists.
    ``include_loops`` remains as an explicit mix-narrowing override
    (default None: keep every loop class the backend can serve)."""
    recipes = mix_recipes(length, mix,
                          include_loops=include_loops in (None, True),
                          include_multishot=include_multishot)
    classes: Dict[str, object] = {}
    for label in recipes:
        reason = recipe_skip_reason(label, length, engine.backend, recipes)
        if reason is not None:
            if skipped is not None:
                skipped[label] = reason
            continue
        classes[label] = compile_recipe(engine, label, length, recipes)
    return classes


def model_classes(engine, length: int,
                  skipped: Optional[Dict[str, str]] = None
                  ) -> Dict[str, object]:
    """Compile the model-layer workload mix (``repro_torch.workloads``) on
    ``engine`` — the realistic-traffic sibling of :func:`serve_classes`.
    Backend-ineligible classes are dropped with named reasons into
    ``skipped`` (e.g. the SSM recurrences on ``"cuda"``)."""
    return serve_classes(engine, length, mix="model", skipped=skipped)


def request_inputs(artifact, length: int, rng: np.random.Generator,
                   label: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Seeded input streams for one request.

    A model-layer class (``label`` in the ``repro_torch.workloads``
    registry) draws from its registered per-stream ranges — fixed-point
    kernels need operands inside their Q-format envelope for the
    int32-exact oracle contract. Otherwise the generic convention applies
    (recirculating kernels get the positive operand range the loop
    semantics require). Either way ``rng`` is consumed exactly as the
    reference consumes it, so the same seed gives the same request stream
    in both packages."""
    if label is not None:
        from repro_torch.workloads import workload_input_gen
        gen = workload_input_gen(label)
        if gen is not None:
            return gen(length, rng)
    g = artifact.dfg
    lo, hi = (1, 100) if g.has_recirculation() else (-64, 64)
    return {name: rng.integers(lo, hi, length).astype(np.int32)
            for name in g.inputs}


def make_labeled_requests(classes: Dict[str, object],
                          times: Sequence[float], length: int,
                          rng: np.random.Generator,
                          weights: Optional[Dict[str, float]] = None
                          ) -> List[Tuple[float, str,
                                          Dict[str, np.ndarray]]]:
    """Assign each arrival time a seeded class choice + input streams,
    keyed by class *label* instead of a compiled artifact.

    Returns ``[(t_us, label, inputs), ...]`` sorted by time — the shape
    ``FleetEngine.drive`` ingests (the fleet re-binds each label to the
    target fabric's geometry-specific artifact).
    Consumes the rng identically to :func:`make_requests`, so the same
    seed yields the same request stream either way — that is what lets a
    fleet soak be digest-compared against a single-engine oracle."""
    labels = sorted(classes)
    if weights is None:
        p = np.full(len(labels), 1.0 / len(labels))
    else:
        w = np.asarray([float(weights.get(l, 1.0)) for l in labels])
        p = w / w.sum()
    picks = rng.choice(len(labels), size=len(times), p=p)
    reqs = []
    for t, k in zip(times, picks):
        label = labels[int(k)]
        reqs.append((float(t), label,
                     request_inputs(classes[label], length, rng,
                                    label=label)))
    reqs.sort(key=lambda r: r[0])
    return reqs


def make_requests(classes: Dict[str, object], times: Sequence[float],
                  length: int, rng: np.random.Generator,
                  weights: Optional[Dict[str, float]] = None
                  ) -> List[Tuple[float, object, Dict[str, np.ndarray]]]:
    """Assign each arrival time a seeded class choice + input streams.

    Returns ``[(t_us, artifact, inputs), ...]`` sorted by time — exactly
    the shape :meth:`repro_torch.serve.ServeEngine.drive` ingests. ``weights``
    biases the class mix (default uniform)."""
    return [(t, classes[label], ins)
            for t, label, ins in make_labeled_requests(
                classes, times, length, rng, weights)]
