"""``@offload`` — run a plain Python/torch function on the STRELA fabric
(counterpart of ``repro.frontend.offload``).

::

    @offload                       # or @offload(backend="cuda", debug=True)
    def relu(x):
        return torch.where(x > 0, x, 0)

    y = relu(np.arange(-4, 4, dtype=np.int32))   # traced, mapped, simulated

Each call: trace the function to an aten graph, look the graph's digest up
in the compilation cache, and on a miss lower it to a DFG, place-and-route
it (or partition it into a multi-shot plan when it exceeds the fabric),
then dispatch:

  * ``backend="sim"`` (default) — the cycle-accurate ``elastic_sim``:
    numeric results straight off the simulated OMNs, II / cycle / op counts
    on ``kernel.last`` for perf work;
  * ``backend="cuda"`` — the hand-written CUDA lane kernel
    (``kernels/fabric_reduce.run_dfg``, ``lane_kernel`` in
    ``csrc/fabric.cu``) on ``device``: the card unless the caller names
    ``"cpu"``, where the kernel's plain PyTorch version computes the values.
    Eligibility is *feature detection* against the declared capability set
    (``engine/capabilities.py``): a kernel outside it (loop-carried state,
    recirculating while-loops, segmented reductions) fails at compile time
    with a diagnostic naming the offending feature. Single-shot cuda
    dispatch has no cycle-accurate measurement, so ``kernel.last.cycles``
    reports the engine's model estimate (config + re-arm + mapped II x
    length);
  * multi-shot plans run through ``ShotRunner`` (config + re-arm cycle
    accounting on ``kernel.last.tally``) — on the cuda backend the runner's
    *value substrate* is the lane kernel, one launch per shot, chained
    through the IMN/OMN buffer handoff.

Compilation goes through the execution engine (``repro_torch.engine``):
the result is a ``CompiledArtifact`` in the *persistent* artifact cache,
keyed on the graph digest x length x fabric geometry x backend — a warm
cache survives the process, so repeat traffic skips place & route
entirely. ``fabric=`` targets a non-default geometry (e.g.
``Fabric(rows=6, cols=4)``).

``debug=True`` additionally executes the original torch function eagerly
on CPU int32 tensors and asserts the fabric results match, after wrapping
both to int32. An element-mode kernel is evaluated per element: through
``torch.vmap`` unless it recirculates (``while_loop`` does not run under
``vmap``), in which case element by element in a Python loop.

Closure semantics: values captured from the enclosing scope are read at
every trace (each call re-traces to compute its key), so rebinding a
captured tensor changes the key and recompiles.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import dfg as D
from repro_torch.core.elastic_sim import SimResult, simulate
from repro_torch.core.fabric import Fabric
from repro_torch.core.mapper import Mapping
from repro_torch.core.multishot import ShotRunner, Tally
from repro_torch.frontend.tracer import FrontendError, arg_names_of

BACKENDS = ("sim", "cuda")


@dataclasses.dataclass
class RunInfo:
    """Cost observables of the most recent call."""

    backend: str
    n_shots: int
    sim: Optional[SimResult] = None       # single-shot sim backend
    tally: Optional[Tally] = None         # multi-shot plans
    est_cycles: Optional[int] = None      # model estimate (cuda backend)
    mapping: Optional[Mapping] = None     # placement behind ``sim``
    length: Optional[int] = None          # stream extent of the call

    @property
    def ii(self) -> float:
        if self.sim is None:
            raise FrontendError("II is only measured on the sim backend")
        return self.sim.steady_ii()

    @property
    def profile(self):
        """Per-PE/IMN/OMN utilization of the measured execution
        (``repro_torch.obs.profiler.FabricProfile``) — sim backend only,
        where a cycle-accurate schedule exists to attribute."""
        if self.sim is None or self.mapping is None:
            raise FrontendError("profiling needs a measured simulation "
                                "(sim backend, single shot)")
        from repro_torch.obs.profiler import profile_sim
        return profile_sim(self.mapping, self.sim, length=self.length)

    @property
    def cycles(self) -> int:
        """Measured cycles where a simulation ran; the engine's model-based
        estimate on the cuda backend — every backend reports a cost."""
        if self.sim is not None:
            return self.sim.cycles
        if self.tally is not None:
            return self.tally.total
        if self.est_cycles is not None:
            return self.est_cycles
        raise FrontendError("no timing recorded")


@dataclasses.dataclass
class CompiledKernel:
    """A lowered + mapped kernel: a cached engine artifact plus the output
    structure needed to repack results."""

    name: str
    length: int
    artifact: Any                   # engine.CompiledArtifact
    out_shapes: List[Tuple[int, ...]]
    treedef: Any                    # torch pytree spec of fn's result
    element_mode: bool = False      # traced per-element (torch.cond kernels)

    @property
    def dfg(self) -> D.DFG:
        return self.artifact.dfg

    @property
    def plan(self) -> Any:          # frontend.partition.Plan
        return self.artifact.plan

    @property
    def mapping(self) -> Mapping:
        if self.plan.n_shots != 1:
            raise FrontendError(f"{self.name}: multi-shot plan has no single "
                                f"mapping")
        return self.plan.shots[0].mapping


class OffloadedFunction:
    """Callable wrapper produced by :func:`offload`."""

    def __init__(self, fn: Callable, backend: str = "sim",
                 debug: bool = False, name: Optional[str] = None,
                 mode: str = "auto", fabric: Optional[Fabric] = None,
                 cache: Optional[Any] = None, device=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        self.fn = fn
        self.backend = backend
        self.debug = debug
        self.name = name or getattr(fn, "__name__", "offloaded")
        self.mode = mode
        self.fabric = fabric or Fabric()
        self.device = None
        if backend == "cuda":
            # the card unless the caller names another; no card -> raises
            from repro_torch.engine.scheduler import _resolve_device
            self.device = _resolve_device(device)
        self._acache = cache            # engine ArtifactCache (None = default)
        self._cache: Dict[str, CompiledKernel] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self.last: Optional[RunInfo] = None
        self.__wrapped__ = fn
        self.__name__ = self.name

    # -- compilation --------------------------------------------------------
    def _arg_names(self) -> List[str]:
        return arg_names_of(self.fn, self.name)

    def compile(self, length: int) -> CompiledKernel:
        """Trace + lower + map for streams of ``length``.

        Two cache layers: a per-function dict holding the repack metadata,
        and the engine's persistent artifact cache underneath (shared across
        functions and across processes)."""
        from repro_torch.engine import cache as ecache
        from repro_torch.engine import compiler as ecompiler
        from repro_torch.frontend import tracer

        geometry = ecompiler.geometry_of(self.fabric)
        arg_names = self._arg_names()
        key, tg, element_mode = ecompiler.fn_cache_key(
            self.fn, length, self.mode, self.backend, geometry, arg_names)
        hit = self._cache.get(key)
        if hit is not None:
            self.cache_hits += 1
            return hit
        acache = self._acache if self._acache is not None \
            else ecache.default_cache()
        art = acache.get(key)
        if art is not None:
            self.cache_hits += 1            # persistent-cache hit: no P&R
        else:
            self.cache_misses += 1
            g = tracer.lower(tg, length, self.name, arg_names)
            art = ecompiler.build_artifact(
                g, key, self.fabric, self.backend, name=self.name,
                length=length, element_mode=element_mode)
            acache.put(art)
        ck = CompiledKernel(self.name, length, art, tg.out_shapes(length),
                            tg.treedef, element_mode)
        self._cache[key] = ck
        return ck

    # -- execution ----------------------------------------------------------
    def __call__(self, *args):
        arrays = [np.asarray(a, dtype=np.int32).reshape(-1) for a in args]
        if len(arrays) != len(self._arg_names()):
            raise TypeError(f"{self.name} expects {len(self._arg_names())} "
                            f"stream arguments, got {len(arrays)}")
        lengths = {a.shape[0] for a in arrays}
        if len(lengths) != 1:
            raise ValueError(f"{self.name}: all streams must share a length, "
                             f"got {sorted(lengths)}")
        (length,) = lengths
        ck = self.compile(length)
        inputs = dict(zip(ck.dfg.inputs, arrays))

        from repro_torch import obs
        with obs.span("offload", kernel=self.name, backend=self.backend):
            if ck.plan.n_shots == 1:
                outs, info = self._run_single(ck, inputs)
            else:
                value_fn = None
                if self.backend == "cuda":
                    from repro_torch.kernels.fabric_reduce import run_dfg
                    value_fn = functools.partial(run_dfg, device=self.device)
                runner = ShotRunner(with_timing=True, fabric=self.fabric,
                                    value_fn=value_fn)
                outs = ck.plan.run(inputs, runner=runner)
                info = RunInfo(self.backend, ck.plan.n_shots,
                               tally=runner.tally, length=length)
        self.last = info
        result = self._pack(ck, outs)
        if self.debug:
            self._check(arrays, ck, result)
        return result

    def _run_single(self, ck: CompiledKernel, inputs):
        g = ck.dfg
        if self.backend == "cuda":
            # capability features were validated at compile time
            # (engine/capabilities.py, named diagnostics); dispatch goes to
            # the CUDA lane kernel on the offload's device
            from repro_torch.kernels.fabric_reduce import run_dfg
            outs = run_dfg(g, inputs, device=self.device)
            est = ck.artifact.model_cycles(ck.length)
            return outs, RunInfo("cuda", 1, est_cycles=est)
        sim = simulate(ck.mapping, inputs)
        return dict(sim.outputs), RunInfo("sim", 1, sim=sim,
                                          mapping=ck.mapping,
                                          length=ck.length)

    def _pack(self, ck: CompiledKernel, outs: Dict[str, np.ndarray]):
        leaves = []
        for i, shape in enumerate(ck.out_shapes):
            arr = np.asarray(outs[f"out{i}"], dtype=np.int32)
            leaves.append(arr.reshape(()) if shape == () else arr)
        return pytree.tree_unflatten(leaves, ck.treedef)

    def reference(self, arrays: List[np.ndarray],
                  ck: CompiledKernel) -> List[np.ndarray]:
        """The function itself, run eagerly on CPU int32 tensors, its
        result leaves wrapped to int32 (the fabric's datapath)."""
        ts = [torch.from_numpy(np.asarray(a, dtype=np.int32)) for a in arrays]
        if not ck.element_mode:
            leaves = pytree.tree_leaves(self.fn(*ts))
        elif not ck.dfg.has_recirculation():
            leaves = pytree.tree_leaves(torch.vmap(self.fn)(*ts))
        else:
            rows = [pytree.tree_leaves(self.fn(*[t[k] for t in ts]))
                    for k in range(ck.length)]
            leaves = [torch.stack(col) for col in zip(*rows)]
        return [np.asarray(torch.as_tensor(r).to(torch.int64))
                .astype(np.int32) for r in leaves]

    def _check(self, arrays, ck: CompiledKernel, result) -> None:
        ref_leaves = self.reference(arrays, ck)
        got_leaves = pytree.tree_leaves(result)
        for i, (r, o) in enumerate(zip(ref_leaves, got_leaves)):
            if not np.array_equal(r.reshape(-1), np.asarray(o).reshape(-1)):
                raise FrontendError(
                    f"{self.name}: debug check failed on output {i}: "
                    f"fabric={np.asarray(o).reshape(-1)[:8]}... "
                    f"reference={r.reshape(-1)[:8]}...")

    def cache_info(self) -> Tuple[int, int, int]:
        return self.cache_hits, self.cache_misses, len(self._cache)


def offload(fn: Optional[Callable] = None, *, backend: str = "sim",
            debug: bool = False, name: Optional[str] = None,
            mode: str = "auto", fabric: Optional[Fabric] = None,
            cache: Optional[Any] = None, device=None):
    """Decorator: compile a Python int32-stream function onto the fabric.

    Usable bare (``@offload``) or parameterized
    (``@offload(backend="cuda", debug=True, fabric=Fabric(rows=6))``).
    ``device`` applies to ``backend="cuda"``: the card by default,
    ``"cpu"`` for the kernel's plain version.
    """
    def wrap(f: Callable) -> OffloadedFunction:
        return OffloadedFunction(f, backend=backend, debug=debug, name=name,
                                 mode=mode, fabric=fabric, cache=cache,
                                 device=device)
    return wrap(fn) if fn is not None else wrap
