"""repro_torch.engine — the unified execution engine (counterpart of
``repro.engine``).

One pipeline for every way this package runs a kernel::

    compile(DFG, geometry) -> CompiledArtifact -> Engine.run(...)

  * :func:`compile`            — partition against an arbitrary ``Fabric``
                                 geometry, place & route, pack ISA config
                                 words (compiler.py)
  * :class:`CompiledArtifact`  — the serializable bundle, persistently
                                 cached on disk keyed by content digest x
                                 length x geometry x backend (artifact.py,
                                 cache.py)
  * :class:`Engine`            — dispatch: naive per-request ``run`` or
                                 batched ``submit``/``flush`` grouping
                                 requests by config class so same-config
                                 traffic pays re-arm instead of full
                                 reconfiguration (scheduler.py); backend
                                 ``"cuda"`` takes its values from the
                                 hand-written CUDA kernels on ``device``
  * clients                    — Table II benchmarks (gemm/gesummv/2mm)
                                 rewritten over the engine (clients.py)
"""
from repro_torch.engine.artifact import (ArtifactError, CompiledArtifact,
                                         estimate_ii)
from repro_torch.engine.cache import ArtifactCache, default_cache
from repro_torch.engine.capabilities import (CAPS, CapabilityError, check_backend,
                                             dfg_features, plan_features)
from repro_torch.engine.compiler import compile, geometry_of
from repro_torch.engine.scheduler import Engine, EngineStats, Handle

__all__ = [
    "ArtifactCache", "ArtifactError", "CAPS", "CapabilityError",
    "CompiledArtifact", "Engine", "EngineStats", "Handle", "check_backend",
    "compile", "default_cache", "dfg_features", "estimate_ii",
    "geometry_of", "plan_features",
]
