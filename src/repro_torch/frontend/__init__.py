"""repro_torch.frontend — compile Python/torch functions onto the STRELA
fabric (counterpart of ``repro.frontend``).

  * :func:`trace`   — Python/torch function -> ``core.dfg`` IR, through a
                      ``make_fx`` aten graph (tracer.py)
  * patterns        — reductions, torch.cond, while_loop and scan ->
                      accumulator / Branch-Merge / loop schemas
  * :func:`plan`    — oversized DFG -> multi-shot plan (partition.py)
  * :func:`offload` — decorator: trace, cache, map, and dispatch to the
                      cycle-accurate simulator or the CUDA lane kernel
"""
from repro_torch.frontend.offload import (CompiledKernel, OffloadedFunction,
                                          RunInfo, offload)
from repro_torch.frontend.partition import Plan, Shot, plan
from repro_torch.frontend.tracer import (FrontendError,
                                         UnsupportedPrimitiveError, trace)

__all__ = [
    "CompiledKernel", "FrontendError", "OffloadedFunction", "Plan", "RunInfo",
    "Shot", "UnsupportedPrimitiveError", "offload", "plan", "trace",
]
