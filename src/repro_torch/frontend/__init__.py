"""repro_torch.frontend — the port's counterpart of ``repro.frontend``.

Only the partitioner is ported so far: :func:`plan` cuts an oversized DFG
into a multi-shot plan (partition.py). The torch tracer, the reduction
patterns and ``@offload`` have no counterpart yet, so kernels enter the
port as DFGs (``core.kernels_lib`` or ``repro_torch.convert``).
"""
from repro_torch.frontend.partition import FrontendError, Plan, Shot, plan

__all__ = ["FrontendError", "Plan", "Shot", "plan"]
