"""repro_torch.workloads — real model-layer compute as STRELA request
classes (counterpart of ``repro.workloads``).

Per-layer ops of transformer / SSM / MoE models decomposed into fixed-point
streaming kernels (``workloads/kernels.py``), traced through
``repro_torch.frontend``, and registered as
:class:`~repro_torch.workloads.registry.WorkloadClass` entries
(``workloads/registry.py``) that ``repro_torch.serve`` /
``repro_torch.fleet`` ingest like any other config class. See DESIGN.md §16.
"""
from repro_torch.workloads.registry import (MODEL_CLASSES, MODEL_MIX,
                                            WorkloadClass, model_recipes,
                                            model_weights,
                                            workload_input_gen)

__all__ = [
    "MODEL_CLASSES",
    "MODEL_MIX",
    "WorkloadClass",
    "model_recipes",
    "model_weights",
    "workload_input_gen",
]
