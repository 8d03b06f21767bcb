"""repro_torch.models — the LM families (counterpart of ``repro.models``).

  * ``layers`` — norms, rope, GQA attention on the flash kernel, MLPs,
    the loss and the padded-vocab mask, as plain functions on tensors
  * ``moe`` — the MoE layer: float32 router, top-k, capacity-bounded
    sort dispatch with drops, stacked experts, the ordered combine
  * ``transformer`` — the dense / MoE decoder with a vlm's patch
    embeddings (``Block``, ``Transformer``, ``init_caches``)
  * ``api`` — ``build_model(cfg)`` -> ``ModelAPI`` (``init_params``,
    ``loss``, ``prefill``, ``decode_step``) for dense, moe and vlm

The other families (ssm, hybrid, audio) raise ``NotImplementedError``
naming their queue item in ``ROADMAP.md``.
"""
from repro_torch.models.api import ModelAPI, build_model

__all__ = ["ModelAPI", "build_model"]
