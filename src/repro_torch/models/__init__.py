"""repro_torch.models — the LM families (counterpart of ``repro.models``).

  * ``layers`` — norms, rope, GQA attention on the flash kernel, MLPs,
    the loss and the padded-vocab mask, as plain functions on tensors
  * ``transformer`` — the dense decoder (``Block``, ``Transformer``,
    ``init_caches``)
  * ``api`` — ``build_model(cfg)`` -> ``ModelAPI`` (``init_params``,
    ``loss``, ``prefill``, ``decode_step``)

The other families (moe, vlm, ssm, hybrid, audio) raise
``NotImplementedError`` naming their queue item in ``ROADMAP.md``.
"""
from repro_torch.models.api import ModelAPI, build_model

__all__ = ["ModelAPI", "build_model"]
