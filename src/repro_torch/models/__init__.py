"""repro_torch.models — the LM families (counterpart of ``repro.models``).

  * ``layers`` — norms, rope, GQA attention on the flash kernel, MLPs,
    the loss and the padded-vocab mask, as plain functions on tensors
  * ``moe`` — the MoE layer: float32 router, top-k, capacity-bounded
    sort dispatch with drops, stacked experts, the ordered combine
  * ``transformer`` — the dense / MoE decoder with a vlm's patch
    embeddings (``Block``, ``Transformer``, ``init_caches``)
  * ``ssm`` — the Mamba-2 SSD layer (causal conv, chunked form, decode
    recurrence, gated RMSNorm) and the Mamba-2 LM (``SSMBlock``,
    ``Mamba2LM``, ``init_lm_states``)
  * ``hybrid`` — Zamba-2: SSD layers and one shared attention block run
    at every ``share_every``-th layer (``SharedBlock``, ``Hybrid``,
    ``init_decode_state``)
  * ``encdec`` — the Whisper encoder-decoder: non-causal encoder over
    the stub frontend's frames, decoder with causal self-attention,
    cross-attention and a tied head (``EncoderLayer``, ``DecoderLayer``,
    ``EncDec``, ``encode``, ``decode``, ``init_caches``)
  * ``api`` — ``build_model(cfg)`` -> ``ModelAPI`` (``init_params``,
    ``loss``, ``prefill``, ``decode_step``, and for the dry run
    ``input_specs``/``state_specs``) for every family: dense, moe, vlm,
    ssm, hybrid and audio
"""
from repro_torch.models.api import ModelAPI, build_model

__all__ = ["ModelAPI", "build_model"]
