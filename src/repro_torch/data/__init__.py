"""repro_torch.data — the synthetic data of the LM paths (counterpart of
``repro.data``).

  * ``pipeline`` — ``DataCfg``, ``TokenPipeline`` (deterministic token
    batches for training) and ``stub_frames`` (the audio conv frontend's
    stand-in), copied verbatim: numpy only
"""
