"""repro_torch.launch — launch drivers (counterpart of ``repro.launch``):
``serve_lm``, prefill and greedy decode of an LM with KV caches, and its
old name ``serve``; ``train``, the one-card trainer. The dry run and the
mesh come with later slices (``ROADMAP.md`` queue 1 items 2d-2e)."""
