"""repro_torch.launch — launch drivers (counterpart of ``repro.launch``):
``serve_lm``, prefill and greedy decode of an LM with KV caches, and its
old name ``serve``. Training and the dry run come with later slices
(``ROADMAP.md`` queue 1 item 2e)."""
