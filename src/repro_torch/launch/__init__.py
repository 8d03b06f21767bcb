"""repro_torch.launch — launch drivers (counterpart of ``repro.launch``):
``serve_lm``, prefill and greedy decode of an LM with KV caches, and its
old name ``serve``; ``train``, the trainer, on one device or on a mesh;
``mesh``, the production and local ``DeviceMesh``es; ``dryrun``, every
(arch x shape x mesh) cell's step traced under ``FakeTensorMode`` on
torch's fake process group, with its roofline."""
