"""repro_torch: the PyTorch/CUDA port of the STRELA reproduction.

Each subpackage mirrors the JAX package ``repro`` module for module, so a
port module names the reference module it is held against:

  repro_torch.core      — the paper's model (DFG IR, mapper, elastic cycle
                          simulator, multi-shot runner), copied verbatim
  repro_torch.obs       — spans and metrics (copied verbatim)
  repro_torch.frontend  — the multi-shot partitioner
  repro_torch.engine    — compile -> artifact -> ``Engine``; backends
                          ``"sim"`` and ``"cuda"``
  repro_torch.kernels   — hand-written CUDA kernels for Hopper
                          (``csrc/fabric.cu``) and their plain PyTorch
                          versions
  repro_torch.convert   — reference DFGs and inputs into the port's types

The port imports ``torch``, never ``jax`` and nothing of ``repro``.
"""
