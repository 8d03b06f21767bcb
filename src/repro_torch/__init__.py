"""repro_torch: the PyTorch/CUDA port of the STRELA reproduction.

Each subpackage mirrors the JAX package ``repro`` module for module, so a
port module names the reference module it is held against:

  repro_torch.core      — the paper's model (DFG IR, mapper, elastic cycle
                          simulator, multi-shot runner) and its published
                          numbers and energy model, copied verbatim
  repro_torch.obs       — spans, metrics and the fabric profiler (copied
                          verbatim)
  repro_torch.frontend  — torch functions -> DFGs (``trace``, ``@offload``)
                          and the multi-shot partitioner
  repro_torch.engine    — compile -> artifact -> ``Engine``; backends
                          ``"sim"`` and ``"cuda"``
  repro_torch.serve     — the always-on kernel serving loop (virtual and
                          wall clocks, admission, preemption)
  repro_torch.runtime   — fault tolerance: heartbeats, the health
                          monitor, the straggler detector, the
                          trainer's supervisor and ``elastic_remesh``;
                          ``partition`` (the sharding specs, their
                          placements on a ``DeviceMesh``,
                          ``place_model``), ``tp`` (tensor-parallel
                          compute on a mesh) and ``pipeline`` (GPipe)
  repro_torch.workloads — model-layer compute as served request classes
  repro_torch.fleet     — N fabrics behind one router, with fault-drain
  repro_torch.kernels   — hand-written CUDA kernels for Hopper
                          (``csrc/*.cu``: the fabric interpreter,
                          stream_matmul, stream_conv2d, flash_attention),
                          their plain PyTorch versions, and the ``ops``
                          entry point
  repro_torch.configs   — the architecture registry (``ArchConfig``, the
                          ten LM configs, the STRELA SoC)
  repro_torch.models    — the LM families: dense, MoE, vlm, ssm, hybrid
                          and audio (layers, the MoE layer, transformer,
                          the Mamba-2 SSD layer, the Zamba-2 hybrid, the
                          Whisper encoder-decoder, ``build_model``), their
                          attention on the flash kernel
  repro_torch.data      — ``pipeline``: synthetic token batches and the
                          audio frontend's stub frames (copied verbatim)
  repro_torch.launch    — ``serve_lm``: prefill and greedy decode with KV
                          caches and SSM states; ``train``: the trainer,
                          on one device or a ("data", "model") mesh;
                          ``mesh``: the production and local meshes
  repro_torch.optim     — AdamW with its schedules, int8 gradient
                          compression with error feedback
  repro_torch.checkpoint — checkpoints in the reference's on-disk format
  repro_torch.convert   — reference DFGs, inputs and LM parameters into
                          the port's types, and parameters and optimizer
                          state back into the reference's layout

The port imports ``torch``, never ``jax`` and nothing of ``repro``.
"""
