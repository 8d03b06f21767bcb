"""repro_torch.kernels — the kernels of the JAX package's Pallas code,
written by hand in CUDA C++ for Hopper (``csrc/*.cu``, all built at first
use by ``_build.py``), each beside its plain PyTorch version (``ref.py``).

  * ``ops`` — the entry point (counterpart of ``repro.kernels.ops``):
    ``fabric_elementwise``, ``matmul``, ``conv2d_3x3``, ``attention``
  * ``fabric_reduce`` — ``fabric_reduce_lanes``: N same-DFG requests in
    one grid, with single-emission reductions (replaces the Pallas kernel
    of ``repro.kernels.fabric_reduce``; ``csrc/fabric.cu``)
  * ``fabric_stream`` — ``fabric_stream``: one acyclic, reduction-free DFG
    over int32 streams (replaces ``repro.kernels.fabric_stream``;
    ``csrc/fabric.cu``)
  * ``stream_matmul`` — ``C = A @ B`` with fp32 accumulation (replaces
    ``repro.kernels.stream_matmul``; ``csrc/stream_matmul.cu``)
  * ``stream_conv2d`` — the 'valid' 3x3 correlation (replaces
    ``repro.kernels.stream_conv2d``; ``csrc/stream_conv2d.cu``)
  * ``flash_attention`` — tiled online-softmax attention (replaces
    ``repro.kernels.flash_attention``; ``csrc/flash_attention.cu``)
"""
