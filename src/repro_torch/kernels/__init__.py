"""repro_torch.kernels — the fabric kernels, written by hand in CUDA C++
for Hopper (``csrc/fabric.cu``, built at first use by ``_build.py``), each
beside its plain PyTorch version (``ref.py``).

  * ``fabric_reduce`` — ``fabric_reduce_lanes``: N same-DFG requests in
    one grid, with single-emission reductions (replaces the Pallas kernel
    of ``repro.kernels.fabric_reduce``)
  * ``fabric_stream`` — ``fabric_stream``: one acyclic, reduction-free DFG
    over int32 streams (replaces ``repro.kernels.fabric_stream``)
"""
