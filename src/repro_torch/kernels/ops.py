"""The port's kernel entry point (counterpart of ``repro/kernels/ops.py``).

``fabric_elementwise``, ``matmul``, ``conv2d_3x3`` and ``attention`` take
numpy arrays or tensors. ``device=None`` keeps a tensor on its device and
sends a numpy array to the card; ``device="cpu"`` (or CPU tensors) runs
the kernels' plain PyTorch versions. On CUDA tensors each call launches
its CUDA kernel or raises: there is no fallback to the plain version, and
no quiet CPU path where there is no card. ``use_kernel=False`` stands in
for the reference's ``use_pallas=False`` and runs the plain version on the
inputs' device.

float64 numpy inputs become float32, as JAX keeps them without x64.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core import dfg as D
from repro_torch.kernels import fabric_stream as fs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import stream_conv2d as sc
from repro_torch.kernels import stream_matmul as sm

Array = Union[torch.Tensor, np.ndarray]
Device = Union[str, torch.device, None]


def _place(x: Array, device: Device) -> torch.Tensor:
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda"
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t.to(device).contiguous()


def fabric_elementwise(g: D.DFG, inputs: Dict[str, Array],
                       use_kernel: bool = True, device: Device = None
                       ) -> Dict[str, torch.Tensor]:
    """One-shot DFG over int32 streams: the ``fabric_stream`` kernel or its
    plain version."""
    if use_kernel:
        return fs.fabric_stream(g, inputs, device=device)
    ins = {n: _place(inputs[n], device).to(torch.int32) for n in g.inputs}
    return fs.stream_plain(g, ins)


def matmul(a: Array, b: Array, use_kernel: bool = True,
           out_dtype: torch.dtype = torch.float32,
           device: Device = None) -> torch.Tensor:
    """``A @ B`` with fp32 accumulation, written as ``out_dtype``."""
    a, b = _place(a, device), _place(b, device)
    if use_kernel:
        return sm.stream_matmul(a, b, out_dtype)
    return sm.matmul_plain(a, b, out_dtype)


def conv2d_3x3(img: Array, kern: Array, use_kernel: bool = True,
               device: Device = None) -> torch.Tensor:
    """'valid' 3x3 correlation in float32, (H, W) -> (H-2, W-2)."""
    img = _place(img, device).to(torch.float32)
    kern = _place(kern, device).to(torch.float32)
    if use_kernel:
        return sc.stream_conv2d(img, kern)
    return sc.conv_plain(img, kern)


def attention(q: Array, k: Array, v: Array, causal: bool = True,
              use_kernel: bool = True, device: Device = None
              ) -> torch.Tensor:
    """Attention over ``(heads, seq, head_dim)``, kv heads broadcast, the
    causal mask aligned to the end of the keys."""
    q, k, v = (_place(x, device) for x in (q, k, v))
    if use_kernel:
        return fa.flash_attention(q, k, v, causal)
    return fa.attention_plain(q, k, v, causal)
