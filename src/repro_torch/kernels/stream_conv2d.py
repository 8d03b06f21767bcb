"""stream_conv2d — the 'valid' 3x3 correlation as a hand-written CUDA kernel
for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/stream_conv2d.py::
stream_conv2d`` (``pallas_call`` at line 51, body ``_conv_kernel`` at line
21): a float32 image ``(H, W)`` and a ``(3, 3)`` kernel give the
``(H-2, W-2)`` float32 correlation.

Kernel: ``conv3x3_kernel`` in ``csrc/stream_conv2d.cu``, entry point
``strela_stream_conv2d``. One block per 32 x 128 tile of output stages the
tile's input pixels plus a 2-pixel halo in shared memory and applies the
nine taps from registers. The Pallas wrapper's padded and ``jnp.roll``
copies of the image (its three row streams) are TPU plumbing and have no
counterpart: the kernel reads the image once. It rounds each product and
sum on its own, in the plain version's order, so the two agree bit for
bit. ``block_rows`` is no parameter: the tile is the kernel's own.

Bound on the H100: bytes (each pixel read once and written once, 4 bytes
each, against 18 floating-point operations).

Beside it, the plain PyTorch version (``ref.conv2d_3x3``) runs for tensors
on the CPU, and only there: a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches, ``plain_calls`` calls of the plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0
plain_calls = 0


def _check(img: torch.Tensor, kern: torch.Tensor) -> None:
    if img.dim() != 2 or tuple(kern.shape) != (3, 3):
        raise ValueError(f"stream_conv2d: needs an (H, W) image and a (3, 3) "
                         f"kernel, got {tuple(img.shape)} and "
                         f"{tuple(kern.shape)}")
    if img.shape[0] < 3 or img.shape[1] < 3:
        raise ValueError(f"stream_conv2d: a 'valid' 3x3 correlation needs "
                         f"H >= 3 and W >= 3, got {tuple(img.shape)}")
    if img.dtype != torch.float32 or kern.dtype != torch.float32:
        raise ValueError(f"stream_conv2d: image and kernel must be float32, "
                         f"got {img.dtype} and {kern.dtype}")
    if img.device != kern.device:
        raise ValueError(f"stream_conv2d: image on {img.device}, kernel on "
                         f"{kern.device}")


def conv_plain(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`conv_kernel`."""
    global plain_calls
    _check(img, kern)
    plain_calls += 1
    return ref.conv2d_3x3(img, kern)


def conv_kernel(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """The 'valid' 3x3 correlation by the CUDA kernel: contiguous CUDA
    tensors only."""
    global launches
    _check(img, kern)
    if img.device.type != "cuda":
        raise ValueError(f"stream_conv2d: the kernel runs on CUDA tensors, "
                         f"got {img.device}")
    if not (img.is_contiguous() and kern.is_contiguous()):
        raise ValueError("stream_conv2d: image and kernel must be contiguous")
    H, W = img.shape
    if H >= 2 ** 31 or W >= 2 ** 31:
        raise ValueError(f"stream_conv2d: sides must stay below 2^31, got "
                         f"{tuple(img.shape)}")
    out = torch.empty((H - 2, W - 2), dtype=torch.float32, device=img.device)
    lib = _build.load()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.strela_stream_conv2d(img.data_ptr(), kern.data_ptr(),
                                      out.data_ptr(), H, W, stream)
    _build.check(lib, rc, f"stream_conv2d {H}x{W}")
    launches += 1
    return out


def stream_conv2d(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """'valid' 3x3 correlation on the tensors' device: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if img.device.type == "cpu":
        return conv_plain(img, kern)
    return conv_kernel(img, kern)
