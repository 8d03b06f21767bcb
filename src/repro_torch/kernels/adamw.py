"""adamw — the optimizer step on the card in two hand-written multi-tensor
passes: the gradients' global sum of squares, and AdamW with the clipping
scale folded into its read of each gradient.

Replaces no TPU kernel: the JAX package's optimizer (``repro/optim/
adamw.py``) is plain jnp that XLA fuses into a few passes. On the card the
port's eager loop made about 22 float32 passes a leaf, and clipping wrote
a scaled copy of every gradient: about 184 bytes a bf16 parameter in some
10,500 launches a minicpm-2b step. The kernels (``csrc/adamw.cu``) move
what the step must:

  * ``strela_sq_norm`` (``sq_norm_kernel``, then ``sum_partials_kernel``)
    reads each included gradient once (2 bytes a bf16 parameter) and
    writes one double partial a chunk; one block sums them in a fixed
    order into a float32 0-d ``total``. No atomics, so the same gradients
    give the same bits on every run. The squares and sums are in double,
    so the total is within float32's last bit or so of an exact sum (the
    plain version sums each leaf in float32, then the leaves in order).
  * ``strela_adamw`` (``adamw_kernel``) reads g, p, m and v once and
    writes p, m and v in place (22 bytes a bf16 parameter), with ``lr``,
    the bias corrections and the scale read through device pointers. Each
    operation is the plain loop's, in its order, rounded once, so given
    the same scale the card's moments and parameters equal the plain
    loop's bit for bit.

Bound on the H100: bytes, 17.9 ms for the update and 1.6 ms for the norm
at minicpm-2b's 2.73e9 bf16 parameters (3.35 TB/s). Leaves travel in
each launch's parameters, 64 (the norm 128) a launch, as a list of
(leaf, chunk) work items that a few blocks per SM walk, so a step's
launches grow with leaves / 64, not with leaves.

Beside them, the plain PyTorch versions (:func:`sq_norm_plain`,
:func:`update_plain`: the port's eager loop, which the CPU tests hold bit
for bit against the reference) run for tensors on the CPU, and only
there: a CUDA tensor launches the kernels or raises. ``sq_norm_launches``
and ``adamw_launches`` count launches, ``plain_calls`` calls of the plain
versions.

The dispatcher knows the kernels as two operators (``torch.library``):
``strela::global_sq_norm(grads, include) -> total`` and
``strela::adamw_(params, mu, nu, grads, lr, b1c, b2c, scale, b1, b2, eps,
weight_decay) -> ()``, in place on the first three lists. Each has the
kernel's launch as its CUDA implementation and a fake one that checks the
inputs and gives the output's metadata, so ``FakeTensorMode`` (the dry
run) runs through them without touching a pointer.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from repro_torch.kernels import _build

F32 = torch.float32
DTYPES = {torch.float32: 0, torch.bfloat16: 1}     # csrc dtype codes

sq_norm_launches = 0
adamw_launches = 0
plain_calls = 0


def _include(grads: Sequence[torch.Tensor],
             include: Optional[Sequence[bool]]) -> List[bool]:
    if include is None:
        return [True] * len(grads)
    if len(include) != len(grads):
        raise ValueError(f"adamw: {len(include)} include flags for "
                         f"{len(grads)} gradients")
    return [bool(x) for x in include]


def _check_norm(grads: Sequence[torch.Tensor]) -> None:
    """What the norm kernel takes: at least one gradient, contiguous
    float32 or bfloat16 tensors on one device."""
    if not grads:
        raise ValueError("adamw: the norm needs at least one gradient")
    devices = {g.device for g in grads}
    if len(devices) != 1:
        raise ValueError(f"adamw: the gradients lie on "
                         f"{sorted(map(str, devices))}, not one device")
    for i, g in enumerate(grads):
        if g.dtype not in DTYPES:
            raise ValueError(f"adamw: gradient {i} is {g.dtype}; the kernel "
                             f"takes {sorted(map(str, DTYPES))}")
        if not g.is_contiguous():
            raise ValueError(f"adamw: gradient {i} is not contiguous")


def _check_update(params, mu, nu, grads, lr, b1c, b2c, scale) -> None:
    """What the update kernel takes: one leaf of each list per parameter,
    bfloat16 or float32 parameters with gradients of their dtype and
    shape, float32 moments, all contiguous on one device, and float32
    0-d ``lr``, ``b1c``, ``b2c`` and ``scale`` (or None) there too."""
    if not (len(params) == len(mu) == len(nu) == len(grads)):
        raise ValueError(f"adamw: {len(grads)} grads, {len(params)} params, "
                         f"{len(mu)} and {len(nu)} moments")
    tensors = [*params, *mu, *nu, *grads, lr, b1c, b2c]
    if scale is not None:
        tensors.append(scale)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"adamw: the update's tensors lie on "
                         f"{sorted(map(str, devices))}, not one device")
    for name, t in (("lr", lr), ("b1c", b1c), ("b2c", b2c),
                    ("scale", scale)):
        if t is not None and (t.dtype != F32 or t.dim() != 0):
            raise ValueError(f"adamw: {name} must be a float32 0-d tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for i, (p, m, v, g) in enumerate(zip(params, mu, nu, grads)):
        if p.dtype not in DTYPES:
            raise ValueError(f"adamw: parameter {i} is {p.dtype}; the kernel "
                             f"takes {sorted(map(str, DTYPES))}")
        if g.dtype != p.dtype:
            raise ValueError(f"adamw: gradient {i} is {g.dtype}, its "
                             f"parameter {p.dtype}")
        if m.dtype != F32 or v.dtype != F32:
            raise ValueError(f"adamw: the moments of leaf {i} are {m.dtype} "
                             f"and {v.dtype}, not float32")
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"adamw: leaf {i}: parameter {tuple(p.shape)}, "
                             f"gradient {tuple(g.shape)}, moments "
                             f"{tuple(m.shape)} and {tuple(v.shape)}")
        for name, t in (("parameter", p), ("gradient", g), ("mu", m),
                        ("nu", v)):
            if not t.is_contiguous():
                raise ValueError(f"adamw: {name} {i} is not contiguous")


# ---------------------------------------------------------------------------
# the plain versions (the port's eager loop)
# ---------------------------------------------------------------------------

def sq_norm_plain(grads: Sequence[torch.Tensor],
                  include: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """The float32 sum of squares of the included gradients, leaf by leaf
    in order, as the reference's Python ``sum``."""
    global plain_calls
    plain_calls += 1
    total = torch.zeros((), dtype=F32, device=grads[0].device)
    for g, inc in zip(grads, _include(grads, include)):
        if inc:
            total = total + torch.sum(g.to(F32) ** 2)
    return total


def update_plain(params, mu, nu, grads, lr, b1c, b2c, scale, b1: float,
                 b2: float, eps: float, weight_decay: float) -> None:
    """AdamW in place, leaf by leaf, in float32; a gradient is first
    scaled by ``scale`` (None: 1) and cast back to its dtype, as
    clipping's scaled copy is."""
    global plain_calls
    plain_calls += 1
    for g, m, v, p in zip(grads, mu, nu, params):
        if scale is not None:
            g = (g.to(F32) * scale).to(g.dtype)
        gf = g.to(F32)
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        pf = p.to(F32)
        step = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        step = step + weight_decay * pf
        p.copy_((pf - lr * step).to(p.dtype))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _array(ctype, values) -> ctypes.Array:
    return (ctype * max(len(values), 1))(*values)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptrs(tensors: Sequence[torch.Tensor]) -> ctypes.Array:
    return _array(ctypes.c_longlong, [t.data_ptr() for t in tensors])


def _on_cuda(tensors: Sequence[torch.Tensor]) -> None:
    if tensors[0].device.type != "cuda":
        raise ValueError(f"adamw: the kernels run on CUDA tensors, got "
                         f"{tensors[0].device}")


def sq_norm_kernel(grads: List[torch.Tensor], include: List[bool]
                   ) -> torch.Tensor:
    """The included gradients' sum of squares by ``strela_sq_norm``, a
    float32 0-d tensor on their device."""
    global sq_norm_launches
    _check_norm(grads)
    _on_cuda(grads)
    leaves = [g for g, inc in zip(grads, _include(grads, include))
              if inc and g.numel()]
    total = torch.empty((), dtype=F32, device=grads[0].device)
    lib = _build.load()
    sizes = _array(ctypes.c_longlong, [g.numel() for g in leaves])
    partials = torch.empty(
        lib.strela_sq_norm_partials(sizes, len(leaves)),
        dtype=torch.float64, device=total.device)
    launches = ctypes.c_int(0)
    with torch.cuda.device(total.device):
        rc = lib.strela_sq_norm(
            _ptrs(leaves), sizes,
            _array(ctypes.c_int, [DTYPES[g.dtype] for g in leaves]),
            len(leaves), partials.data_ptr(), total.data_ptr(),
            _stream(total), ctypes.addressof(launches))
    _build.check(lib, rc, f"sq_norm over {len(leaves)} leaves")
    sq_norm_launches += launches.value
    return total


def adamw_kernel(params: List[torch.Tensor], mu: List[torch.Tensor],
                 nu: List[torch.Tensor], grads: List[torch.Tensor],
                 lr: torch.Tensor, b1c: torch.Tensor, b2c: torch.Tensor,
                 scale: Optional[torch.Tensor], b1: float, b2: float,
                 eps: float, weight_decay: float) -> None:
    """AdamW in place by ``strela_adamw``."""
    global adamw_launches
    _check_update(params, mu, nu, grads, lr, b1c, b2c, scale)
    if not params:
        return
    _on_cuda(params)
    keep = [i for i, p in enumerate(params) if p.numel()]
    pick = lambda ts: [ts[i] for i in keep]          # noqa: E731
    f = ctypes.c_float
    lib = _build.load()
    launches = ctypes.c_int(0)
    with torch.cuda.device(params[0].device):
        rc = lib.strela_adamw(
            _ptrs(pick(grads)), _ptrs(pick(params)), _ptrs(pick(mu)),
            _ptrs(pick(nu)),
            _array(ctypes.c_longlong, [params[i].numel() for i in keep]),
            _array(ctypes.c_int, [DTYPES[params[i].dtype] for i in keep]),
            len(keep), lr.data_ptr(), b1c.data_ptr(), b2c.data_ptr(),
            None if scale is None else scale.data_ptr(),
            f(b1), f(1 - b1), f(b2), f(1 - b2), f(eps), f(weight_decay),
            _stream(params[0]), ctypes.addressof(launches))
    _build.check(lib, rc, f"adamw over {len(keep)} leaves")
    adamw_launches += launches.value


# ---------------------------------------------------------------------------
# the kernels as operators the dispatcher knows
# ---------------------------------------------------------------------------

_lib = torch.library.Library("strela", "FRAGMENT")
_lib.define("global_sq_norm(Tensor[] grads, bool[] include) -> Tensor")
_lib.define("adamw_(Tensor(a!)[] params, Tensor(b!)[] mu, Tensor(c!)[] nu, "
            "Tensor[] grads, Tensor lr, Tensor b1c, Tensor b2c, "
            "Tensor? scale, float b1, float b2, float eps, "
            "float weight_decay) -> ()")
_lib.impl("global_sq_norm", sq_norm_kernel, "CUDA")
_lib.impl("adamw_", adamw_kernel, "CUDA")


@torch.library.register_fake("strela::global_sq_norm", lib=_lib)
def _sq_norm_fake(grads, include):
    _check_norm(grads)
    _include(grads, include)
    return grads[0].new_empty((), dtype=F32)


@torch.library.register_fake("strela::adamw_", lib=_lib)
def _adamw_fake(params, mu, nu, grads, lr, b1c, b2c, scale, b1, b2, eps,
                weight_decay):
    _check_update(params, mu, nu, grads, lr, b1c, b2c, scale)


def global_sq_norm(grads: Sequence[torch.Tensor],
                   include: Optional[Sequence[bool]] = None
                   ) -> torch.Tensor:
    """The float32 0-d sum of squares of the gradients (of those whose
    ``include`` flag is set) on their device: the plain version for CPU
    tensors, ``strela::global_sq_norm`` for any other."""
    if grads[0].device.type == "cpu":
        return sq_norm_plain(grads, include)
    return torch.ops.strela.global_sq_norm(list(grads),
                                           _include(grads, include))


def update(params, mu, nu, grads, lr, b1c, b2c, scale, b1: float, b2: float,
           eps: float, weight_decay: float) -> None:
    """AdamW in place on the tensors' device: the plain version for CPU
    tensors, ``strela::adamw_`` for any other."""
    if not params or params[0].device.type == "cpu":
        update_plain(params, mu, nu, grads, lr, b1c, b2c, scale, b1, b2,
                     eps, weight_decay)
        return
    torch.ops.strela.adamw_(list(params), list(mu), list(nu), list(grads),
                            lr, b1c, b2c, scale, b1, b2, eps, weight_decay)
