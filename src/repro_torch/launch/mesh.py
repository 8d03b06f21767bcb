"""Device meshes (counterpart of ``repro.launch.mesh``): the production
meshes (one pod 16 x 16, two pods 2 x 16 x 16) and a local debug mesh.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the current process group: one process per device (SPMD), where
JAX's single controller addresses every device from one process. With no
process group yet, :func:`make_local_mesh` starts a one-rank group on a
``file://`` store in a temporary directory (``nccl`` for ``cuda``,
``gloo`` for ``cpu``); under ``torchrun`` it joins the launcher's group
from ``RANK``/``WORLD_SIZE``. :func:`make_production_mesh` needs a group
of 256 or 512 ranks, which a dry run gets from the fake process group
(``torch.testing._internal.distributed.fake_pg.FakeStore``, backend
``"fake"``).
"""
from __future__ import annotations

import os
import tempfile
from typing import Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def compat_make_mesh(shape: Sequence[int], axes: Tuple[str, ...],
                     device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the current process
    group's ranks, in rank order (the last axis varies fastest), on the
    card unless ``device_type`` asks for the CPU."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16 x 16 = 256 ranks per pod ('data' x 'model'); the multi-pod mesh
    adds a leading 'pod' axis (2 pods = 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_make_mesh(shape, axes, device_type)


def ensure_process_group(device_type: str) -> None:
    """Join ``torchrun``'s group (``RANK``/``WORLD_SIZE`` set), or start a
    one-rank group on a ``file://`` store; no-op if a group exists."""
    if dist.is_initialized():
        return
    backend = BACKENDS[device_type]
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return
    store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
    dist.init_process_group(backend, init_method=f"file://{store}", rank=0,
                            world_size=1)


def make_local_mesh(model_axis: int = 1,
                    device: str = "cuda") -> DeviceMesh:
    """(world // model_axis, model_axis) ('data', 'model') over the ranks
    of the current group (started if needed). Raises ``ValueError`` when
    ``model_axis`` does not divide the world size, where the reference's
    ``n // model_axis`` drops ranks silently."""
    device_type = str(device).split(":")[0]
    ensure_process_group(device_type)
    n = dist.get_world_size()
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"make_local_mesh: a model axis of {model_axis} "
                         f"does not divide the world size {n}")
    return compat_make_mesh((n // model_axis, model_axis),
                            ("data", "model"), device_type)
