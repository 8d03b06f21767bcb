"""Spans on the profiler's clock: ``obs`` spans that also show in a
``torch.profiler`` trace, for code whose time lies on the device (the
training step's phases, the MoE layer's stages).

``span(name)`` is a context manager:

* neither the torch profiler nor ``obs`` recording: the shared
  ``obs.NULL_SPAN``, after two flag tests (an ungated
  ``record_function`` costs about 13 us a call on a CPU, the tests a
  tenth of a microsecond);
* the torch profiler recording: a host range on the profile's own clock
  beside the device's operations. The outermost span of a thread is a
  ``torch.profiler.record_function`` (a user annotation), which for work
  launched from the calling thread also gets a range on the device's
  timeline (``gpu_user_annotation``). A span opened inside it is a host
  range only (``torch._C._profiler._RecordFunctionFast``): the profiler
  gives each kernel to the innermost user annotation alone, so a nested
  annotation would take its kernels out of the outer span's device
  range;
* ``obs`` enabled: ``obs.span(name)`` into the ring too, so
  ``obs.export_chrome`` shows the same spans.

The spans the port opens, and the benchmark metrics that read them:

* ``train.forward``, ``train.backward``, ``train.optimizer``:
  ``launch/train.py`` ``make_step``; ``forward_idle_ms``,
  ``backward_idle_ms``, ``optimizer_idle_ms`` and
  ``optimizer_device_ms``;
* ``optim.clip``: ``optim/adamw.py`` ``clip_scale`` and
  ``clip_scale_on_mesh`` (the norm and the clipping scale);
  ``clip_device_ms``;
* ``optim.adamw``: ``optim/adamw.py`` ``AdamW.update``;
  ``adamw_device_ms``;
* ``moe.route``, ``moe.experts``, ``moe.combine``: ``models/moe.py``
  ``moe_apply`` (the router, top-k, aux loss, slot plan and gather; the
  three expert products and SiLU; the rows put back and combined), in
  each MoE layer's forward, so inside ``train.forward`` in a training
  step; ``moe_route_ms``, ``moe_experts_roofline``, ``moe_combine_ms``.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.autograd.profiler as _profiler

from repro_torch import obs


_depth = threading.local()


def span(name: str):
    """A span named ``name`` in whichever of the torch profiler and
    ``obs`` is recording; the shared no-op when neither is."""
    if not _profiler._is_profiler_enabled:
        return obs.span(name)
    return _profiled(name)


@contextlib.contextmanager
def _profiled(name: str):
    depth = getattr(_depth, "n", 0)
    rng = (torch.profiler.record_function(name) if depth == 0
           else torch._C._profiler._RecordFunctionFast(name))
    _depth.n = depth + 1
    try:
        with rng, obs.span(name):
            yield
    finally:
        _depth.n = depth
