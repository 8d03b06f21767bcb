"""fabric_reduce — N same-DFG requests with reductions in one CUDA grid,
plus ``run_dfg``: the capability-gated dispatcher the engine's ``"cuda"``
backend calls.

Replaces the Pallas TPU kernel ``repro/kernels/fabric_reduce.py::
fabric_reduce_lanes`` (``pallas_call`` at line 183, body ``_emit_body`` at
line 84): lane-batched streams, select-reducible Branch/Merge, and
single-emission associative reductions (ADD, SUB as ``acc - sum(x)``, MUL,
AND, OR, XOR, all wrapping mod 2^32) folded per lane from ``acc_init``.
Stride-0 outputs keep the last element.

Kernel: ``fabric_kernel<true>`` + ``fold_kernel`` in ``csrc/fabric.cu``,
entry point ``strela_fabric_reduce_lanes``. ``blockIdx.x`` is a flattened
(lane, chunk) index; each block writes one partial per reduction node and
the fold kernel combines each lane's partials. The Pallas carry relied on
grid steps running in order; the two passes do not, and are exact because
the ops are associative and commutative mod 2^32.

Bound on the H100: bytes. The lane grid reads each input element once and
writes each full-rate output element once (int32); the integer work per
element is a few operations. The design streams every element through
registers and shared memory once, and only one partial per block and
reduction ever reaches device memory besides the outputs.

Beside it, the plain PyTorch version (:func:`reduce_lanes_plain`, built on
``ref.eval_dfg_streams`` and ``ref.fold_lanes``) runs for tensors on the
CPU and only there. ``launches`` counts kernel launches (one per grid,
fold included), ``plain_calls`` calls of the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from repro_torch.core import dfg as D
from repro_torch.engine.capabilities import (CapabilityError, check_backend,
                                             check_stream_length,
                                             dfg_features)
from repro_torch.kernels import _build, ref
from repro_torch.kernels.fabric_stream import (check_tensors, lower,
                                               pointers)

I32 = np.int32

launches = 0
plain_calls = 0

Lanes = Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]


def reduce_lanes_plain(g: D.DFG, ins: Dict[str, torch.Tensor]) -> Lanes:
    """The plain PyTorch version of :func:`reduce_lanes`."""
    global plain_calls
    plain_calls += 1
    prog = lower(g)
    shape = ins[prog.in_names[0]].shape
    outs, red_ins, _ = ref.eval_dfg_streams(g, ins)
    full = {o: outs[o].expand(shape).contiguous() for o in prog.full_names}
    red = {r: ref.fold_lanes(g.nodes[r].op, g.nodes[r].acc_init,
                             red_ins[r].expand(shape))
           for r in prog.red_names}
    return full, red


def reduce_lanes(g: D.DFG, ins: Dict[str, torch.Tensor]) -> Lanes:
    """Evaluate a DFG over N lanes of ``(N, L)`` int32 streams on the
    tensors' device. Returns the full-rate outputs ``(N, L)`` and one
    ``(N,)`` result per reduction node. CUDA tensors launch the kernel,
    CPU tensors take the plain version; nothing else runs."""
    global launches
    prog = lower(g)
    tensors = [ins[n] for n in prog.in_names]
    check_tensors(g.name, tensors, tensors[0].shape)
    n_lanes, length = tensors[0].shape
    dev = tensors[0].device
    if dev.type == "cpu":
        return reduce_lanes_plain(g, ins)
    if dev.type != "cuda":
        raise ValueError(f"{g.name}: fabric_reduce_lanes runs on cuda or "
                         f"cpu tensors, got {dev}")
    full = [torch.empty((n_lanes, length), dtype=torch.int32, device=dev)
            for _ in prog.full_names]
    n_red = len(prog.red_names)
    if n_lanes * length == 0:             # nothing to fold: acc_init, no launch
        red_out = torch.tensor(prog.red_inits, dtype=torch.int32,
                               device=dev).reshape(n_red, 1).expand(
                                   n_red, n_lanes).contiguous()
        return (dict(zip(prog.full_names, full)),
                dict(zip(prog.red_names, red_out)))
    red_out = torch.empty((n_red, n_lanes), dtype=torch.int32, device=dev)
    lib = _build.load()
    cpl = -(-length // lib.strela_chunk_elements())
    partials = torch.empty(max(n_red, 1) * n_lanes * cpl, dtype=torch.int32,
                           device=dev)
    red_ops = (ctypes.c_int * max(n_red, 1))(*prog.red_ops)
    red_inits = (ctypes.c_int * max(n_red, 1))(*prog.red_inits)
    table = prog.device_table(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.strela_fabric_reduce_lanes(
            table.data_ptr(), len(prog.table), prog.n_slots,
            pointers(tensors), len(tensors), pointers(full), len(full),
            red_ops, red_inits, n_red, partials.data_ptr(),
            red_out.data_ptr(), n_lanes, length, stream)
    _build.check(lib, rc, f"{g.name}: fabric_reduce_lanes")
    launches += 1
    return dict(zip(prog.full_names, full)), dict(zip(prog.red_names,
                                                      red_out))


def fabric_reduce_lanes(g: D.DFG, inputs_list: List[Dict[str, np.ndarray]],
                        device: Union[str, torch.device, None] = None
                        ) -> List[Dict[str, np.ndarray]]:
    """Run N same-DFG requests as one lane-batched grid on ``device`` (the
    card unless the caller names another).

    Numpy in, numpy out: each input stream is stacked on the host and
    crosses to the device in one copy, each output comes back in one copy.
    Results are bit-exact against the functional executor per lane."""
    device = torch.device("cuda" if device is None else device)
    lengths = {int(np.asarray(v).shape[0])
               for ins in inputs_list for v in ins.values()}
    if len(lengths) != 1:
        raise CapabilityError(
            f"{g.name}: a lane-batched cuda grid needs equal stream "
            f"lengths across lanes, got {sorted(lengths)}")
    (length,) = lengths
    check_stream_length(g, length)
    out_names = list(g.outputs)
    if length == 0:
        return [{o: np.zeros(0, dtype=I32) for o in out_names}
                for _ in inputs_list]
    prog = lower(g)

    ins = {name: torch.from_numpy(np.stack(
               [np.asarray(lane[name], dtype=I32) for lane in inputs_list]
           )).to(device) for name in prog.in_names}
    full, red = reduce_lanes(g, ins)
    full_np = {}
    for o, t in full.items():
        if g.nodes[o].emit_every == 0:
            t = t[:, -1:]                 # OMN stride-0 'last value' mode
        full_np[o] = t.cpu().numpy()
    red_np = dict(zip(prog.red_names,
                      torch.stack(list(red.values())).cpu().numpy()
                      if red else ()))

    results: List[Dict[str, np.ndarray]] = []
    for k in range(len(inputs_list)):
        lane: Dict[str, np.ndarray] = {}
        for o in out_names:
            if o in prog.red_of:
                lane[o] = red_np[prog.red_of[o]][k:k + 1]
            else:
                lane[o] = full_np[o][k]
        results.append(lane)
    return results


# ---------------------------------------------------------------------------
# the capability-gated dispatcher (what the engine's cuda backend calls)
# ---------------------------------------------------------------------------

def run_dfg_lanes(g: D.DFG, inputs_list: List[Dict[str, np.ndarray]],
                  device: Union[str, torch.device, None] = None
                  ) -> List[Dict[str, np.ndarray]]:
    """Dispatch N same-DFG requests to the CUDA fabric kernel.

    Raises :class:`CapabilityError` naming every feature outside the cuda
    capability set (engine/capabilities.py)."""
    check_backend(dfg_features(g), "cuda", g.name)
    return fabric_reduce_lanes(g, inputs_list, device=device)


def run_dfg(g: D.DFG, inputs: Dict[str, np.ndarray],
            device: Union[str, torch.device, None] = None
            ) -> Dict[str, np.ndarray]:
    """Single-request dispatch (one lane)."""
    return run_dfg_lanes(g, [inputs], device=device)[0]
