"""fabric_stream — the one-shot STRELA engine as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/fabric_stream.py::
fabric_stream`` (``pallas_call`` at line 86): one acyclic, reduction-free
DFG evaluated over int32 streams in one fused pass, so each stream element
makes a single round trip through device memory (the paper's
no-scratchpad streaming argument).

Kernel: ``fabric_kernel<false>`` in ``csrc/fabric.cu``, entry point
``strela_fabric_stream``: one lane, no reductions. It interprets the
instruction table that :func:`lower` builds from the DFG (shared with
``fabric_reduce``), one thread per element.

Bound on the H100: bytes. Each input stream is read once and each output
written once, 4 bytes per element each, against a handful of integer
operations per element; at 3.35 TB/s memory is the limit. The design keeps
the whole DFG in one kernel so no intermediate wire ever reaches device
memory.

Beside it, the plain PyTorch version (``ref.eval_dfg_elementwise``) runs
for tensors on the CPU, and only there: a CUDA tensor launches the kernel
or raises. ``launches`` counts kernel launches, ``plain_calls`` calls of
the plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core import dfg as D
from repro_torch.engine.capabilities import CapabilityError
from repro_torch.kernels import _build, ref

# the kernel's fixed capacities (must match csrc/fabric.cu)
MAX_SLOTS = 64
MAX_INSTR = 128
MAX_IO = 16
MAX_RED = 16
INSTR_WORDS = 8            # kind op dst a b c imm aux

K_INPUT, K_CONST, K_ALU, K_CMP, K_MUX, K_BRANCH, K_MERGE, K_RED, K_OUT = \
    range(9)

launches = 0
plain_calls = 0


@dataclasses.dataclass
class Program:
    """A DFG lowered to the kernel's instruction table."""

    table: np.ndarray              # (n_instr, 8) int32, topological order
    n_slots: int
    in_names: List[str]
    full_names: List[str]          # full-rate OUTPUTs, kernel output order
    red_names: List[str]           # reduction nodes, sorted
    red_ops: List[int]
    red_inits: List[int]
    red_of: Dict[str, str]         # reduction-fed OUTPUT -> its node
    _device_tables: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    def device_table(self, device: torch.device) -> torch.Tensor:
        key = str(device)
        t = self._device_tables.get(key)
        if t is None:
            t = torch.from_numpy(self.table).to(device)
            self._device_tables[key] = t
        return t


def _imm(value) -> int:
    v = 0 if value is None else int(value)
    return ((v + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def lower(g: D.DFG) -> Program:
    """Lower a streamable DFG to the kernel's instruction table.

    Raises the plain evaluator's ``ValueError`` for what no streaming
    substrate evaluates (back edges, non-reducible merges), and a
    :class:`CapabilityError` naming the limit for a DFG larger than the
    kernel holds. Memoized on the DFG (dropped when it is pickled)."""
    memo = g.__dict__.get("_cuda_program")
    if memo is not None:
        return memo
    ref.check_streamable(g)
    slot: Dict[tuple, int] = {}

    def new_slot(wire) -> int:
        slot[wire] = len(slot)
        return slot[wire]

    def src(name: str, port: str) -> int:
        e = g.operand(name, port)
        return -1 if e is None else slot[(e.src, e.src_port)]

    in_names = list(g.inputs)
    red_of = {o: g.operand(o, "a").src for o in g.outputs
              if g.nodes[g.operand(o, "a").src].is_reduction()}
    full_names = [o for o in g.outputs if o not in red_of]
    red_names = sorted(n.name for n in g.nodes.values() if n.is_reduction())
    for r in red_names:
        if g.nodes[r].op not in ref.IDENTITY:
            raise CapabilityError(
                f"{g.name}: reduction node '{r}' uses the non-associative "
                f"op {g.nodes[r].op.name}; the cuda kernel folds only "
                f"{sorted(op.name for op in ref.IDENTITY)}")
    rows = []
    for name in g.topo_order():
        n = g.nodes[name]
        if n.kind == D.INPUT:
            rows.append([K_INPUT, 0, new_slot((name, "out")),
                         in_names.index(name), -1, -1, 0, 0])
        elif n.kind == D.CONST:
            rows.append([K_CONST, 0, new_slot((name, "out")), -1, -1, -1,
                         _imm(n.value), 0])
        elif n.kind == D.ALU and n.is_reduction():
            a = -1 if n.value is not None else src(name, "a")
            rows.append([K_RED, int(n.op), -1, a, -1, -1, _imm(n.value),
                         red_names.index(name)])
        elif n.kind in (D.ALU, D.CMP, D.MUX, D.MERGE):
            kind = {D.ALU: K_ALU, D.CMP: K_CMP, D.MUX: K_MUX,
                    D.MERGE: K_MERGE}[n.kind]
            a, b = src(name, "a"), src(name, "b")
            c = src(name, "ctrl") if n.kind == D.MUX else -1
            op = int(n.op) if n.op is not None else 0
            rows.append([kind, op, new_slot((name, "out")), a, b, c,
                         _imm(n.value), 0])
        elif n.kind == D.BRANCH:
            a, c = src(name, "a"), src(name, "ctrl")
            t = new_slot((name, "t"))
            f = new_slot((name, "f"))
            rows.append([K_BRANCH, 0, t, a, f, c, 0, 0])
        elif n.kind == D.OUTPUT and name in full_names:
            rows.append([K_OUT, 0, -1, src(name, "a"), -1, -1, 0,
                         full_names.index(name)])
    limits = (("wire slots", len(slot), MAX_SLOTS),
              ("instructions", len(rows), MAX_INSTR),
              ("input streams", len(in_names), MAX_IO),
              ("full-rate outputs", len(full_names), MAX_IO),
              ("reduction nodes", len(red_names), MAX_RED))
    for what, n_used, cap in limits:
        if n_used > cap:
            raise CapabilityError(
                f"{g.name}: needs {n_used} {what}, the cuda fabric kernel "
                f"holds {cap} — split the DFG (pe_limit) or use "
                f"backend='sim'")
    prog = Program(
        table=np.asarray(rows, dtype=np.int32).reshape(-1, INSTR_WORDS),
        n_slots=len(slot), in_names=in_names, full_names=full_names,
        red_names=red_names,
        red_ops=[int(g.nodes[r].op) for r in red_names],
        red_inits=[_imm(g.nodes[r].acc_init) for r in red_names],
        red_of=red_of)
    g.__dict__["_cuda_program"] = prog
    return prog


def pointers(tensors: List[torch.Tensor]) -> ctypes.Array:
    arr = (ctypes.c_longlong * MAX_IO)()
    for i, t in enumerate(tensors):
        arr[i] = t.data_ptr()
    return arr


def check_tensors(what: str, tensors: List[torch.Tensor], shape) -> None:
    """The kernels take contiguous int32 tensors of one shape, on one
    device; anything else raises here, before a launch."""
    dev = tensors[0].device if tensors else None
    for t in tensors:
        if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) or \
                not t.is_contiguous() or t.device != dev:
            raise ValueError(
                f"{what}: every stream must be a contiguous int32 tensor "
                f"of shape {tuple(shape)} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def stream_plain(g: D.DFG, ins: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of :func:`stream_kernel`."""
    global plain_calls
    plain_calls += 1
    shape = next(iter(ins.values())).shape
    outs = ref.eval_dfg_elementwise(g, ins)
    return {o: v.expand(shape).contiguous() for o, v in outs.items()}


def stream_kernel(g: D.DFG, ins: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Evaluate a reduction-free DFG over ``(L,)`` int32 streams on the
    tensors' device: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    global launches
    ref.reject_reductions(g)
    prog = lower(g)
    tensors = [ins[n] for n in prog.in_names]
    check_tensors(g.name, tensors, tensors[0].shape)
    (length,) = tensors[0].shape
    dev = tensors[0].device
    if dev.type == "cpu":
        return stream_plain(g, ins)
    if dev.type != "cuda":
        raise ValueError(f"{g.name}: fabric_stream runs on cuda or cpu "
                         f"tensors, got {dev}")
    outs = [torch.empty(length, dtype=torch.int32, device=dev)
            for _ in prog.full_names]
    if length == 0:
        return dict(zip(prog.full_names, outs))
    lib = _build.load()
    table = prog.device_table(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.strela_fabric_stream(
            table.data_ptr(), len(prog.table), prog.n_slots,
            pointers(tensors), len(tensors), pointers(outs), len(outs),
            length, stream)
    _build.check(lib, rc, f"{g.name}: fabric_stream")
    launches += 1
    return dict(zip(prog.full_names, outs))


def fabric_stream(g: D.DFG,
                  inputs: Dict[str, Union[torch.Tensor, np.ndarray]],
                  device: Union[str, torch.device, None] = None
                  ) -> Dict[str, torch.Tensor]:
    """Run an acyclic, reduction-free DFG over 1-D int32 streams.

    ``device``: where to run. ``None`` keeps tensors on their device and
    sends numpy inputs to the card; ``"cpu"`` runs the plain version.
    Returns int32 tensors on that device, one per OUTPUT."""
    ref.reject_reductions(g)
    in_names = list(g.inputs)
    ins: Dict[str, torch.Tensor] = {}
    for n in in_names:
        x = inputs[n]
        dev: Optional[Union[str, torch.device]] = device
        if dev is None:
            dev = x.device if isinstance(x, torch.Tensor) else "cuda"
        ins[n] = torch.as_tensor(x).to(device=dev,
                                       dtype=torch.int32).contiguous()
    lengths = {int(t.shape[0]) for t in ins.values()}
    if len(lengths) != 1:
        raise ValueError(f"{g.name}: all input streams must share a "
                         f"length, got {sorted(lengths)}")
    return stream_kernel(g, ins)
