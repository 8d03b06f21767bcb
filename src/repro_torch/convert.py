"""Carry DFGs and inputs across from the reference package.

The port's counterpart of loading weights: a reference ``repro.core.dfg.DFG``
(a ``kernels_lib`` kernel, a conformance-corpus case, a traced graph) is
rebuilt as a ``repro_torch.core.dfg.DFG`` by reading its attributes only.
Nothing here imports ``repro``: the reference graph is duck-typed, and each
op is mapped by its enum *name*, so the two packages' enums never mix.

Inputs need no conversion: both packages take numpy int32 streams.
"""
from __future__ import annotations

from repro_torch.core import dfg as D
from repro_torch.core.isa import AluOp, CmpOp


def _op(kind: str, op):
    if op is None:
        return None
    enum = CmpOp if kind == D.CMP else AluOp
    return enum[op.name]


def dfg_from_reference(g) -> D.DFG:
    """Rebuild a reference DFG as a port DFG (validated on the way)."""
    nodes = {}
    for name, n in g.nodes.items():
        nodes[name] = D.Node(name=n.name, kind=n.kind, op=_op(n.kind, n.op),
                             value=n.value, acc_init=n.acc_init,
                             emit_every=n.emit_every)
    edges = [D.Edge(src=e.src, src_port=e.src_port, dst=e.dst,
                    dst_port=e.dst_port, back=e.back, init=e.init)
             for e in g.edges]
    out = D.DFG(name=g.name, nodes=nodes, edges=edges,
                inputs=list(g.inputs), outputs=list(g.outputs))
    out.validate()
    return out

