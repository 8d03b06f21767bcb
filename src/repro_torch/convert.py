"""Carry DFGs, inputs and LM parameters across from the reference package.

The port's counterpart of loading weights: a reference ``repro.core.dfg.DFG``
(a ``kernels_lib`` kernel, a conformance-corpus case, a traced graph) is
rebuilt as a ``repro_torch.core.dfg.DFG`` by reading its attributes only.
Nothing here imports ``repro``: the reference graph is duck-typed, and each
op is mapped by its enum *name*, so the two packages' enums never mix.

Inputs need no conversion: both packages take numpy int32 streams.

LM parameters arrive as the reference's parameter tree with numpy leaves
(``jax.device_get``; bfloat16 leaves are ``ml_dtypes.bfloat16`` arrays).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dfg as D
from repro_torch.core.isa import AluOp, CmpOp
from repro_torch.models.encdec import EncDec
from repro_torch.models.hybrid import Hybrid
from repro_torch.models.ssm import Mamba2LM
from repro_torch.models.transformer import Transformer


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


# the reference's leaf dtypes, by name (bfloat16 leaves are
# ``ml_dtypes.bfloat16`` arrays)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tensor(a, device) -> torch.Tensor:
    """A numpy leaf in its own dtype, through float32, which holds every
    bfloat16 value exactly."""
    dtype = DTYPES[np.asarray(a).dtype.name]
    return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                          dtype=dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_reference(tree, cfg, device="cuda"):
    """Rebuild a reference LM parameter tree (the output of
    ``repro.models.api.build_model(cfg).init_params``) as the port's
    model for ``cfg.family`` on ``device``: a ``Transformer`` (dense, moe,
    vlm), a ``Mamba2LM`` (ssm), a ``Hybrid`` or an ``EncDec`` (audio).
    The leading-L layer stacks (``layers``, the MoE subtree and its shared
    expert among them; whisper's ``enc_layers`` over its encoder's depth
    and ``dec_layers`` over ``n_layers``) are unstacked into one block
    each; every other leaf (the hybrid's ``shared`` subtree, whisper's
    positions and final norms) crosses as it is. Every leaf keeps the
    reference leaf's dtype, so a MoE router or an SSM's ``A_log`` stays
    float32 in a bfloat16 model."""
    depth = ({"enc_layers": cfg.encdec.n_enc_layers,
              "dec_layers": cfg.n_layers} if cfg.family == "audio"
             else {"layers": cfg.n_layers})
    out = {k: _map(v, lambda a: _tensor(a, device))
           for k, v in tree.items() if k not in depth}
    for key, n in depth.items():
        out[key] = [_map(tree[key], lambda a, i=i: _tensor(a[i], device))
                    for i in range(n)]
    model = {"ssm": Mamba2LM, "hybrid": Hybrid,
             "audio": EncDec}.get(cfg.family, Transformer)
    return model(cfg, out)
