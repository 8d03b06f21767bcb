"""Carry DFGs, inputs and LM parameters across from the reference package.

The port's counterpart of loading weights: a reference ``repro.core.dfg.DFG``
(a ``kernels_lib`` kernel, a conformance-corpus case, a traced graph) is
rebuilt as a ``repro_torch.core.dfg.DFG`` by reading its attributes only.
Nothing here imports ``repro``: the reference graph is duck-typed, and each
op is mapped by its enum *name*, so the two packages' enums never mix.

Inputs need no conversion: both packages take numpy int32 streams.

LM parameters arrive as the reference's parameter tree with numpy leaves
(``jax.device_get``; bfloat16 leaves are ``ml_dtypes.bfloat16`` arrays)
or CPU tensors (a checkpoint restored by ``repro_torch.checkpoint``), and
leave as that tree with CPU-tensor leaves (:func:`lm_params_to_reference`,
:func:`opt_state_to_reference`): the layout the reference's training
checkpoints hold, so a checkpoint crosses between the two trainers.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from typing import Dict, List, Sequence, Tuple

from repro_torch.core import dfg as D
from repro_torch.core.isa import AluOp, CmpOp
from repro_torch.models.encdec import EncDec
from repro_torch.models.hybrid import Hybrid
from repro_torch.models.ssm import Mamba2LM
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime.partition import STACKED


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
    bfloat16 value exactly; a tensor leaf copied (never aliased: the
    trainer updates its parameters in place)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
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


def _path(name: str) -> Tuple[Tuple[str, ...], int]:
    """A port parameter name (``layers.3.attn.wq``) as the reference
    tree's key path (``layers/attn/wq``) and its layer, -1 if unstacked."""
    parts = name.split(".")
    if parts[0] in STACKED:
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(parts), -1


def _to_reference(named: Sequence[Tuple[str, torch.Tensor]]) -> Dict:
    """Tensors named as the port's parameters, as the reference's tree on
    the host: each leaf copied to the CPU (a DTensor gathered whole first,
    a collective every rank of its mesh joins), layer leaves stacked there
    along a leading L axis."""
    tree: Dict = {}
    stacks: Dict[Tuple[str, ...], List[Tuple[int, torch.Tensor]]] = {}
    for name, t in named:
        if isinstance(t, DTensor):
            t = t.detach().full_tensor()
        path, layer = _path(name)
        if layer < 0:               # a copy, never an alias of the model
            _set(tree, path, t.detach().to("cpu", copy=True))
        else:
            stacks.setdefault(path, []).append((layer, t.detach().cpu()))
    for path, items in stacks.items():
        layers = [i for i, _ in sorted(items, key=lambda it: it[0])]
        if layers != list(range(len(layers))):
            raise ValueError(f"{'/'.join(path)}: layers {layers}")
        _set(tree, path, torch.stack([t for _, t in sorted(
            items, key=lambda it: it[0])]))
    return tree


def _set(tree: Dict, path: Tuple[str, ...], leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def _from_reference(tree: Dict, name: str):
    path, layer = _path(name)
    for key in path:
        tree = tree[key]
    return tree if layer < 0 else tree[layer]


def lm_params_to_reference(model, cfg) -> Dict:
    """The port's model as the reference's parameter tree (the inverse of
    :func:`lm_params_from_reference`): CPU-tensor leaves in each leaf's
    dtype, the layer stacks (``layers``; whisper's ``enc_layers`` and
    ``dec_layers``) stacked along a leading L axis. Built on the host, one
    leaf at a time, so a save never doubles device memory."""
    if model.cfg != cfg:
        raise ValueError(f"lm_params_to_reference: the model was built for "
                         f"{model.cfg.arch_id}, not this config")
    return _to_reference(list(model.named_parameters()))


def opt_state_to_reference(state: AdamWState, model) -> AdamWState:
    """An ``AdamWState`` over ``model``'s parameter list as the
    reference's: ``mu`` and ``nu`` as parameter trees (float32, stacked,
    on the host), ``count`` an int32 0-d CPU tensor."""
    names = [n for n, _ in model.named_parameters()]
    return AdamWState(_to_reference(list(zip(names, state.mu))),
                      _to_reference(list(zip(names, state.nu))),
                      state.count.detach().cpu())


def opt_state_from_reference(state, model, device="cuda") -> AdamWState:
    """The reference's ``AdamWState`` (a restored tuple ``(mu, nu, count)``
    of parameter trees) as the port's, over ``model``'s parameter list on
    ``device``."""
    mu, nu, count = state
    names = [n for n, _ in model.named_parameters()]
    return AdamWState(
        [_tensor(_from_reference(mu, n), device) for n in names],
        [_tensor(_from_reference(nu, n), device) for n in names],
        _tensor(count, device).to(torch.int32))
