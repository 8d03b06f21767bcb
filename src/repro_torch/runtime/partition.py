"""Partitioning rules: DP / TP / EP / SP sharding specs for parameters,
optimizer state, activations and caches (counterpart of
``repro.runtime.partition``), and their placement on a torch
``DeviceMesh``.

Mesh axes (``launch/mesh.py``):
    single-pod:  ("data", "model")            = (16, 16)
    multi-pod:   ("pod", "data", "model")     = (2, 16, 16)

Default layout (Megatron-style TP over 'model', DP over 'pod'+'data'):
  * attention/MLP in-projections: output dim over 'model'
  * out-projections: input dim over 'model'
  * embeddings / lm head: vocab over 'model'
  * MoE expert stacks: expert dim over 'model' (EP)
  * activations: batch over ('pod','data'); heads / ff over 'model'
  * KV caches: batch over ('pod','data'), kv heads over 'model'
  * optimizer moments: parameter spec + ZeRO-1 extra sharding of the
    leading (layer-stack) axis over 'data' where divisible.

The spec arithmetic (``filter_spec`` .. ``zero1_specs``) is the
reference's line by line, on any tree of leaves with ``.shape`` and
``.ndim`` (torch tensors, ``meta`` tensors, JAX shape structs), with the
port's own :class:`P` in place of ``jax.sharding.PartitionSpec``.
``fix_spec`` repairs against the *production* ``MESH_SIZES``, not the
mesh at hand, as in the reference.

New here: :func:`placements` maps a spec onto DTensor placements of a
mesh, and :func:`place_model` puts a port model's parameters (one module
per layer) onto a mesh as DTensors, each with its reference leaf's spec
less the leading stack entry. :func:`use_mesh` is the counterpart of
``with mesh:``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, List, Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``, a mesh
    axis name or a tuple of names (the counterpart of
    ``jax.sharding.PartitionSpec``, which also holds a one-name tuple as
    the bare name)."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# axis aliases
BATCH_AXES = ("pod", "data")
MODEL = "model"

_state = threading.local()


def current_mesh() -> Optional[DeviceMesh]:
    """The mesh of the innermost :func:`use_mesh`, None outside one."""
    stack = getattr(_state, "meshes", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_mesh(mesh: Optional[DeviceMesh]) -> Iterator[Optional[DeviceMesh]]:
    """Make ``mesh`` the ambient mesh (``with mesh:`` in the reference);
    None leaves the code outside any mesh."""
    if not hasattr(_state, "meshes"):
        _state.meshes = []
    _state.meshes.append(mesh)
    try:
        yield mesh
    finally:
        _state.meshes.pop()


def filter_spec(spec: P, names: tuple) -> P:
    """Drop axis names not present in ``names`` (lets the same spec serve
    1-device CPU, single-pod and multi-pod meshes)."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            keep = tuple(a for a in entry if a in names)
            out.append(keep if keep else None)
        else:
            out.append(entry if entry in names else None)
    return P(*out)


def axis_size(name: str) -> int:
    """Size of a mesh axis in the ambient mesh (1 if absent)."""
    m = current_mesh()
    if m is None:
        return 1
    return dict(zip(m.mesh_dim_names, m.shape)).get(name, 1)


def placements(spec: P, mesh: DeviceMesh) -> List:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where the spec names that mesh axis at tensor dim ``d``,
    ``Replicate()`` otherwise, and on an axis of one rank (whose one
    shard is the whole tensor, so no use of it gathers). A tuple entry
    shards one tensor dim over several mesh dims, which must then come in
    the mesh's order. Axes the mesh lacks are dropped first
    (:func:`filter_spec`)."""
    names = tuple(mesh.mesh_dim_names)
    spec = filter_spec(spec, names)
    out: List = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"placements: {entry} shards dim {dim} over "
                             f"mesh axes out of the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"placements: mesh axis {names[i]!r} "
                                 f"named twice in {spec}")
            if mesh.size(i) > 1:
                out[i] = Shard(dim)
    return out


def shard(x: torch.Tensor, spec: P) -> torch.Tensor:
    """Redistribute a DTensor to ``spec`` on the ambient mesh (the
    counterpart of ``with_sharding_constraint``); a no-op outside a mesh
    and for a plain tensor."""
    m = current_mesh()
    if m is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(m, placements(spec, m))


# ---------------------------------------------------------------------------
# parameter partitioning rules (by param-tree path name conventions)
# ---------------------------------------------------------------------------

_RULES = (
    # (name match, spec for the trailing dims — leading stack axis prepended)
    ("wq", P(None, MODEL)),
    ("wk", P(None, MODEL)),
    ("wv", P(None, MODEL)),
    ("wo", P(MODEL, None)),
    ("wg", P(None, MODEL)),
    ("wu", P(None, MODEL)),
    ("wd", P(MODEL, None)),
    ("bq", P(MODEL)),
    ("bk", P(MODEL)),
    ("bv", P(MODEL)),
    ("w_experts_up", P(MODEL, None, None)),      # (E, D, F): EP over experts
    ("w_experts_gate", P(MODEL, None, None)),
    ("w_experts_down", P(MODEL, None, None)),
    ("router", P(None, MODEL)),
    ("embed", P(MODEL, None)),                   # (V, D): vocab-sharded
    ("lm_head", P(None, MODEL)),                 # (D, V)
    ("in_proj", P(None, MODEL)),                 # mamba projections
    ("out_proj", P(MODEL, None)),
    ("conv_w", P(None, MODEL)),                  # (ksize, channels)
    ("pos_embed", P(None, None)),
)


# production mesh axis sizes (dryrun/train target); specs are validated
# against these sizes + the leaf shape and repaired when needed.
MESH_SIZES = {"pod": 2, "data": 16, "model": 16}


def _entry_size(entry, sizes) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(entry, 1)


def fix_spec(spec: P, shape, sizes=None) -> P:
    """Drop spec entries whose mesh extent doesn't divide the dim; if the
    'model' axis was dropped, re-place it on the largest divisible free dim
    (e.g. granite's 40-expert stack moves EP's 'model' onto the FF dim)."""
    sizes = sizes or MESH_SIZES
    entries = list(spec) + [None] * (len(shape) - len(spec))
    entries = entries[:len(shape)]
    dropped_model = False
    for i, e in enumerate(entries):
        if e is None:
            continue
        if shape[i] % _entry_size(e, sizes) != 0:
            has_model = e == MODEL or (isinstance(e, (tuple, list))
                                       and MODEL in e)
            dropped_model = dropped_model or has_model
            entries[i] = None
    flat = [a for e in entries if e is not None
            for a in (e if isinstance(e, (tuple, list)) else (e,))]
    if dropped_model and MODEL not in flat:
        cands = sorted((i for i, e in enumerate(entries)
                        if e is None and shape[i] % sizes[MODEL] == 0),
                       key=lambda i: -shape[i])
        if cands:
            entries[cands[0]] = MODEL
    return P(*entries)


def spec_for(path: str, ndim: int, stacked: bool,
             shape=None) -> P:
    """Sharding spec for a parameter given its tree path (+shape repair)."""
    leaf = path.split("/")[-1]
    spec = P(*([None] * ndim))
    for name, rule in _RULES:
        if leaf == name or leaf.startswith(name):
            entries = list(rule)
            # pad/truncate to the param rank (minus stack axis)
            want = ndim - (1 if stacked else 0)
            while len(entries) < want:
                entries.append(None)
            entries = entries[:want]
            if stacked:
                entries = [None] + entries
            spec = P(*entries)
            break
    if shape is not None:
        spec = fix_spec(spec, shape)
    return spec


def tree_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Flatten a params dict-tree into path->leaf."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(tree_paths(v, f"{prefix}/{k}" if prefix else k))
    else:
        out[prefix] = tree
    return out


def param_specs(params: Any, stacked_prefixes: tuple = ("layers",)) -> Any:
    """PartitionSpec tree matching ``params``'s structure."""
    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        stacked = any(prefix.startswith(sp) or f"/{sp}" in f"/{prefix}"
                      for sp in stacked_prefixes)
        return spec_for(prefix, tree.ndim, stacked, tuple(tree.shape))
    return walk(params)


def _tree_map(fn, tree: Any) -> Any:
    """``fn`` on every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def batch_specs(batch_tree: Any, global_batch: int) -> Any:
    """Shardings for input batches: batch dim over ('pod','data')."""
    baxes = BATCH_AXES if global_batch > 1 else None

    def spec(x):
        entries = [baxes] + [None] * (x.ndim - 1)
        return P(*entries)
    return _tree_map(spec, batch_tree)


def kv_cache_spec(cfg, long_seq: bool) -> P:
    """A (L_or_sites, B, S, n_kv, hd) cache's spec: kv heads over 'model'
    when they divide, else head_dim over 'model' (row-parallel
    attention); single-request long-context decode (``long_seq``) shards
    the KV sequence over 'data' instead of the batch."""
    b = None if long_seq else BATCH_AXES
    seq = "data" if long_seq else None
    if cfg.n_kv_heads % MESH_SIZES[MODEL] == 0:
        return P(None, b, seq, MODEL, None)
    return P(None, b, seq, None, MODEL)


def ssm_state_specs(long_seq: bool) -> tuple:
    """The stacked conv state (L, B, K-1, convd) and SSM state (L, B, H,
    P, N) specs. Long-context single-request decode additionally shards
    the SSM state's head-channel dim over 'data' (with batch=1 the data
    axis is otherwise idle and every data row replicates the whole
    recurrence)."""
    b = None if long_seq else BATCH_AXES
    return (P(None, b, None, MODEL),
            P(None, b, MODEL, "data", None) if long_seq
            else P(None, b, MODEL, None, None))


def decode_state_specs(cfg, shape, state_tree: Any) -> Any:
    """Sharding specs for decode state (KV caches / SSM states).

    Long-context single-request decode (global_batch == 1) shards the KV
    *sequence* over 'data' (sequence parallelism); otherwise batch goes
    over ('pod','data') and kv-heads/channels over 'model'.
    """
    fam = cfg.family
    long_seq = shape.global_batch == 1
    b = None if long_seq else BATCH_AXES

    def spec_leaf(x):
        nd = x.ndim
        if nd == 5 and fam in ("dense", "moe", "vlm", "audio", "hybrid"):
            return kv_cache_spec(cfg, long_seq)
        if fam in ("ssm", "hybrid"):
            if nd == 4:            # conv state (L, B, K-1, convd)
                return P(None, b, None, MODEL)
            if nd == 5:            # ssm state (L, B, H, P, N)
                return P(None, b, MODEL, None, None)
        if nd == 3:                # enc_out (B, T, D)
            return P(b, None, None)
        return P(*([None] * nd))

    def walk(t):
        if isinstance(t, tuple):
            return tuple(walk(v) for v in t)
        if isinstance(t, list):
            return [walk(v) for v in t]
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return spec_leaf(t)

    # ssm states distinguish conv (nd=4) vs ssm (nd=5) — fix family quirk.
    if fam == "ssm":
        return ssm_state_specs(long_seq)
    if fam == "hybrid":
        return (ssm_state_specs(long_seq),
                (kv_cache_spec(cfg, long_seq),) * 2)
    return walk(state_tree)


def zero1_specs(params: Any, data_axis: str = "data",
                stacked_prefixes: tuple = ("layers",)) -> Any:
    """Optimizer-moment specs (ZeRO-1): the parameter spec plus an extra
    sharding of some free, evenly-divisible dim over the data axis —
    preferring the leading (layer-stack) axis, falling back to any other
    dim. Tensors with no divisible free dim stay at the parameter spec
    (only small norms/scalars in practice)."""
    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        stacked = any(prefix.startswith(sp) or f"/{sp}" in f"/{prefix}"
                      for sp in stacked_prefixes)
        shape = tuple(tree.shape)
        base = spec_for(prefix, tree.ndim, stacked, shape)
        entries = list(base) + [None] * (tree.ndim - len(base))
        dsize = MESH_SIZES[data_axis]
        # candidate dims: prefer dim 0, then largest
        order = [0] + sorted(range(1, tree.ndim), key=lambda i: -shape[i])
        for i in order:
            if i < len(entries) and entries[i] is None \
                    and shape[i] % dsize == 0:
                entries[i] = data_axis
                break
        return P(*entries)
    return walk(params)


# ---------------------------------------------------------------------------
# a port model's parameters onto a mesh
# ---------------------------------------------------------------------------

# the reference's leading-L layer stacks
STACKED = ("layers", "enc_layers", "dec_layers")


def model_specs(model: nn.Module) -> Dict[str, P]:
    """Each parameter of a port model (named ``layers.3.attn.wq``) with
    the spec of its reference leaf (``layers/attn/wq``, stacked over the
    layers), the leading stack entry dropped for a per-layer tensor."""
    from repro_torch.convert import _path
    named = [(name, t, *_path(name)) for name, t in model.named_parameters()]
    depth: Dict[str, int] = {}
    for _, _, path, layer in named:
        depth[path[0]] = max(depth.get(path[0], 0), layer + 1)
    out = {}
    for name, t, path, layer in named:
        if layer >= 0:
            spec = spec_for("/".join(path), t.dim() + 1, True,
                            (depth[path[0]],) + tuple(t.shape))
            if spec[0] is not None:
                raise ValueError(f"{name}: its reference spec {spec} shards "
                                 f"the layer stack, which one module per "
                                 f"layer cannot hold")
            out[name] = P(*spec[1:])
        else:
            out[name] = spec_for("/".join(path), t.dim(), False,
                                 tuple(t.shape))
    return out


def place_model(model: nn.Module, cfg, mesh: DeviceMesh) -> nn.Module:
    """Every parameter of ``model`` (built for ``cfg``) as a DTensor on
    ``mesh`` with :func:`model_specs`' spec, its values from rank 0
    (``distribute_tensor``); the same module tree, changed in place."""
    if model.cfg != cfg:
        raise ValueError(f"place_model: the model was built for "
                         f"{model.cfg.arch_id}, not this config")
    specs = model_specs(model)
    for prefix, mod in model.named_modules():
        for key, p in list(mod._parameters.items()):
            if p is None or isinstance(p, DTensor):
                continue
            name = f"{prefix}.{key}" if prefix else key
            dt = distribute_tensor(p.detach().to(mesh.device_type), mesh,
                                   placements(specs[name], mesh))
            mod._parameters[key] = nn.Parameter(dt, p.requires_grad)
    return model
