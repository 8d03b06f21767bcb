"""Random weights in the reference's tree layout (layers stacked on a
leading L axis), made on the device from the seed: one generator call per
stacked leaf, in the dtype the leaf is served in. The port receives the
tree through ``repro_torch.convert.lm_params_from_reference``, the
reference the same tree; either can make any one leaf again alone."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.seeds import sub_seed
from portbench.spec import ModelSpec

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_specs(spec: ModelSpec) -> Dict[str, Tuple[tuple, float, str]]:
    """Every leaf's path (``/``-joined), shape, init scale (0 for a norm's
    ones) and dtype name, in the init distributions of the reference."""
    L, D, F = spec.n_layers, spec.d_model, spec.d_ff
    hq, hkv = spec.n_heads * spec.head_dim, spec.n_kv_heads * spec.head_dim
    Vp, dt = spec.vocab_padded, spec.dtype
    dense = lambda a, b: (2.0 / (a + b)) ** 0.5          # noqa: E731
    out = {"embed": ((Vp, D), 0.02, dt), "final_norm": ((D,), 0.0, dt),
           "layers/ln1": ((L, D), 0.0, dt), "layers/ln2": ((L, D), 0.0, dt),
           "layers/attn/wq": ((L, D, hq), dense(D, hq), dt),
           "layers/attn/wk": ((L, D, hkv), dense(D, hkv), dt),
           "layers/attn/wv": ((L, D, hkv), dense(D, hkv), dt),
           "layers/attn/wo": ((L, hq, D), dense(hq, D), dt)}
    if spec.moe is None:
        out.update({"layers/mlp/wg": ((L, D, F), dense(D, F), dt),
                    "layers/mlp/wu": ((L, D, F), dense(D, F), dt),
                    "layers/mlp/wd": ((L, F, D), dense(F, D), dt)})
    else:
        E = spec.moe.n_experts
        out.update({
            "layers/moe/router": ((L, D, E), 0.02, "float32"),
            "layers/moe/w_experts_gate": ((L, E, D, F), dense(D, F), dt),
            "layers/moe/w_experts_up": ((L, E, D, F), dense(D, F), dt),
            "layers/moe/w_experts_down": ((L, E, F, D), dense(D, F), dt)})
    if not spec.tie_embeddings:
        out["lm_head"] = ((D, Vp), dense(D, Vp), dt)
    return out


def make_leaf(spec: ModelSpec, seed: int, path: str,
              device) -> torch.Tensor:
    shape, std, dt = leaf_specs(spec)[path]
    dtype = DTYPES[dt]
    if std == 0.0:
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "weights",
                                                       path))
    x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return x.mul_(std)


def make_tree(spec: ModelSpec, seed: int, device) -> Dict:
    """The whole tree, nested as the reference's parameter dict."""
    tree: Dict = {}
    for path in leaf_specs(spec):
        node = tree
        *parents, name = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = make_leaf(spec, seed, path, device)
    return tree


def layer_leaves(spec: ModelSpec) -> List[Tuple[str, str, int]]:
    """(name, tree path, layer) of every per-layer leaf and (name, path,
    -1) of the others, with names as ``layers.<i>.attn.wq``: the names
    the port's modules and the reference's trainer both give them."""
    out = []
    for path in leaf_specs(spec):
        parts = path.split("/")
        if parts[0] == "layers":
            out += [(".".join(["layers", str(i), *parts[1:]]), path, i)
                    for i in range(spec.n_layers)]
        else:
            out.append((".".join(parts), path, -1))
    return out
