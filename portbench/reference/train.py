"""The trainer of the configuration, in float32: the mean cross-entropy
over the real vocabulary (padded columns masked) plus the MoE layers' aux
losses, its gradient, clipping to a global norm, and AdamW with the WSD
schedule, the parameters held between steps in their leaf's dtype (the
precision's ``held``). Layers are recomputed in the backward
(activation checkpointing), so the reference fits beside its float32
moments at 4,096 tokens."""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import model as M
from portbench.reference.precision import Precision
from portbench.spec import ModelSpec

F32 = torch.float32


def named_leaves(tree: Dict, spec: ModelSpec) -> Dict[str, torch.Tensor]:
    """Every leaf of the stacked tree by name (``embed``,
    ``layers.<i>.attn.wq``, ...), one per layer for the stacked ones."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, prefix + [key])
            elif prefix and prefix[0] == "layers":
                for i in range(spec.n_layers):
                    out[".".join(["layers", str(i), *prefix[1:], key])] = \
                        val[i]
            else:
                out[".".join(prefix + [key])] = val
    walk(tree, [])
    return out


def _layer(params: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    pre = f"layers.{i}."
    return {n[len(pre):].split(".")[-1]: t for n, t in params.items()
            if n.startswith(pre)}


def loss(spec: ModelSpec, params: Dict[str, torch.Tensor],
         tokens: torch.Tensor, targets: torch.Tensor,
         p: Precision) -> torch.Tensor:
    x = params["embed"][tokens.long()] * M.scalar(spec.embedding_multiplier,
                                                   spec)
    aux = x.new_zeros(())
    for i in range(spec.n_layers):
        w = _layer(params, i)
        keys = sorted(w)

        def run(x, *ws, keys=keys):
            y, _, _, a = M.block(x, dict(zip(keys, ws)), spec, p)
            return y, a
        x, a = checkpoint(run, x, *[w[k] for k in keys], use_reentrant=False)
        aux = aux + a
    x = M.rmsnorm(x, params["final_norm"], spec.rms_norm_eps)
    head = (params["embed"].T if spec.tie_embeddings else params["lm_head"])
    logits = M.mm(x, head, p)
    cols = torch.arange(logits.shape[-1], device=logits.device)
    logits = logits.masked_fill(cols >= spec.vocab, float("-inf"))
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold) + aux


def wsd(step: int, s: Dict) -> float:
    """The WSD learning rate at update ``step`` (1, 2, ...), in float32."""
    t = torch.tensor(float(step), dtype=F32)
    base = s["base_lr"]
    warm = base * t / max(s["warmup"], 1)
    frac = torch.clip((t - s["warmup"] - s["stable"]) / max(s["decay"], 1),
                      0.0, 1.0)
    dec = base * torch.pow(torch.tensor(s["final_frac"], dtype=F32), frac)
    if step < s["warmup"]:
        return warm
    return torch.tensor(base, dtype=F32) if step < s["warmup"] + s["stable"] \
        else dec


def train(spec: ModelSpec, tree: Dict, batches: Sequence[Dict],
          schedule: Dict, optimizer: Dict, p: Precision) -> Dict:
    """Steps on ``batches`` from the weights ``tree``: each step's loss,
    each leaf's clipped gradient norm at the first step, and each leaf's
    change after the last, by name."""
    init = named_leaves(tree, spec)
    dtypes = {n: t.dtype for n, t in init.items()}
    params = {n: t.to(F32).clone().requires_grad_() for n, t in init.items()}
    names = list(params)
    leaves = [params[n] for n in names]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    b1, b2 = optimizer["b1"], optimizer["b2"]
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for step, batch in enumerate(batches, start=1):
        value = loss(spec, params, batch["tokens"], batch["targets"], p)
        grads = torch.autograd.grad(value, leaves)
        losses.append(float(value.detach()))
        with torch.no_grad():
            total = sum(torch.sum(g * g) for g in grads)
            scale = torch.clamp(optimizer["clip"] / (torch.sqrt(total) + 1e-9),
                                max=1.0)
            grads = [g * scale for g in grads]
            if step == 1:
                norms = torch.stack([torch.linalg.vector_norm(g)
                                     for g in grads]).tolist()
                grad_norms = dict(zip(names, norms))
            t = torch.tensor(float(step), dtype=F32)
            b1c, b2c = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
            lr = wsd(step, schedule)
            for n, g, m, v, w in zip(names, grads, mu, nu, leaves):
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                upd = (m / b1c) / (torch.sqrt(v / b2c) + optimizer["eps"]) \
                    + optimizer["weight_decay"] * w
                w.copy_(p.held(w - lr * upd, dtypes[n]))
        del grads
    with torch.no_grad():
        change = torch.stack([torch.linalg.vector_norm(params[n]
                                                       - init[n].to(F32))
                              for n in names]).tolist()
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": dict(zip(names, change))}
