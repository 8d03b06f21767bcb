"""Mixture-of-Experts layer with capacity-based sort dispatch (counterpart
of ``repro.models.moe``).

Top-k routing -> sort by expert -> capacity-bounded dispatch into an
``(E, C, D)`` tensor -> stacked-expert products -> weighted combine, with
the reference's load-balancing aux loss (Shazeer et al.). Pairs past an
expert's capacity are dropped. Where none can be (``dropless``: a
capacity of at least the call's N tokens, as an expert takes at most one
pair a token), the one-device global path runs the routed pairs alone:
sorted by expert, gathered once into ``(N k, D)`` rows, the three
products grouped over each expert's run of rows (``torch._grouped_mm``
with the run ends left on the device; on the card it takes bfloat16),
and the rows put back in the ``(N, k)`` layout for the same combine. No
slot is padded and no buffer of ``(E, C + 1, D)`` is made; the result is
the capacity path's at ``C >= N`` up to the products' summation order.
Both row moves gather in the forward and in the backward, so the
gradient of a token's input sums its ``k`` rows in their ``(N, k)``
order, as the capacity path's does. The numerics follow the reference
line by line:

  * the router is a float32 leaf even in a bfloat16 model, and the logits,
    softmax and aux loss are float32 (TF32 stays off, PyTorch's default);
  * top-k as ``lax.top_k``: descending, ties to the lower expert index (a
    stable descending sort; ``torch.topk`` promises no tie order);
  * ``C = max(int(capacity_factor * N * k / E), 1)`` for the ``N`` tokens
    of *this call*, so the output depends on the batch: a MoE model's
    decode does not equal its full forward;
  * the expert products run in ``x``'s dtype, ``silu`` in float32 rounded
    back before the up product, as in ``layers.mlp``;
  * the combine rounds the gate weights to ``x``'s dtype before the
    product and adds each token's contributions left to right in ``x``'s
    dtype in ascending expert order: the order of the reference's
    scatter-add over expert-sorted updates;
  * the shared expert is ``layers.mlp`` with ``MlpCfg(D, d_ff)`` (SwiGLU,
    whatever the config's activation) on the same normed input.

Two deliberate differences, neither visible in the result: dropped pairs
go to a spare slot ``C`` of an ``(E, C + 1, D)`` buffer that is cut away
(the reference adds zeros at slot 0, which a non-accumulating write would
turn into an overwrite of the kept token), and the combine adds in a
``(N, k)`` layout without atomics, so two runs on the card give the same
bits. Nothing here reads a value back to the host, unless ``obs``
records: then each call of the global path counts its routed pairs
(``moe.routed_pairs``), the pairs it dropped (``moe.dropped_pairs``) and
the busiest expert's pairs over the mean (the gauge
``moe.expert_load_max_over_mean``). Its three stages are the spans
``moe.route`` (router, top-k, aux loss, slot plan and dispatch),
``moe.experts`` (the three products and SiLU) and ``moe.combine`` (the
rows put back and combined), in ``obs.ranges``.

``impl``: without a mesh, or with a 'model' axis of one, both "gspmd" and
"shard_map" run the global path, as in the reference. On a mesh the
global path keeps the global batch's semantics while each rank holds its
rows: the capacity counts every rank's tokens, a pair's slot counts the
pairs of the rows before it on other ranks, and the aux loss takes the
global means; every 'model' rank computes it whole. "shard_map" on a
'model' axis larger than one is expert parallel (the reference's
``_moe_shard_map``): each 'model' rank routes its batch rows in float32,
dispatches them into its ``E_loc = ceil(E / msize)`` experts of the
zero-padded ``E_pad`` with this rank's capacity, runs the three products,
combines its rows in ascending expert order, and one all-reduce over
'model' adds the ranks' rows; the aux loss is this rank's, averaged over
the batch axes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import MoESpec
from repro_torch.models import layers as L
from repro_torch.obs import ranges
from repro_torch.runtime import tp
from repro_torch.runtime.partition import current_mesh

F32 = torch.float32
IMPLS = ("gspmd", "shard_map")


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, spec: MoESpec,
             dtype: torch.dtype = torch.bfloat16) -> Dict:
    E = spec.n_experts
    scale = (2.0 / (d_model + d_ff)) ** 0.5
    p = {"router": L._normal(gen, (d_model, E), 0.02, F32),
         "w_experts_gate": L._normal(gen, (E, d_model, d_ff), scale, dtype),
         "w_experts_up": L._normal(gen, (E, d_model, d_ff), scale, dtype),
         "w_experts_down": L._normal(gen, (E, d_ff, d_model), scale, dtype)}
    if spec.shared_expert:
        p["shared"] = L.mlp_init(gen, L.MlpCfg(d_model, d_ff), dtype)
    return p


def capacity(spec: MoESpec, n_tokens: int) -> int:
    """Slots per expert, in Python floats in the reference's order."""
    return max(int(spec.capacity_factor * n_tokens * spec.top_k
                   / spec.n_experts), 1)


def route(p: Dict, spec: MoESpec, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (..., D) -> probs (N, E) float32, gate_vals (N, k) float32
    renormalised, gate_idx (N, k) int64, best first."""
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xf.to(F32) @ p["router"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :spec.top_k], idx[:, :spec.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, gate_idx


def expert_counts(gate_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """How many routed pairs each expert has, int64 (E,)."""
    flat_e = gate_idx.reshape(-1)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=flat_e.device)
    return counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))


def dispatch_slots(gate_idx: torch.Tensor, n_experts: int, cap: int,
                   before: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each routed pair's slot in its expert, in ``gate_idx``'s (N, k)
    layout: its position in the expert's run after a stable sort by expert
    (so by token within an expert), plus ``before[e]`` pairs of earlier
    rows held elsewhere, or ``cap`` where that position is past the
    capacity. Returns (slot, keep)."""
    flat_e = gate_idx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    counts = expert_counts(gate_idx, n_experts)
    starts = torch.cumsum(counts, 0) - counts
    if before is not None:
        starts = starts - before
    pos_sorted = torch.arange(flat_e.numel(), device=flat_e.device) \
        - starts[se]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = (pos < cap).view(gate_idx.shape)
    slot = torch.where(keep, pos.view(gate_idx.shape), cap)
    return slot, keep


def combine(rows: torch.Tensor, gate_vals: torch.Tensor,
            gate_idx: torch.Tensor) -> torch.Tensor:
    """rows (N, k, D) expert outputs (zero for dropped pairs) -> (N, D):
    each row times its gate weight rounded to the rows' dtype, summed left
    to right in the rows' dtype in ascending expert order."""
    contrib = rows * gate_vals.to(rows.dtype)[..., None]
    asc = torch.argsort(gate_idx, dim=1)   # a token's experts are distinct
    contrib = torch.gather(contrib, 1, asc[..., None].expand_as(contrib))
    out = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        out = out + contrib[:, j]
    return out


def _pairs_before(gate_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Per expert, the pairs routed by the rows the ranks before this one
    along the batch axes hold (zeros on the first)."""
    counts = tp.all_gather_batch(expert_counts(gate_idx, n_experts))
    idx, _ = tp.batch_split()
    return sum(counts[:idx], torch.zeros_like(counts[0]))


def dropless(spec: MoESpec, n_tokens: int) -> bool:
    """Whether no pair of ``n_tokens`` tokens can be dropped: a token's k
    experts are distinct, so no expert gets more than ``n_tokens`` pairs."""
    return capacity(spec, n_tokens) >= n_tokens


def sort_pairs(gate_idx: torch.Tensor, n_experts: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The routed pairs sorted by expert, in token order within an expert:
    ``order`` (the sorted pairs' flat (N, k) indices), ``inverse`` (each
    pair's place in that order) and each expert's run end as int32
    offsets, all on the device."""
    flat_e = gate_idx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    inverse = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    ends = torch.cumsum(expert_counts(gate_idx, n_experts), 0)
    return order, inverse, ends.to(torch.int32)


class _Rows(torch.autograd.Function):
    """``x``'s row ``index // k`` for each entry of ``index``. Its gradient
    is gathered too, by ``inverse`` (``index``'s inverse permutation),
    and each of ``x``'s rows sums its ``k`` copies in their order: no
    scatter and no atomics, so two runs give the same bits."""

    @staticmethod
    def forward(ctx, x, index, inverse, k):
        ctx.save_for_backward(inverse)
        ctx.k = k
        return x.index_select(0, index // k if k > 1 else index)

    @staticmethod
    def backward(ctx, g):
        (inverse,) = ctx.saved_tensors
        g = g.index_select(0, inverse)
        if ctx.k > 1:
            g = g.view(-1, ctx.k, g.shape[-1]).sum(1)
        return g, None, None, None


def swiglu_experts(x: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, w_down: torch.Tensor,
                   matmul) -> torch.Tensor:
    """The experts' SwiGLU by ``matmul`` (``torch.bmm`` over slots, or a
    grouped product over runs of rows): the products in ``x``'s dtype,
    SiLU in float32 rounded back before the up product."""
    h_g = matmul(x, w_gate)
    h_u = matmul(x, w_up)
    h = F.silu(h_g.to(F32)).to(x.dtype) * h_u
    return matmul(h, w_down)


def _count(gate_idx: torch.Tensor, n_experts: int,
           keep: Optional[torch.Tensor]) -> None:
    """The call's ``obs`` counters and load gauge (host reads: only while
    ``obs`` records)."""
    pairs = gate_idx.numel()
    dropped = 0 if keep is None else int((~keep).sum())
    busiest = int(expert_counts(gate_idx, n_experts).max())
    obs.inc("moe.routed_pairs", pairs)
    obs.inc("moe.dropped_pairs", dropped)
    obs.set_gauge("moe.expert_load_max_over_mean",
                  busiest * n_experts / pairs)


def moe_apply(p: Dict, spec: MoESpec, d_ff: int, x: torch.Tensor,
              impl: str = "gspmd") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out in x's dtype, float32 aux loss)."""
    if impl not in IMPLS:
        raise ValueError(f"moe_apply: impl must be one of {IMPLS}, got "
                         f"{impl!r}")
    if impl == "shard_map" and current_mesh() is not None \
            and tp.model_split()[1] > 1:
        return _moe_expert_parallel(p, spec, d_ff, x)
    B, S, D = x.shape
    N = B * S
    E, k = spec.n_experts, spec.top_k
    xf = x.reshape(N, D)
    _, nb = tp.batch_split()
    grouped = nb == 1 and dropless(spec, N)
    with ranges.span("moe.route"):
        probs, gate_vals, gate_idx = route(
            {"router": tp.whole(p["router"])}, spec, x)

        # aux load-balance loss: E * mean(density_e * mean_prob_e), the
        # means over the global batch
        one_hot = F.one_hot(gate_idx, E).sum(1).to(F32)
        if nb == 1:
            density, mean_p = one_hot.mean(0), probs.mean(0)
        else:
            density = tp.reduce_batch(one_hot.sum(0)) / (N * nb)
            mean_p = tp.reduce_batch(probs.sum(0)) / (N * nb)
        aux = spec.aux_coef * E * torch.mean(density * mean_p)

        keep = None
        if grouped:
            # ---- dropless: the pairs' rows, sorted by expert ----
            order, inverse, ends = sort_pairs(gate_idx, E)
            rows_in = _Rows.apply(xf, order, inverse, k)
        else:
            # ---- sort-based capacity dispatch, dropped pairs to spare
            # slot C ----
            C = capacity(spec, N * nb)
            before = _pairs_before(gate_idx, E) if nb > 1 else None
            slot, keep = dispatch_slots(gate_idx, E, C, before)
            dispatch = torch.zeros(E, C + 1, D, dtype=x.dtype,
                                   device=x.device)
            dispatch[gate_idx, slot] = xf[:, None, :].expand(N, k, D)
            rows_in = dispatch[:, :C]
        if obs.enabled():
            _count(gate_idx, E, keep)

    with ranges.span("moe.experts"):
        matmul = (lambda a, w: torch._grouped_mm(a, w, offs=ends)) \
            if grouped else torch.bmm
        eout = swiglu_experts(rows_in, tp.whole(p["w_experts_gate"]),
                              tp.whole(p["w_experts_up"]),
                              tp.whole(p["w_experts_down"]), matmul)

    with ranges.span("moe.combine"):
        if grouped:
            rows = _Rows.apply(eout, inverse, order, 1).view(N, k, D)
        else:   # the spare slot reads zeros
            rows = F.pad(eout, (0, 0, 0, 1))[gate_idx, slot]
        out = combine(rows, gate_vals, gate_idx).view(B, S, D)
    if "shared" in p:
        out = out + L.mlp(p["shared"], L.MlpCfg(D, d_ff), x)
    return out, aux


def _moe_expert_parallel(p: Dict, spec: MoESpec, d_ff: int, x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_shard_map`` on this rank's rows: its
    experts only, the rows summed over 'model'. The router's gradient is
    summed over 'model' (each rank's gate gradient covers its experts), so
    the aux loss, which every 'model' rank computes alike, passes each
    rank an even share of its gradient."""
    r, msize = tp.model_split()
    E, k = spec.n_experts, spec.top_k
    E_loc = -(-E // msize)
    lo = r * E_loc
    B, S, D = x.shape
    N = B * S
    xin = tp.enter_model(x)
    xf = xin.reshape(N, D)
    router = tp.part(p["router"], 1, [(0, E)] * msize)
    probs, gate_vals, gate_idx = route({"router": router}, spec, xin)
    density = F.one_hot(gate_idx, E).sum(1).to(F32).mean(0)
    aux = spec.aux_coef * E * torch.mean(density * probs.mean(0))
    aux = tp.share_grad_over_model(tp.batch_mean(aux))

    C = capacity(spec, N)
    slot, _ = dispatch_slots(gate_idx, E, C)
    # this rank's experts [lo, lo + E_loc) of the padded E_pad; every other
    # pair goes to the spare slot C of local expert 0, which reads zeros
    mine = (gate_idx >= lo) & (gate_idx < lo + E_loc)
    le = torch.where(mine, gate_idx - lo, 0)
    slot = torch.where(mine, slot, C)
    dispatch = torch.zeros(E_loc, C + 1, D, dtype=x.dtype, device=x.device)
    dispatch[le, slot] = xf[:, None, :].expand(N, k, D)
    dispatch = dispatch[:, :C]

    bounds = [(min(j * E_loc, E), min((j + 1) * E_loc, E))
              for j in range(msize)]

    def experts(name: str) -> torch.Tensor:
        w = tp.part(p[name], 0, bounds)     # zero-padded to E_loc experts
        return F.pad(w, (0, 0, 0, 0, 0, E_loc - w.shape[0]))
    eout = swiglu_experts(dispatch, experts("w_experts_gate"),
                          experts("w_experts_up"), experts("w_experts_down"),
                          torch.bmm)
    eout = F.pad(eout, (0, 0, 0, 1))
    out = combine(eout[le, slot], gate_vals, gate_idx)
    out = tp.leave_model(out).view(B, S, D)
    if "shared" in p:
        out = out + L.mlp(p["shared"], L.MlpCfg(D, d_ff), x)
    return out, aux
