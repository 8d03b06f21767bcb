"""The comparison that decides ``correct``: the numbers compared, each
against its limit in ``limits/<cell>.json``.

Training (the first ``checked_steps`` steps of the one training object
the window then drives, against the reference from the same weights and
batches):

* ``loss_err``: the largest gap of a step's loss, as a share of the
  reference's;
* ``grad_gap``: the first step's clipped gradient as AdamW receives it
  (its first moment over 1 - b1), by the worst leaf: the gap between the
  two norms of a leaf, over the larger of the reference's norm of that
  leaf and of the median leaf;
* ``update_gap``: each leaf's change after the last checked step, by
  the same measure, over the leaves whose reference gradient is at least
  a thousandth of the median leaf's.

Prefill (the sampled batches the window served, against the reference on
the same prompts):

* ``logits_err`` / ``logits_err_median``: the largest / the median
  relative (2-norm) error of a request's last-position logits over the
  real vocabulary;
* ``kv_err`` / ``kv_err_median``: over the layers, the largest / the
  median of a layer's worst relative error of a sampled request's K or
  V cache.

A cell's ``limits/<cell>.json`` names the numbers it compares.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

GRAD_FLOOR = 1e-3        # leaves under this share of the median gradient


def rel_gap(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor)


def train_gaps(prog: Dict, ref: Dict) -> Dict:
    """Each step's loss gap, each leaf's gradient gap, and the update gap
    of each leaf whose reference gradient is at least ``GRAD_FLOOR`` of
    the median leaf's, with that median change and the leaves left out."""
    if set(prog["grad_norms"]) != set(ref["grad_norms"]):
        raise ValueError("check: the program's leaves are not the "
                         "reference's")
    rg, rc = ref["grad_norms"], ref["change_norms"]
    med_g = statistics.median(rg.values())
    kept = [n for n, g in rg.items() if g >= GRAD_FLOOR * med_g]
    med_c = statistics.median(rc[n] for n in kept)
    return {"loss": [abs(a - b) / abs(b) for a, b in
                     zip(prog["losses"], ref["losses"], strict=True)],
            "grad": {n: rel_gap(prog["grad_norms"][n], g, med_g)
                     for n, g in rg.items()},
            "update": {n: rel_gap(prog["change_norms"][n], rc[n], med_c)
                       for n in kept},
            "median_change": med_c, "left_out": len(rg) - len(kept)}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    g = train_gaps(prog, ref)
    return {"loss_err": max(g["loss"]), "grad_gap": max(g["grad"].values()),
            "update_gap": max(g["update"].values())}


def train_detail(prog: Dict, ref: Dict) -> Dict:
    """What lies behind the training numbers: each step's loss gap, the
    leaves that give the worst gradient and update gaps, and the median
    leaf's gaps."""
    g = train_gaps(prog, ref)
    rg, rc = ref["grad_norms"], ref["change_norms"]
    grad, upd = g["grad"], g["update"]
    wg, wu = max(grad, key=grad.get), max(upd, key=upd.get)
    return {"loss_err_by_step": g["loss"], "losses": ref["losses"],
            "grad_worst": [wg, grad[wg], prog["grad_norms"][wg], rg[wg]],
            "update_worst": [wu, upd[wu], prog["change_norms"][wu], rc[wu],
                             rg[wu]],
            "grad_gap_median": statistics.median(grad.values()),
            "update_gap_median": statistics.median(upd.values()),
            "left_out": g["left_out"], "median_change": g["median_change"]}


class PrefillTally:
    """The prefill numbers, gathered batch by batch and layer by layer as
    the reference runs, so no reference output is kept."""

    def __init__(self):
        self.request_errs: List[float] = []
        self.kv_by_layer: Dict[int, float] = {}

    def logits(self, prog: torch.Tensor, ref: torch.Tensor,
               vocab: int) -> None:
        """prog, ref (B, vocab_padded): each request's relative error over
        the real vocabulary."""
        p, r = prog[:, :vocab].float(), ref[:, :vocab].float()
        err = torch.linalg.vector_norm(p - r, dim=-1) \
            / torch.linalg.vector_norm(r, dim=-1)
        self.request_errs += err.tolist()

    def cache(self, layer: int, prog: torch.Tensor,
              ref: torch.Tensor) -> None:
        """Layer ``layer``'s K or V cache of the sampled rows, (rows, S,
        n_kv, hd): the worst row's relative error."""
        p, r = prog.float().flatten(1), ref.float().flatten(1)
        err = float((torch.linalg.vector_norm(p - r, dim=-1)
                     / torch.linalg.vector_norm(r, dim=-1)).max())
        self.kv_by_layer[layer] = max(self.kv_by_layer.get(layer, 0.0), err)

    @property
    def n(self) -> Dict[str, float]:
        reqs, layers = self.request_errs, list(self.kv_by_layer.values())
        if not reqs or not layers or not all(
                math.isfinite(x) for x in reqs + layers):
            return dict.fromkeys(("logits_err", "logits_err_median",
                                  "kv_err", "kv_err_median"), math.inf)
        return {"logits_err": max(reqs),
                "logits_err_median": statistics.median(reqs),
                "kv_err": max(layers),
                "kv_err_median": statistics.median(layers)}


def decide(numbers: Dict[str, float], limits: Dict
           ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``correct`` and each number beside its limit. A number that is
    missing or not finite fails."""
    checks, correct = {}, True
    for name, lim in limits["limits"].items():
        value = float(numbers.get(name, math.nan))
        checks[name] = {"value": value, "limit": lim["limit"]}
        correct = correct and math.isfinite(value) and value <= lim["limit"]
    return correct, checks
