"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, for
the benchmark's own tests: two layers, d_model 64, 4 heads of 16, 4
experts (top 2) for a MoE configuration, a 250-token vocabulary, and its
traffic shrunk in kind (2 x 16 training rows; batches of 4 prompts of
8-64 tokens). Its multipliers follow the configuration's rules at these
widths."""
from __future__ import annotations

import copy

from portbench import harness


def tiny_cell(name: str, dtype: str = None) -> harness.Cell:
    cell = copy.deepcopy(harness.load_cell(name))
    ar = cell.conf["as_run"]
    moe = ar["moe"]
    ar.update(n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=4 if moe is None else 2, head_dim=16, d_ff=128,
              vocab=250, vocab_padded=256)
    if ar["embedding_multiplier"] != 1.0:      # sqrt(d_model)
        ar["embedding_multiplier"] = 8.0
    if ar["residual_multiplier"] != 1.0:       # scale_depth / sqrt(L)
        ar["residual_multiplier"] = cell.conf["scale_depth"] / 2 ** 0.5
    if moe:
        ar["moe"] = dict(moe, n_experts=4, top_k=2)
    if dtype:
        ar["dtype"] = dtype
    if cell.mix["kind"] == "train":
        cell.mix.update(batch=2, seq=16)
    else:
        cell.mix.update(batch=4, lengths=[8, 16, 32, 64], check_horizon=10)
    return cell
