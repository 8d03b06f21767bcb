"""Prefill traffic: a closed loop of batches of prompts through the port's
``ModelAPI.prefill`` (one full forward that returns the last position's
logits and writes the KV caches); each request's first token is the argmax
of its logits over the real vocabulary, copied to the host.

The batches the check compares are drawn from the seed before the window
(the longest prompt length among them), and what the window served for
them is copied into buffers set aside before the weights are made. They
stay until the peak is read, so ``peak_mem_gib`` is the peak less the
bytes they took: the port's own peak, whatever the seed picked."""
from __future__ import annotations

import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import check, device as D, port, traffic, weights
from portbench.reference import model as ref_model
from portbench.reference.precision import REFERENCE, Precision
from portbench.seeds import sub_seed
from portbench.spec import model_spec
from portbench.trace import STRETCH, from_events


def lengths_upto(mix: Dict, seed: int, n: int) -> List[int]:
    """The prompt lengths of the first ``n`` batches."""
    out: List[int] = []
    d = 0
    while len(out) < n:
        out += traffic.deck(mix, seed, d)
        d += 1
    return out[:n]


def sample(mix: Dict, seed: int) -> Dict[int, List[int]]:
    """The checked batches (by index in the window) and the rows of each
    whose KV caches are compared: among the first ``check_horizon``
    batches, one of the longest prompts and others at random."""
    horizon = mix["check_horizon"]
    lens = lengths_upto(mix, seed, horizon)
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    longest = [i for i, n in enumerate(lens) if n == max(mix["lengths"])]
    first = int(rng.choice(longest))
    rest = [i for i in range(horizon) if i != first]
    picked = [first] + [int(i) for i in rng.choice(
        rest, mix["check_batches"] - 1, replace=False)]
    return {i: sorted(int(r) for r in rng.choice(
        mix["batch"], mix["check_rows"], replace=False)) for i in picked}


class Program:
    """The port's model and its prefill entry point, from the seed."""

    def __init__(self, cell, seed: int, device: torch.device):
        self.mix, self.seed, self.device = cell.mix, seed, device
        self.spec = model_spec(cell.conf)
        cfg = port.config(cell.conf, self.spec)
        tree = weights.make_tree(self.spec, seed, device)
        self.params = port.model(tree, cfg, device)
        del tree
        self.api = port.api(cfg)

    def prefill(self, tokens: torch.Tensor):
        """(logits (B, vocab_padded), caches, host (2, B): each request's
        best logit and first token)."""
        logits, caches = self.api.prefill(self.params, {"tokens": tokens})
        best = logits[:, :self.spec.vocab].max(-1)
        host = torch.stack([best.values.float(), best.indices.float()]).cpu()
        return logits, caches, host


class Kept:
    """Buffers, set aside in set-up, for the checked batches' logits,
    first tokens and the KV caches of their sampled rows. Each is sized
    for the mix's longest prompt whatever the batch's length, so the
    run's memory does not depend on which batches the seed picked."""

    def __init__(self, mix: Dict, spec, seed: int, dev: torch.device,
                 picked: Dict[int, List[int]]):
        s = spec
        lens = lengths_upto(mix, seed, max(picked) + 1)
        longest = max(mix["lengths"])
        self.rows = {i: torch.tensor(r, device=dev) for i, r in picked.items()}
        self.logits = {i: torch.empty(mix["batch"], s.vocab_padded,
                                      dtype=weights.DTYPES[s.dtype],
                                      device=dev) for i in picked}

        def buffer(i):
            shape = (s.n_layers, len(picked[i]), lens[i], s.n_kv_heads,
                     s.head_dim)
            flat = torch.empty(s.n_layers * len(picked[i]) * longest
                               * s.n_kv_heads * s.head_dim,
                               dtype=torch.bfloat16, device=dev)
            return flat[:math.prod(shape)].view(shape)
        self.k = {i: buffer(i) for i in picked}
        self.v = {i: buffer(i) for i in picked}

    def keep(self, i: int, logits, caches) -> None:
        if i not in self.rows:
            return
        self.logits[i].copy_(logits)
        torch.index_select(caches[0], 1, self.rows[i], out=self.k[i])
        torch.index_select(caches[1], 1, self.rows[i], out=self.v[i])


def window(prog: Program, kept: Kept, seconds: float) -> Dict:
    """Whole decks of batches until ``seconds`` have passed and the
    checked batches have run."""
    mix, V = prog.mix, prog.spec.vocab
    B, horizon = mix["batch"], mix["check_horizon"]
    ttft: List[float] = []
    units: List[Dict] = []
    failed, deck = 0, 0
    D.sync(prog.device)
    t0 = time.perf_counter()
    while True:
        for S in traffic.deck(mix, prog.seed, deck):
            i = len(units)
            tokens = traffic.prompts(mix, V, prog.seed, i, S, prog.device)
            t_issue = time.perf_counter()
            logits, caches, host = prog.prefill(tokens)
            ttft += [time.perf_counter() - t_issue] * B
            kept.keep(i, logits, caches)
            failed += int((~host[0].isfinite()).sum())
            units.append({"batch": B, "seq": S})
            del logits, caches
        deck += 1
        if time.perf_counter() - t0 >= seconds and len(units) >= horizon:
            break
    D.sync(prog.device)
    return {"seconds": time.perf_counter() - t0, "ttft": ttft,
            "units": units, "failed": failed, "decks": deck}


def warm_up(prog: Program) -> None:
    """One batch at each prompt length of the mix."""
    for j, S in enumerate(prog.mix["lengths"]):
        tokens = traffic.prompts(prog.mix, prog.spec.vocab, prog.seed, j, S,
                                 prog.device, stream="warmup")
        prog.prefill(tokens)


def profile(prog: Program, first_deck: int):
    """``trace_decks`` decks after the window under the profiler, after
    one batch that takes the profiler's start-up."""
    from torch.profiler import profile as torch_profile, record_function
    mix, V = prog.mix, prog.spec.vocab
    units = []
    with torch_profile(activities=D.profiler_activities(prog.device)) as p:
        tokens = traffic.prompts(mix, V, prog.seed, -1, mix["lengths"][0],
                                 prog.device, stream="trace")
        prog.prefill(tokens)
        D.sync(prog.device)
        with record_function(STRETCH):
            for d in range(first_deck, first_deck + mix["trace_decks"]):
                for j, S in enumerate(traffic.deck(mix, prog.seed, d)):
                    tokens = traffic.prompts(mix, V, prog.seed, 1000 * d + j,
                                             S, prog.device, stream="trace")
                    prog.prefill(tokens)
                    units.append({"batch": mix["batch"], "seq": S})
            D.sync(prog.device)
    return from_events(p.events(), units)


def reference(cell, seed: int, device: torch.device,
              outputs: Dict[int, Tuple], precision: Precision = REFERENCE
              ) -> check.PrefillTally:
    """The reference over each checked batch's prompts, held to
    ``outputs[i] = (logits, rows, k, v)``."""
    spec, mix = model_spec(cell.conf), cell.mix
    tree = weights.make_tree(spec, seed, device)
    lens = lengths_upto(mix, seed, max(outputs) + 1)
    tally = check.PrefillTally()
    for i, (logits, rows, k, v) in sorted(outputs.items()):
        tokens = traffic.prompts(mix, spec.vocab, seed, i, lens[i], device)

        def on_kv(layer, rk, rv, rows=rows, k=k, v=v):
            tally.cache(layer, k[layer], rk[rows])
            tally.cache(layer, v[layer], rv[rows])
        ref = ref_model.prefill(spec, tree, tokens, precision, on_kv)
        tally.logits(logits, ref, spec.vocab)
    return tally


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> Dict:
    D.reset_peak(device)
    before = D.allocated(device)
    kept = Kept(cell.mix, model_spec(cell.conf), seed, device,
                sample(cell.mix, seed))
    kept_bytes = D.allocated(device) - before
    prog = Program(cell, seed, device)
    warm_up(prog)
    D.sync(device)
    setup_s = time.perf_counter() - t_start
    plain = port.plain_attention_calls()
    win = window(prog, kept, seconds)
    peak = D.peak_bytes(device)
    if device.type == "cuda" and port.plain_attention_calls() != plain:
        raise RuntimeError("prefill: a plain attention ran in the window")
    tr = profile(prog, win["decks"]) if trace else None
    outputs = {i: (kept.logits[i], kept.rows[i], kept.k[i], kept.v[i])
               for i in kept.rows}
    del prog
    D.release(device)
    tally = reference(cell, seed, device, outputs)
    tokens = sum(u["batch"] * u["seq"] for u in win["units"])
    from portbench.harness import p95
    return {"e2e": {"prefill_tokens_per_s": tokens / win["seconds"],
                    "ttft_p95_ms": 1e3 * p95(win["ttft"]),
                    "setup_s": setup_s,
                    "peak_mem_gib": (peak - kept_bytes) / 2 ** 30},
            "attempted": len(win["ttft"]), "failed": win["failed"],
            "numbers": tally.n, "trace": tr, "peak_bytes": peak,
            "window": {"seconds": win["seconds"], "units": win["units"]}}
