"""The one traffic generator. A mix file (``mixes/<name>.json``) holds
only parameters; every token and every order is drawn here from the run's
seed, so one seed gives the same inputs in every run.

* ``kind: "train"``: ``batch`` rows of ``seq`` tokens a step, uniform over
  the real vocabulary, the targets the tokens shifted by one; step ``i``'s
  rows come from a stream of its own, so the rows of every step differ.
* ``kind: "prefill"``: a closed loop of batches of ``batch`` prompts. The
  prompt lengths come in decks: each deck holds ``lengths[j]`` exactly
  ``deck[j]`` times, shuffled by the seed, so every seed sends the same
  set of sizes in another order and the window closes on a deck's end.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.seeds import sub_seed


def _randint(high: int, shape, seed: int, *keys, device) -> torch.Tensor:
    gen = torch.Generator(device).manual_seed(sub_seed(seed, *keys))
    return torch.randint(0, high, shape, generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32)


def train_batch(mix: Dict, vocab: int, seed: int, step: int,
                device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s tokens and targets, ``(batch, seq)`` int32."""
    rows = _randint(vocab, (mix["batch"], mix["seq"] + 1), seed, "train",
                    step, device=device)
    return {"tokens": rows[:, :-1].contiguous(),
            "targets": rows[:, 1:].contiguous()}


def deck(mix: Dict, seed: int, index: int) -> List[int]:
    """The prompt lengths of deck ``index``, in the seed's order."""
    lengths = [n for n, c in zip(mix["lengths"], mix["deck"])
               for _ in range(c)]
    rng = np.random.default_rng(sub_seed(seed, "deck", index))
    return [lengths[i] for i in rng.permutation(len(lengths))]


def prompts(mix: Dict, vocab: int, seed: int, index: int, length: int,
            device, stream: str = "prompts") -> torch.Tensor:
    """Batch ``index``'s prompts, ``(batch, length)`` int32, uniform over
    the real vocabulary."""
    return _randint(vocab, (mix["batch"], length), seed, stream, index,
                    device=device)
