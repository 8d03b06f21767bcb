"""Deterministic synthetic token pipeline (host-sharded, restart-safe).

Every (step, host) pair maps to a unique counter-based RNG stream, so:
  * restarts resume mid-epoch exactly (the checkpoint stores only `step`);
  * elastic re-meshing re-partitions deterministically (host h of H hosts
    always draws the same global batch rows h::H);
  * straggler back-up workers can recompute any row independently.

The stream is a Zipf-ish token distribution with induced bigram structure
(so models actually learn during the example runs rather than staying at
uniform entropy).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataCfg:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class TokenPipeline:
    def __init__(self, cfg: DataCfg, host_id: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        if cfg.global_batch % n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.local_batch = cfg.global_batch // n_hosts
        # stationary unigram distribution (Zipf over a permuted vocab)
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()
        self._perm = rng.permutation(cfg.vocab)

    def _row(self, step: int, row: int) -> np.ndarray:
        """One deterministic (seq_len+1)-token row."""
        rng = np.random.default_rng(
            (self.cfg.seed, step, row))
        toks = rng.choice(self.cfg.vocab, size=self.cfg.seq_len + 1,
                          p=self._probs)
        # bigram structure: with p=.5 the next token is a function of the
        # previous one (learnable signal)
        follow = rng.random(self.cfg.seq_len + 1) < 0.5
        shifted = (toks * 31 + 7) % self.cfg.vocab
        toks = np.where(follow, np.roll(shifted, 1), toks)
        return self._perm[toks].astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rows = [self._row(step, self.host_id + self.n_hosts * i)
                for i in range(self.local_batch)]
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "targets": arr[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def stub_frames(batch: int, t: int, d: int, step: int = 0,
                dtype=np.float32) -> np.ndarray:
    """Deterministic stand-in for the audio conv frontend / ViT patches."""
    rng = np.random.default_rng((1234, step))
    return rng.standard_normal((batch, t, d)).astype(dtype) * 0.02
