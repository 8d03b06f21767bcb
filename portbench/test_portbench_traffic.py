"""The generator: the same seed gives the same inputs, other seeds give
other inputs, every seed sends the same set of sizes, and the checked
sample holds one of the longest prompts."""
from collections import Counter

import pytest
import torch

from portbench import harness, traffic
from portbench.drivers import prefill as P

SEEDS = [0, 7, 2 ** 31 + 5, 2 ** 70 + 3, -12]
TRAIN = harness.load_json(harness.HERE / "mixes" / "train-4x512.json")
PREFILL = harness.load_json(harness.HERE / "mixes" / "prefill-mix.json")


@pytest.mark.parametrize("seed", SEEDS)
def test_train_batches_repeat_for_a_seed(seed):
    a = traffic.train_batch(TRAIN, 1000, seed, 3, "cpu")
    b = traffic.train_batch(TRAIN, 1000, seed, 3, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (4, 512) and a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 1000


def test_train_batches_differ_across_seeds_and_steps():
    base = traffic.train_batch(TRAIN, 1000, 7, 0, "cpu")["tokens"]
    assert not torch.equal(base, traffic.train_batch(TRAIN, 1000, 8, 0,
                                                     "cpu")["tokens"])
    assert not torch.equal(base, traffic.train_batch(TRAIN, 1000, 7, 1,
                                                     "cpu")["tokens"])
    rows = {tuple(r.tolist()) for r in base}
    assert len(rows) == base.shape[0]


@pytest.mark.parametrize("seed", SEEDS)
def test_every_deck_holds_the_mix_in_its_ratio(seed):
    want = Counter(dict(zip(PREFILL["lengths"], PREFILL["deck"])))
    for d in range(5):
        assert Counter(traffic.deck(PREFILL, seed, d)) == want
    assert traffic.deck(PREFILL, seed, 2) == traffic.deck(PREFILL, seed, 2)


def test_decks_and_prompts_differ_across_seeds():
    orders = {tuple(traffic.deck(PREFILL, s, 0)) for s in range(20)}
    assert len(orders) > 10
    a = traffic.prompts(PREFILL, 5000, 1, 0, 64, "cpu")
    assert a.shape == (8, 64)
    assert torch.equal(a, traffic.prompts(PREFILL, 5000, 1, 0, 64, "cpu"))
    assert not torch.equal(a, traffic.prompts(PREFILL, 5000, 2, 0, 64,
                                              "cpu"))
    assert not torch.equal(a, traffic.prompts(PREFILL, 5000, 1, 0, 64,
                                              "cpu", stream="warmup"))


@pytest.mark.parametrize("seed", SEEDS)
def test_the_sample_holds_a_longest_prompt(seed):
    picked = P.sample(PREFILL, seed)
    lens = P.lengths_upto(PREFILL, seed, PREFILL["check_horizon"])
    assert len(picked) == PREFILL["check_batches"]
    assert max(PREFILL["lengths"]) in [lens[i] for i in picked]
    assert all(i < PREFILL["check_horizon"] for i in picked)
    for rows in picked.values():
        assert len(set(rows)) == PREFILL["check_rows"]
        assert all(0 <= r < PREFILL["batch"] for r in rows)
    assert picked == P.sample(PREFILL, seed)
