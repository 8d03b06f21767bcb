"""The comparison that decides ``correct`` fails what it must: a whole run
of a cell at reduced widths on the CPU (the look for a card skipped), once
sound and once with the timed path broken underneath for each fault the
cell can have, and the control (the reference in float8 e4m3 in the
program's place). The limits are the cells' own."""
import json

import pytest
import torch

from portbench import check, control, port, run
from portbench.tiny import tiny_cell

TRAIN = "minicpm-2b.train-512"
DENSE = "minicpm-2b.prefill-mix"
MOE = "granite-moe-3b-a800m.prefill-mix"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def no_jax_scan(monkeypatch):
    """The whole suite runs in shared worker processes where the JAX
    package's own tests load it; the scan itself is held by
    ``test_portbench_layout.py`` in a process of its own."""
    from portbench import harness
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


def result(name, capsys, seed=987654321012):
    cell = tiny_cell(name)
    rc = run.main(["--workload", name, "--seed", str(seed), "--seconds",
                   "0.3"], device=CPU, cell=cell)
    out = capsys.readouterr()
    assert rc == 0, out.err
    res = json.loads(out.out.strip().splitlines()[-1])
    lines = out.err.strip().splitlines()[-len(res["checks"]):]
    assert lines == [f"check {n}: {c['value']!r} (limit {c['limit']!r})"
                     for n, c in res["checks"].items()]
    assert list(res)[-1] == "checks"
    return res


@pytest.mark.parametrize("name", [TRAIN, DENSE, MOE])
def test_a_sound_run_is_correct(name, capsys):
    res = result(name, capsys)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def test_a_step_that_leaves_the_state_unchanged_fails(capsys, monkeypatch):
    from repro_torch.optim import adamw
    monkeypatch.setattr(adamw.AdamW, "update",
                        lambda self, grads, state, params: (params, state))
    res = result(TRAIN, capsys)
    assert not res["correct"]
    assert res["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_fails(capsys, monkeypatch):
    build = port.api
    monkeypatch.setattr(port, "api",
                        lambda cfg: control.half_batch(build(cfg)))
    assert not result(TRAIN, capsys)["correct"]


def broken_prefill(fault):
    build = port.api

    def api(cfg):
        a = build(cfg)
        prefill = a.prefill

        def wrapped(params, batch):
            tokens = batch["tokens"]
            if fault == "half_batch":
                half = tokens.shape[0] // 2
                logits, caches = prefill(params, {"tokens": tokens[:half]})
                pad = lambda t, d: torch.cat(                  # noqa: E731
                    [t, torch.zeros_like(t)], dim=d)
                return pad(logits, 0), tuple(pad(c, 1) for c in caches)
            # each request handed the next one's answer
            logits, caches = prefill(params, batch)
            return logits.roll(1, dims=0), caches
        a.prefill = wrapped
        return a
    return api


@pytest.mark.parametrize("name", [DENSE, MOE])
@pytest.mark.parametrize("fault", ["half_batch", "answers_swapped"])
def test_a_broken_prefill_fails(name, fault, capsys, monkeypatch):
    monkeypatch.setattr(port, "api", broken_prefill(fault))
    assert not result(name, capsys)["correct"]


@pytest.mark.parametrize("name", [TRAIN, DENSE, MOE])
def test_the_control_fails(name):
    cell = tiny_cell(name)
    readings = (control.train_readings if cell.mix["kind"] == "train"
                else control.prefill_readings)
    for seed in (101, 102, 103):
        numbers = readings(cell, seed, CPU, "control")
        correct, checks = check.decide(numbers, cell.limits)
        assert not correct, checks
