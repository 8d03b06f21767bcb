"""Training traffic: the port's step (``launch.train.make_step``) on the
model, its AdamW state and the benchmark's batches, all on the card.

Set-up builds one training object from the seed and drives it through
the first ``checked_steps`` steps by the window's own call and feed; they
warm up every shape and give the readings the check compares. The window
then goes on with the same object, step after step, until ``--seconds``
have passed, and ends in a synchronise: the rate is every token stepped
over all the window's time."""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from portbench import check, device as D, port, traffic, weights
from portbench.reference import train as ref_train
from portbench.reference.precision import REFERENCE, Precision
from portbench.spec import model_spec
from portbench.trace import STRETCH, from_events


class Program:
    """The one training object: the port's model, AdamW state and step."""

    def __init__(self, cell, seed: int, device: torch.device):
        self.mix, self.seed, self.device = cell.mix, seed, device
        self.spec = model_spec(cell.conf)
        cfg = port.config(cell.conf, self.spec)
        tree = weights.make_tree(self.spec, seed, device)
        self.params = port.model(tree, cfg, device)
        del tree
        self.opt, self.step_fn = port.trainer(port.api(cfg),
                                              self.mix["optimizer"],
                                              self.mix["schedule"])
        self.names = [n for n, _ in self.params.named_parameters()]
        self.state = self.opt.init(list(self.params.parameters()))
        self.steps = 0

    def step(self) -> torch.Tensor:
        """One step on the next batch of the feed; its loss, on the card."""
        batch = traffic.train_batch(self.mix, self.spec.vocab, self.seed,
                                    self.steps, self.device)
        self.params, self.state, _, metrics = self.step_fn(
            self.params, self.state, None, batch)
        self.steps += 1
        return metrics["loss"]

    def change_norms(self) -> Dict[str, float]:
        """Each leaf's change since the weights were made (made again from
        the seed, one stacked leaf at a time)."""
        named = dict(self.params.named_parameters())
        by_path: Dict[str, List] = {}
        for name, path, layer in weights.layer_leaves(self.spec):
            by_path.setdefault(path, []).append((name, layer))
        out: Dict[str, float] = {}
        with torch.no_grad():
            for path, items in by_path.items():
                init = weights.make_leaf(self.spec, self.seed, path,
                                         self.device)
                norms = torch.stack([torch.linalg.vector_norm(
                    named[n].float() - (init[i] if i >= 0 else init).float())
                    for n, i in items])
                out.update(zip([n for n, _ in items], norms.tolist()))
                del init
        return out


def checked_steps(prog: Program) -> Dict:
    """The first steps, with what the check compares: their losses, the
    first gradient as AdamW got it (its first moment over 1 - b1) and each
    leaf's change after the last of them."""
    losses, b1 = [], prog.mix["optimizer"]["b1"]
    for i in range(prog.mix["checked_steps"]):
        losses.append(prog.step())
        if i == 0:
            with torch.no_grad():
                grads = torch.stack([torch.linalg.vector_norm(m)
                                     for m in prog.state.mu]) / (1 - b1)
    return {"losses": [float(x) for x in losses],
            "grad_norms": dict(zip(prog.names, grads.tolist())),
            "change_norms": prog.change_norms()}


def window(prog: Program, seconds: float) -> Dict:
    D.sync(prog.device)
    t0 = time.perf_counter()
    losses = []
    while True:
        losses.append(prog.step())
        if time.perf_counter() - t0 >= seconds:
            break
    D.sync(prog.device)
    elapsed = time.perf_counter() - t0
    bad = int((~torch.stack(losses).isfinite()).sum())
    return {"seconds": elapsed, "steps": len(losses), "failed": bad}


def profile(prog: Program, steps: int):
    """``steps`` more steps under the profiler, after one that takes the
    profiler's start-up."""
    from torch.profiler import profile as torch_profile, record_function
    with torch_profile(activities=D.profiler_activities(prog.device)) as p:
        prog.step()
        D.sync(prog.device)
        with record_function(STRETCH):
            for _ in range(steps):
                prog.step()
            D.sync(prog.device)
    unit = {"batch": prog.mix["batch"], "seq": prog.mix["seq"]}
    return from_events(p.events(), [unit] * steps)


def reference(cell, seed: int, device: torch.device,
              precision: Precision = REFERENCE) -> Dict:
    """The reference trainer from the same weights on the same batches."""
    spec, mix = model_spec(cell.conf), cell.mix
    tree = weights.make_tree(spec, seed, device)
    batches = [traffic.train_batch(mix, spec.vocab, seed, i, device)
               for i in range(mix["checked_steps"])]
    return ref_train.train(spec, tree, batches, mix["schedule"],
                           mix["optimizer"], precision)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> Dict:
    D.reset_peak(device)
    prog = Program(cell, seed, device)
    readings = checked_steps(prog)
    D.sync(device)
    setup_s = time.perf_counter() - t_start
    plain = port.plain_attention_calls()
    win = window(prog, seconds)
    peak = D.peak_bytes(device)
    if device.type == "cuda" and port.plain_attention_calls() != plain:
        raise RuntimeError("train: a plain attention ran in the window")
    tr = profile(prog, prog.mix["trace_steps"]) if trace else None
    del prog
    D.release(device)
    numbers = check.train_numbers(readings, reference(cell, seed, device))
    unit = {"batch": cell.mix["batch"], "seq": cell.mix["seq"]}
    tokens = win["steps"] * unit["batch"] * unit["seq"]
    return {"e2e": {"train_tokens_per_s": tokens / win["seconds"],
                    "setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30},
            "attempted": win["steps"], "failed": win["failed"],
            "numbers": numbers, "trace": tr, "peak_bytes": peak,
            "window": {"seconds": win["seconds"],
                       "units": [unit] * win["steps"]}}
