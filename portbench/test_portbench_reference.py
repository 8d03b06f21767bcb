"""The plain reference against the port, in float32 at reduced widths on
the CPU: the same weights and tokens give the same prefill (last logits
and KV caches) and the same three training steps."""
import pytest
import torch

from portbench import port, traffic, weights
from portbench.drivers import train as T
from portbench.reference import model as RM
from portbench.reference.precision import CONTROL, REFERENCE
from portbench.spec import model_spec
from portbench.tiny import tiny_cell

PREFILL = ["minicpm-2b.prefill-mix", "granite-moe-3b-a800m.prefill-mix"]


@pytest.mark.parametrize("name", PREFILL)
def test_prefill_equals_the_port(name):
    cell = tiny_cell(name, dtype="float32")
    spec = model_spec(cell.conf)
    cfg = port.config(cell.conf, spec)
    tree = weights.make_tree(spec, 5, "cpu")
    api = port.api(cfg)
    tokens = traffic.prompts(cell.mix, spec.vocab, 5, 0, 64, "cpu")
    logits, caches = api.prefill(port.model(tree, cfg, "cpu"),
                                 {"tokens": tokens})
    kv = []
    ref = RM.prefill(spec, tree, tokens, REFERENCE,
                     lambda i, k, v: kv.append((k, v)))
    assert len(kv) == spec.n_layers
    torch.testing.assert_close(logits, ref, rtol=1e-5, atol=1e-5)
    for i, (k, v) in enumerate(kv):
        torch.testing.assert_close(caches[0][i].float(), k, rtol=0, atol=0)
        torch.testing.assert_close(caches[1][i].float(), v, rtol=0, atol=0)
    # the control differs
    assert (RM.prefill(spec, tree, tokens, CONTROL) - ref).abs().max() > 1e-3


def test_three_training_steps_equal_the_port():
    cell = tiny_cell("minicpm-2b.train-512", dtype="float32")
    prog = T.Program(cell, 11, torch.device("cpu"))
    got = T.checked_steps(prog)
    want = T.reference(cell, 11, torch.device("cpu"))
    assert got["losses"] == pytest.approx(want["losses"], rel=1e-5)
    assert set(got["grad_norms"]) == set(want["grad_norms"])
    for n, g in want["grad_norms"].items():
        assert got["grad_norms"][n] == pytest.approx(g, rel=1e-4, abs=1e-7)
    for n, c in want["change_norms"].items():
        assert got["change_norms"][n] == pytest.approx(c, rel=1e-4,
                                                       abs=1e-7)
    assert max(want["change_norms"].values()) > 0


def test_moe_capacity_drops_pairs_in_token_order():
    cell = tiny_cell("granite-moe-3b-a800m.prefill-mix", dtype="float32")
    spec = model_spec(cell.conf)
    w = {"router": torch.zeros(spec.d_model, 4),
         "w_experts_gate": torch.ones(4, spec.d_model, spec.d_ff),
         "w_experts_up": torch.ones(4, spec.d_model, spec.d_ff),
         "w_experts_down": torch.ones(4, spec.d_ff, spec.d_model) / 1e4}
    x = torch.randn(1, 10, spec.d_model) / 10
    # a flat router routes every token to experts 0 and 1 (ties go to the
    # lower index); capacity int(1.25 x 10 x 2 / 4) = 6 keeps tokens 0-5
    out, _ = RM.moe(x, w, spec, REFERENCE)
    assert bool((out[0, :6] != 0).all()) and bool((out[0, 6:] == 0).all())
