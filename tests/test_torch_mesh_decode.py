"""Prefill and decode of the port's LM on a (2, 2) ``gloo`` mesh of four
ranks on the CPU (``torch_mesh_workers.decode_four_ranks``): each rank
prefills and decodes its rows of the batch with its KV caches and SSM
states DTensors placed by ``partition.kv_cache_spec`` and
``ssm_state_specs`` (the dry run's decode layout), and its logits equal
the one-device run's rows within 1e-5 of their largest magnitude
(float32; the ranks sum their heads' out-projections in another order;
the MoE arch on its global path, ``moe_impl="gspmd"``, whose capacity
counts every rank's tokens).
A single request decodes from a state placed in the long-context layout
(the KV sequence and the SSM state's head channels over 'data') as the
one-device run does."""
import json

import pytest

import torch_mesh_workers as W

TOL = 1e-5


@pytest.fixture(scope="module")
def decode(tmp_path_factory):
    d = tmp_path_factory.mktemp("decode")
    W.spawn("decode_four_ranks", 4, d, timeout=300)
    with open(d / "decode.json") as f:
        return json.load(f)


@pytest.mark.parametrize("arch", W.DECODE_ARCHS)
def test_decode_on_a_mesh_equals_one_device(decode, arch):
    got = decode["errs"][arch]
    assert got["placed"] and got["err"] <= TOL, got


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-1.3b",
                                  "zamba2-2.7b"])
def test_single_request_decodes_from_the_long_context_layout(decode, arch):
    assert decode["long"][arch] <= TOL, decode["long"]
