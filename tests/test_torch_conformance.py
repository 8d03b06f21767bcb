"""The differential conformance corpus on the port's ``"cuda"`` backend
(``device="cpu"``: the kernels' plain versions). It must reproduce the
reference's pinned split exactly, 76 cases verified bit-exact against the
corpus's independent pure-Python semantics and 154 skipped, each with the
reference's named skip reason (``tests/test_conformance.py``)."""
from repro.engine.capabilities import backend_skip_reason as ref_skip_reason
from repro_torch.convert import dfg_from_reference
from repro_torch.engine.capabilities import backend_skip_reason
from repro_torch.kernels.fabric_reduce import run_dfg
from test_conformance import (N_CASES, PALLAS_SKIPPED, PALLAS_VERIFIED,
                              _mk_case)


def test_conformance_corpus_on_cuda_backend():
    verified, skipped = 0, 0
    for seed in range(N_CASES):
        length = (8, 16, 24)[seed % 3]
        g_ref, inputs, refs = _mk_case(seed, length)
        g = dfg_from_reference(g_ref)
        assert g.canonical_signature() == g_ref.canonical_signature()
        reason = backend_skip_reason(g, length, "cuda")
        assert reason == ref_skip_reason(g_ref, length, "pallas"), seed
        if reason is not None:
            skipped += 1
            continue
        verified += 1
        outs = run_dfg(g, inputs, device="cpu")
        for o, want in refs.items():
            assert outs[o].tolist() == want, (seed, o)
    assert verified == PALLAS_VERIFIED
    assert skipped == PALLAS_SKIPPED
