"""The route rule of the bfloat16 ``stream_matmul``
(``repro_torch.kernels.stream_matmul.bf16_route``): the ``wgmma`` kernel
where TMA can address every row of A and B, ``wgmma_realign`` elsewhere, decided
from shape and alignment alone. Runs on CPU tensors, whose data pointers
follow the same rule; ``tests/test_torch_gpu.py`` checks on the card that
the chosen kernel is the one launched. Also holds the rule and the route
codes against ``csrc/stream_matmul.cu``, which refuses a ``wgmma`` request
whose conditions fail and the retired route code 1."""
import os
import re

import pytest
import torch

from repro_torch.kernels import stream_matmul as sm

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "csrc", "stream_matmul.cu")


def _bf16(rows, cols, offset=0):
    """A contiguous (rows, cols) bfloat16 tensor starting ``offset``
    elements past an aligned allocation."""
    base = torch.zeros(rows * cols + offset, dtype=torch.bfloat16)
    return base[offset:].view(rows, cols)


@pytest.mark.parametrize("m,k,n,a_off,b_off,want", [
    (4096, 2304, 5760, 0, 0, "wgmma"),      # the ops path's shape
    (64, 64, 256, 0, 0, "wgmma"),           # one tile
    (200, 136, 264, 0, 0, "wgmma"),         # M, N ragged against the tile
    (130, 8, 40, 0, 0, "wgmma"),            # K = 8
    (100, 72, 96, 0, 0, "wgmma"),           # K not a multiple of 64
    (300, 72, 8, 0, 0, "wgmma"),            # N = 8
    (1, 8, 8, 0, 0, "wgmma"),               # M = 1
    (70, 90, 56, 0, 0, "wgmma_realign"),    # K % 8 != 0: rows of A unaligned
    (70, 64, 50, 0, 0, "wgmma_realign"),    # N % 8 != 0: rows of B unaligned
    (1, 1, 1, 0, 0, "wgmma_realign"),
    (100, 64, 128, 1, 0, "wgmma_realign"),  # A 2 bytes past 16-byte alignment
    (100, 64, 128, 4, 0, "wgmma_realign"),  # A 8 bytes past
    (100, 64, 128, 8, 0, "wgmma"),          # A 16 bytes past: aligned again
    (100, 64, 128, 0, 1, "wgmma_realign"),  # B misaligned
    (0, 64, 128, 0, 0, "wgmma_realign"),    # empty M
    (100, 64, 0, 0, 0, "wgmma_realign"),    # empty N
    (100, 0, 128, 0, 0, "wgmma_realign"),   # empty K
    (4096, 2304, 5760, 1, 0, "wgmma_realign"),  # the dense shape, A 2 B off
    (4096, 1536, 49155, 0, 0, "wgmma_realign"),  # granite's LM head, N % 8 3
])
def test_bf16_route_rule(m, k, n, a_off, b_off, want):
    a, b = _bf16(m, k, a_off), _bf16(k, n, b_off)
    assert a.is_contiguous() and b.is_contiguous()
    assert sm.bf16_route(a, b) == want
    assert sm.route(a, b) == want


def test_float32_takes_the_sgemm_route():
    a, b = torch.zeros(64, 64), torch.zeros(64, 256)
    assert sm.route(a, b) == "sgemm"


def test_an_unknown_route_is_refused_before_any_launch():
    a, b = _bf16(8, 8), _bf16(8, 8)
    launches = sm.launches
    with pytest.raises(ValueError, match="route must be one of"):
        sm._launch_route(a, b, torch.float32, "tma")
    assert sm.launches == launches


def test_route_codes_and_the_wgmma_rule_match_the_cuda_source():
    with open(CSRC) as f:
        src = f.read()
    comment = src.replace("\n//", "")
    codes = re.search(r"route codes: 0 (\w+) \(float32 inputs\), 2 (\w+) "
                      r"and 3 (\w+)", comment)
    assert {codes[1]: 0, codes[2]: 2, codes[3]: 3} == sm.ROUTES
    assert "code 1, the retired mma.sync route, is refused" in \
        " ".join(comment.split())
    check = " ".join(re.search(r"if \(M < 0 (.*?)\)\s*\n\s*return", src,
                               re.S)[1].split())
    assert "route > 3 || route == 1 ||" in check
    rule = re.search(r"route == 2 && !\((.*?)\)\)\s*\n", src, re.S)[1]
    assert " ".join(rule.split()) == (
        "K >= 1 && K % 8 == 0 && N % 8 == 0 && aligned16(a) && "
        "aligned16(b) && aligned16(c)")
