"""Roofline analysis of a dry-run cell (counterpart of
``repro.roofline.analysis``).

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs / (chips * peak_FLOP/s)
    memory     = HBM_bytes / (chips * HBM_bw)
    collective = collective operand bytes / (chips * LINK_BW)

FLOPs, bytes and collective bytes come from ``roofline.op_costs.OpCosts``
over one eager step under ``FakeTensorMode``: per rank, times the chips,
as the reference's come from the post-SPMD HLO. The reference's HLO-text
``parse_collectives`` has no counterpart here: ``OpCosts`` counts each
collective op as it runs.

Hardware model: one NVIDIA H100 SXM, NVIDIA's data-sheet peaks — 989
TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3. The link rate
is a model input, not a measured one: 450 GB/s, NVLink 4 each way a
card, which holds within one host of 8 cards. A 16 x 16 mesh spans 32
such hosts, whose 400 Gb/s NICs give about 50e9 bytes/s a card between
hosts, so the collective term of a production mesh is a lower bound.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

PEAK_FLOPS = 989e12         # bf16 dense, per card
HBM_BW = 3.35e12            # bytes/s per card
FP32_FLOPS = 67e12          # float32 outside the tensor cores, per card
TF32_FLOPS = 495e12         # TF32 dense on the tensor cores, per card
LINK_BW = 450e9             # bytes/s per card each way (NVLink 4)


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: Optional[float] = None

    def useful_fraction(self) -> Optional[float]:
        if self.model_flops is None or self.flops == 0:
            return None
        return self.model_flops / self.flops

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """How close the dominant term is to the best achievable given the
        other two (1.0 = perfectly overlapped balanced execution)."""
        t = self.step_time_s
        return self.compute_s / t if t > 0 else 0.0


def roofline_from_costs(flops: float, hbm_bytes: float,
                        collective_bytes: float, chips: int,
                        model_flops: Optional[float] = None) -> Roofline:
    compute_s = flops / (chips * PEAK_FLOPS)
    memory_s = hbm_bytes / (chips * HBM_BW)
    coll_s = collective_bytes / (chips * LINK_BW)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    return Roofline(flops, hbm_bytes, collective_bytes, chips, compute_s,
                    memory_s, coll_s, bottleneck, model_flops)


def model_flops_train(n_params_active: float, tokens: float) -> float:
    """6·N·D for one training step (fwd+bwd)."""
    return 6.0 * n_params_active * tokens


def model_flops_decode(n_params_active: float, tokens: float) -> float:
    """2·N per generated token (weights read once, fwd only)."""
    return 2.0 * n_params_active * tokens
