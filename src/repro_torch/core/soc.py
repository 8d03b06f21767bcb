"""SoC model: CV32E40P CPU cycle model + offload orchestration overheads.

The CPU baseline executes the same kernels in software (-O3). We model the
RV32IMC in-order 4-stage core with an instruction-level cost model using
*fixed architectural weights* (loads/stores 2 cycles with the load-use
hazard, ALU 1, MUL 2, taken branch 3, index arithmetic 2/element) applied
to per-benchmark -O3 instruction profiles (codegen-informed: mm64 spills B
accesses, mm16's inner loop unrolls). Unconstrained least-squares fits of
the weights against the paper's 12 published CPU cycle counts produce
non-physical (negative) costs, so we keep the weights architectural and
report per-benchmark residuals (typically within ±20%) as the calibration
artifact; benchmarks always show the paper's own CPU cycles side-by-side.

Offload orchestration (Sec. V-B 'Computation Model'):
  * kernel configuration fetch: ``isa.config_cycles`` (5 words/PE + setup);
  * per-shot re-arm: the CPU writes base/size/stride for every stream plus
    the start command over the memory-mapped interface, then synchronizes on
    the completion interrupt — ``RELOAD_OVERHEAD`` cycles (fitted to the
    mm16/mm64 totals of Table II).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.paper_data import TABLE_I, TABLE_II

# ---------------------------------------------------------------------------
# CPU cycle model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelProfile:
    """Per-element instruction counts for the software version of a kernel
    (plus the element count), derived from the -O3 inner loop."""

    elements: int
    loads: float
    stores: float
    alu: float          # add/sub/logic/shift/compare
    mul: float
    branches: float     # taken branches (loop back-edges + data branches)


# architectural weights: (load, store, alu, mul, taken-branch, index/element)
CPU_WEIGHTS = np.array([2.0, 2.0, 1.0, 2.0, 3.0, 2.0])


# software inner-loop profiles (per element; codegen-informed, see docstring)
def profiles() -> Dict[str, KernelProfile]:
    p: Dict[str, KernelProfile] = {}
    # fft: per element-set of 4 values: 4 ld, 4 st, 10 arith (4 mul), loop
    p["fft"] = KernelProfile(256, 4, 4, 6, 4, 1)
    # relu: ld, cmp, conditional store path
    p["relu"] = KernelProfile(1024, 1, 1, 2, 0, 1)
    # dither: ld, add, cmp, sel, sub, st
    p["dither"] = KernelProfile(1024, 1, 1, 4, 0, 1.2)
    # find2min: ld, 2 cmp, conditional updates (branchy)
    p["find2min"] = KernelProfile(1024, 1, 0, 5, 0, 1.6)
    # mm 16x16: inner loop unrolls at -O3 (few loop branches)
    p["mm16"] = KernelProfile(16 ** 3, 2, 0, 2, 1, 0.25)
    # mm 64x64: register pressure spills the B access (extra load)
    p["mm64"] = KernelProfile(64 ** 3, 3, 0, 2, 1, 1)
    # conv2d 62x62 valid x 3x3 taps, taps unrolled
    p["conv2d"] = KernelProfile(62 * 62 * 9, 1, 0.12, 1, 1, 0.2)
    # polybench (SMALL): dominated by matmul/matvec inner loops
    p["gemm"] = KernelProfile(60 * 70 * 80, 2, 0.02, 2, 1, 0.3)
    # gemver/gesummv: fused loops share operand loads across phases
    p["gemver"] = KernelProfile(4 * 120 * 120, 1.6, 0.25, 1.8, 1, 0)
    p["gesummv"] = KernelProfile(2 * 90 * 90, 1.25, 0.03, 0.5, 1, 0.6)
    p["2mm"] = KernelProfile(40 * 50 * 70 + 40 * 80 * 50, 2, 0.03, 2, 1, 0.6)
    p["3mm"] = KernelProfile(40 * 50 * 60 + 50 * 70 * 80 + 40 * 70 * 50,
                             2, 0.03, 2, 1, 0.3)
    return p


_PAPER_CPU_CYCLES = {**{k: v[7] for k, v in TABLE_I.items()},
                     **{k: v[6] for k, v in TABLE_II.items()}}


def cpu_cycles(profile: KernelProfile) -> float:
    """Predicted CV32E40P cycles for a kernel's software version."""
    x = np.array([profile.loads, profile.stores, profile.alu, profile.mul,
                  profile.branches, 1.0])
    return float(profile.elements * (x @ CPU_WEIGHTS))


def cpu_model_report() -> List[dict]:
    """Fit-quality table: per benchmark, modeled vs published CPU cycles."""
    out = []
    for k, prof in profiles().items():
        pred = cpu_cycles(prof)
        ref = _PAPER_CPU_CYCLES[k]
        out.append({"kernel": k, "paper_cpu_cycles": ref,
                    "model_cpu_cycles": round(pred),
                    "rel_err": (pred - ref) / ref})
    return out


# ---------------------------------------------------------------------------
# Offload orchestration costs
# ---------------------------------------------------------------------------

# Per-shot re-arm: MMIO writes for stream parameters + start + interrupt
# synchronization. Fitted to Table II's mm16/mm64 totals (see DESIGN.md).
RELOAD_OVERHEAD = 95

# One-shot preamble (stream setup + start + final sync) — excluded from the
# paper's one-shot performance metrics (Sec. VII-B) but modeled for energy.
ONESHOT_PREAMBLE = 60


def offload_cycles(config_cycles: int, shot_exec_cycles: List[int],
                   reconfigs: int = 1) -> int:
    """Total offloaded execution time of a multi-shot kernel (Sec. V-B):
    config fetch (per reconfiguration) + per-shot re-arm + execution."""
    return (config_cycles * reconfigs
            + sum(shot_exec_cycles)
            + RELOAD_OVERHEAD * len(shot_exec_cycles))
