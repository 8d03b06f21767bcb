"""Power/energy model of the accelerator and SoC, fitted to the paper.

We cannot measure silicon power, so we reproduce the paper's *model
structure* (Sec. V-C / VII-B): hierarchical clock gating means power scales
with (a) how many PEs are configured and of which kind, (b) their switching
activity, (c) active memory nodes and bus traffic, and (d) the duty cycle of
the PE matrix (multi-shot kernels gate the fabric while the CPU re-arms
streams — why Table II's mm consumes 3.99 mW vs fft's 16.84 mW).

    P_cgra = b0*duty + b1*(arith-PE activity) + b2*(ctrl-PE activity)
           + b3*(route-PE count)*duty + b4*(memory-node beat rate) + b5

    P_soc  = g0 + g1*P_cgra + g2*(bus beats/cycle)      [+ CPU term]

Coefficients are least-squares fitted against the 12 published (CGRA mW,
SoC mW) pairs of Tables I/II; the benchmarks report the fit residuals as a
calibration artifact. The per-EB figure the paper gives (~80 uW when used)
is used as a sanity bound on b1..b3.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


def _nnls(A: np.ndarray, y: np.ndarray, iters: int = 20000,
          lr: Optional[float] = None) -> np.ndarray:
    """Non-negative least squares by projected gradient (tiny problems)."""
    A = np.asarray(A, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    x = np.full(A.shape[1], 0.1)
    if lr is None:
        lip = np.linalg.norm(A.T @ A, 2)
        lr = 1.0 / max(lip, 1e-12)
    for _ in range(iters):
        g = A.T @ (A @ x - y)
        x = np.clip(x - lr * g, 0.0, None)
    return x


@dataclasses.dataclass(frozen=True)
class PowerFeatures:
    """Activity features of one offloaded kernel execution."""

    duty: float            # fraction of cycles the PE matrix is unga ted
    arith_act: float       # sum over ALU FUs of firings/cycle (while active)
    ctrl_act: float        # same for cmp/mux/branch/merge FUs
    route_pes: float       # active route-through PEs
    mem_rate: float        # bus beats per active cycle
    cgra_mw_paper: Optional[float] = None
    soc_mw_paper: Optional[float] = None

    def row(self) -> List[float]:
        return [self.duty, self.arith_act, self.ctrl_act,
                self.route_pes * self.duty, self.mem_rate, 1.0]


class PowerModel:
    """CGRA + SoC power predictors, fitted on Table I/II samples."""

    def __init__(self):
        self.beta: Optional[np.ndarray] = None     # CGRA coefficients
        self.gamma: Optional[np.ndarray] = None    # SoC coefficients
        self._samples: List[PowerFeatures] = []

    # -- fitting -----------------------------------------------------------
    def fit(self, samples: Sequence[PowerFeatures]) -> None:
        self._samples = list(samples)
        A = np.array([s.row() for s in samples], dtype=np.float64)
        y = np.array([s.cgra_mw_paper for s in samples], dtype=np.float64)
        # relative weighting (small multi-shot powers matter as much as fft)
        # + non-negativity: power coefficients are physical.
        self.beta = _nnls(A / y[:, None], np.ones_like(y))

        pc = A @ self.beta
        soc = np.array([s.soc_mw_paper for s in samples], dtype=np.float64)
        B = np.stack([np.ones_like(pc), pc,
                      np.array([s.mem_rate for s in samples])], axis=1)
        self.gamma = _nnls(B / soc[:, None], np.ones_like(soc))

    # -- prediction ----------------------------------------------------------
    def cgra_mw(self, f: PowerFeatures) -> float:
        assert self.beta is not None, "fit() first"
        return float(np.array(f.row()) @ self.beta)

    def soc_mw(self, f: PowerFeatures) -> float:
        assert self.gamma is not None, "fit() first"
        pc = self.cgra_mw(f)
        return float(self.gamma[0] + self.gamma[1] * pc
                     + self.gamma[2] * f.mem_rate)

    def report(self) -> List[dict]:
        out = []
        for s in self._samples:
            pc, ps = self.cgra_mw(s), self.soc_mw(s)
            out.append({
                "cgra_mw_model": pc, "cgra_mw_paper": s.cgra_mw_paper,
                "cgra_rel_err": (pc - s.cgra_mw_paper) / s.cgra_mw_paper,
                "soc_mw_model": ps, "soc_mw_paper": s.soc_mw_paper,
                "soc_rel_err": (ps - s.soc_mw_paper) / s.soc_mw_paper,
            })
        return out


# CPU-side power (Tables I/II): near-constant in-order core at 250 MHz
CPU_MW = 3.7
SOC_CPU_MW = 27.2      # mean of the published SoC-CPU column


def features_from_profile(profile, duty: float = 1.0, cgra_mw_paper=None,
                          soc_mw_paper=None) -> PowerFeatures:
    """Build PowerFeatures from a fabric profile
    (``repro_torch.obs.profiler.FabricProfile``): the profiler's per-PE firing
    counts ARE the power model's activity factors, so utilization reports
    and energy reports can never disagree."""
    cycles = max(profile.cycles, 1)
    return PowerFeatures(duty=duty,
                         arith_act=profile.arith_firings / cycles * duty,
                         ctrl_act=profile.ctrl_firings / cycles * duty,
                         route_pes=profile.route_pes,
                         mem_rate=profile.bank_beats / cycles * duty,
                         cgra_mw_paper=cgra_mw_paper,
                         soc_mw_paper=soc_mw_paper)


def features_from_sim(mapping, sim, duty: float = 1.0,
                      cgra_mw_paper=None, soc_mw_paper=None) -> PowerFeatures:
    """Build PowerFeatures from a Mapping + SimResult.

    Delegates through the fabric profiler (``repro_torch.obs.profiler``), the
    single source of truth for per-resource firing attribution."""
    from repro_torch.obs.profiler import profile_sim
    return features_from_profile(profile_sim(mapping, sim), duty=duty,
                                 cgra_mw_paper=cgra_mw_paper,
                                 soc_mw_paper=soc_mw_paper)


def energy_uj(power_mw: float, cycles: int, clock_mhz: float = 250.0) -> float:
    """Energy in microjoules for `cycles` at `clock_mhz`."""
    return power_mw * (cycles / (clock_mhz * 1e6)) * 1e3
