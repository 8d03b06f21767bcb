"""The paper's own system configuration (Sec. VI-A): the STRELA SoC.

Not an LM architecture — this config parameterizes the fidelity layer
(fabric dimensions, bus, clock, memory map) and is what the Table I/II
benchmarks instantiate. Kept alongside the LM configs per the repository
layout convention (configs/ holds every selectable system).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.fabric import Fabric
from repro_torch.core.streams import BusConfig


@dataclasses.dataclass(frozen=True)
class StrelaSoC:
    # CGRA fabric: 4x4 PEs, 32-bit datapath (Sec. VI-A)
    rows: int = 4
    cols: int = 4
    datapath_bits: int = 32
    n_imns: int = 4
    n_omns: int = 4
    # memory subsystem: 8 x 32 KiB banks, last 4 interleaved
    n_banks_total: int = 8
    bank_kib: int = 32
    n_interleaved: int = 4
    # clocking / process (for energy conversion)
    clock_mhz: float = 250.0
    process: str = "TSMC 65nm LP"
    # control core
    cpu: str = "CV32E40P (RV32IMC, 4-stage, -O3)"

    def fabric(self) -> Fabric:
        return Fabric(rows=self.rows, cols=self.cols, n_imns=self.n_imns,
                      n_omns=self.n_omns)

    def bus(self) -> BusConfig:
        return BusConfig(n_banks=self.n_interleaved)

    def peak_gops(self) -> float:
        """All 16 FUs firing every cycle at 250 MHz = 4.0 GOPs theoretical;
        the paper's measured peak (fft) is bus-limited at 1.22 GOPs."""
        return self.rows * self.cols * self.clock_mhz / 1e3


SOC = StrelaSoC()
