"""Streaming memory nodes (IMN/OMN) and the interleaved multi-bank bus.

Sec. V-B: memory nodes are independent bus masters whose address units
generate affine streams from three CPU-written parameters (initial address,
size, stride); FIFOs between the units and the fabric damp stalls. The
X-HEEP interleaved bus maps word address -> bank ``addr % n_banks``; each
bank serves one beat per cycle, so with 4 interleaved banks the fabric sees
up to 128 bits/cycle (Sec. VI-A).

These descriptors drive (a) the cycle-level elastic simulator's bank
arbiter and (b) the TPU performance path, where each ``StreamSpec`` lowers
to a Pallas ``BlockSpec`` index map (see ``repro/kernels/fabric_stream.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """One affine address stream: word addresses base + k*stride, k<size."""

    base: int
    size: int
    stride: int = 1

    def addr(self, k: int) -> int:
        return self.base + k * self.stride

    def bank(self, k: int, n_banks: int) -> int:
        return self.addr(k) % n_banks


@dataclasses.dataclass
class BusConfig:
    """Interleaved-bus model (Sec. V-A): ``n_banks`` single-ported banks."""

    n_banks: int = 4

    def word_bits(self) -> int:
        return 32

    def peak_bits_per_cycle(self) -> int:
        return self.n_banks * self.word_bits()


class BankArbiter:
    """Per-bank round-robin arbitration: one grant per bank per cycle.

    Each bank remembers its last-granted master and serves the next
    requester in cyclic order — the standard interconnect policy, and what
    makes fft's 8 simultaneous memory nodes on 4 banks settle at ~2 cycles
    per element set (Sec. VII-B: 'ideally two clock cycles').
    """

    def __init__(self, bus: BusConfig):
        self.bus = bus
        self._last: Dict[int, int] = {}

    def grant(self, requests: List[int]) -> List[bool]:
        """requests[i] = bank wanted by node i (-1 = no request)."""
        n = len(requests)
        granted = [False] * n
        by_bank: Dict[int, List[int]] = {}
        for i, b in enumerate(requests):
            if b >= 0:
                by_bank.setdefault(b, []).append(i)
        for b, nodes in by_bank.items():
            start = self._last.get(b, -1)
            # pick the first requester strictly after `start` in cyclic order
            pick = min(nodes, key=lambda i: ((i - start - 1) % n))
            granted[pick] = True
            self._last[b] = pick
        return granted


def default_streams(names: List[str], size: int,
                    spread_banks: bool = True,
                    n_banks: int = 4) -> Dict[str, StreamSpec]:
    """Driver-chosen stream placement: consecutive vectors whose bases land
    on different banks (the software convention that minimizes conflicts)."""
    specs = {}
    for i, name in enumerate(names):
        base = i if spread_banks else i * size
        specs[name] = StreamSpec(base=base * (1 if spread_banks else 1),
                                 size=size, stride=n_banks if spread_banks else 1)
    # spread mode: node i walks bank i only (stride = n_banks) — conflict-free
    # when #nodes <= n_banks; beyond that nodes share banks round-robin.
    if spread_banks:
        specs = {name: StreamSpec(base=i % n_banks + (i // n_banks) * n_banks * size,
                                  size=size, stride=n_banks)
                 for i, name in enumerate(names)}
    return specs


def contiguous_streams(names: List[str], size: int) -> Dict[str, StreamSpec]:
    """Naive layout: vectors packed back-to-back, stride-1 (bank rotation)."""
    return {name: StreamSpec(base=i * size, size=size, stride=1)
            for i, name in enumerate(names)}
