"""Fabric profiler: per-PE / per-IMN / per-OMN utilization from timing data.

The paper's headline quantities (OPs/cycle, MOPs/mW, config-overhead
breakdowns, Table I/II) are all *attribution* statements — which resource
the cycles went to. This module derives that attribution from data the
pipeline already records, with no extra simulation:

  * a recorded ``TimingTrace`` (static-rate kernels: firing counts, OMN
    arrival schedules, bank beats are value-independent), or
  * a live ``SimResult`` (recirculating / data-dependent kernels, whose
    firing counts exist only per execution),

joined against the shot's ``Mapping`` for placement. Per resource it
reports firing counts, occupancy % (firings / elapsed cycles), bubble
cycles (elapsed − firings: cycles the station sat idle or stalled), and
the kernel's steady-state II; :meth:`FabricProfile.bottleneck` names the
busiest resource — the one a mapper or scheduler would have to relieve
first ("Aligned Compute and Communication Provisioning"'s compute-vs-
routing split, PAPERS.md).

The same counts feed ``core.energy.features_from_sim`` (activity factors
of the power model), so utilization reports and energy reports share one
source of truth; ``python -m repro_torch.obs.report`` renders the heat-table.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import dfg as D
from repro_torch.core.elastic_sim import SimResult, TimingTrace
from repro_torch.core.mapper import Mapping

# node kinds the power model bills as control activity
_CTRL_KINDS = (D.CMP, D.MUX, D.BRANCH, D.MERGE)


@dataclasses.dataclass
class ResourceUtil:
    """Utilization of one fabric resource over one kernel execution."""

    kind: str                 # "pe" | "imn" | "omn"
    name: str                 # DFG node name
    pos: str                  # "PE[r,c]" | "IMN[c]" | "OMN[c]"
    role: str                 # alu:add, cmp:gt, route, stream-in, ...
    firings: int              # FU firings / stream beats delivered
    cycles: int               # elapsed kernel cycles

    @property
    def occupancy(self) -> float:
        """Fraction of elapsed cycles this resource did work."""
        return self.firings / self.cycles if self.cycles else 0.0

    @property
    def bubbles(self) -> int:
        """Idle/stalled cycles (elapsed − firings), the paper's 'bubble'
        cycles an elastic handshake absorbs."""
        return max(self.cycles - self.firings, 0)

    def to_dict(self) -> Dict:
        return {"kind": self.kind, "name": self.name, "pos": self.pos,
                "role": self.role, "firings": self.firings,
                "occupancy": self.occupancy, "bubbles": self.bubbles}


@dataclasses.dataclass
class FabricProfile:
    """Utilization of every mapped resource for one kernel execution."""

    kernel: str
    cycles: int
    length: Optional[int]            # stream extent (None if unknown)
    bank_beats: int
    n_banks: int
    steady_ii: float
    route_pes: int                   # active PEs carrying only routed traffic
    rows: List[ResourceUtil]
    from_trace: bool = False         # derived from a recorded TimingTrace

    # -- aggregates (the energy model's activity features) -----------------
    def _pe_rows(self) -> List[ResourceUtil]:
        return [r for r in self.rows if r.kind == "pe"]

    @property
    def pe_firings(self) -> int:
        """Total FU firings — bit-identical to the source trace/sim sum."""
        return sum(r.firings for r in self._pe_rows())

    @property
    def arith_firings(self) -> int:
        return sum(r.firings for r in self._pe_rows()
                   if r.role.startswith(D.ALU))

    @property
    def ctrl_firings(self) -> int:
        return sum(r.firings for r in self._pe_rows()
                   if not r.role.startswith(D.ALU))

    @property
    def mem_rate(self) -> float:
        """Bus beats per cycle (the power model's memory-node feature)."""
        return self.bank_beats / self.cycles if self.cycles else 0.0

    @property
    def ops_per_cycle(self) -> float:
        return self.pe_firings / self.cycles if self.cycles else 0.0

    @property
    def bus_occupancy(self) -> float:
        """Fraction of the interleaved-bank bandwidth actually used."""
        cap = self.cycles * self.n_banks
        return self.bank_beats / cap if cap else 0.0

    def bottleneck(self) -> Tuple[str, float]:
        """(resource label, occupancy) of the saturating resource.

        The memory bus competes as one aggregate resource at its full
        ``n_banks`` beats/cycle bandwidth; ties go to the earlier row
        (stable, so reports are deterministic)."""
        best, occ = "memory-bus", self.bus_occupancy
        for r in self.rows:
            if r.occupancy > occ:
                best, occ = f"{r.pos} {r.name}", r.occupancy
        return best, occ

    def to_dict(self) -> Dict:
        label, occ = self.bottleneck()
        return {"kernel": self.kernel, "cycles": self.cycles,
                "length": self.length, "steady_ii": self.steady_ii,
                "ops_per_cycle": self.ops_per_cycle,
                "pe_firings": self.pe_firings,
                "bank_beats": self.bank_beats,
                "bus_occupancy": self.bus_occupancy,
                "route_pes": self.route_pes, "from_trace": self.from_trace,
                "bottleneck": label, "bottleneck_occupancy": occ,
                "rows": [r.to_dict() for r in self.rows]}

    # -- rendering ---------------------------------------------------------
    def table(self, width: int = 24) -> str:
        """Per-resource utilization heat-table (monospace)."""
        ii = "inf" if self.steady_ii == float("inf") \
            else f"{self.steady_ii:.1f}"
        head = (f"{self.kernel}: {self.cycles} cycles"
                + (f", {self.length} elements" if self.length else "")
                + f", II={ii}, {self.ops_per_cycle:.2f} ops/cycle"
                + (" [trace]" if self.from_trace else " [sim]"))
        lines = [head,
                 f"  {'resource':<22s} {'role':<12s} {'firings':>8s} "
                 f"{'occ%':>6s} {'bubbles':>8s}  heat"]
        for r in self.rows:
            bar = "#" * int(round(r.occupancy * width))
            lines.append(f"  {r.pos + ' ' + r.name:<22s} {r.role:<12s} "
                         f"{r.firings:>8d} {r.occupancy * 100:>5.1f}% "
                         f"{r.bubbles:>8d}  {bar}")
        if self.route_pes:
            lines.append(f"  {'(route-through PEs)':<22s} {'route':<12s} "
                         f"{'-':>8s} {'-':>6s} {'-':>8s}  x{self.route_pes}")
        lines.append(f"  {'memory bus':<22s} {'banks x' + str(self.n_banks):<12s} "
                     f"{self.bank_beats:>8d} {self.bus_occupancy * 100:>5.1f}%")
        label, occ = self.bottleneck()
        lines.append(f"  bottleneck: {label} at {occ * 100:.1f}% occupancy")
        return "\n".join(lines)


def _role(n: D.Node) -> str:
    op = getattr(n.op, "name", None)
    return f"{n.kind}:{op.lower()}" if op else n.kind


def _steady_ii(arrival_cycles: Dict[str, Sequence[int]]) -> float:
    """Median positive inter-arrival gap at the OMNs (same statistic as
    ``SimResult.steady_ii``)."""
    gaps: List[int] = []
    for arr in arrival_cycles.values():
        if len(arr) > 1:
            d = np.diff(np.asarray(arr))
            gaps.extend(int(x) for x in d[d > 0])
    return float(np.median(gaps)) if gaps else float("inf")


def _profile(m: Mapping, kernel: str, cycles: int,
             arrival_cycles: Dict[str, Sequence[int]],
             fu_firings: Dict[str, int], bank_beats: int,
             length: Optional[int], n_banks: int,
             from_trace: bool) -> FabricProfile:
    g = m.dfg
    rows: List[ResourceUtil] = []
    for name in sorted(m.place, key=lambda n: m.place[n]):
        r, c = m.place[name]
        rows.append(ResourceUtil("pe", name, f"PE[{r},{c}]",
                                 _role(g.nodes[name]),
                                 int(fu_firings.get(name, 0)), cycles))
    for name, col in sorted(m.imn_of.items(), key=lambda kv: kv[1]):
        # an IMN delivers exactly one beat per stream element
        rows.append(ResourceUtil("imn", name, f"IMN[{col}]", "stream-in",
                                 int(length) if length else 0, cycles))
    for name, col in sorted(m.omn_of.items(), key=lambda kv: kv[1]):
        rows.append(ResourceUtil("omn", name, f"OMN[{col}]", "stream-out",
                                 len(arrival_cycles.get(name, ())), cycles))
    return FabricProfile(
        kernel=kernel, cycles=cycles, length=length, bank_beats=bank_beats,
        n_banks=n_banks, steady_ii=_steady_ii(arrival_cycles),
        route_pes=m.n_active_pes() - len(m.place), rows=rows,
        from_trace=from_trace)


def profile_sim(m: Mapping, sim: SimResult, kernel: Optional[str] = None,
                length: Optional[int] = None,
                n_banks: int = 4) -> FabricProfile:
    """Profile from a live ``SimResult`` (works for recirculating graphs,
    whose firing counts are data-dependent and exist only per run)."""
    return _profile(m, kernel or m.dfg.name, sim.cycles, sim.arrival_cycles,
                    sim.fu_firings, sim.bank_beats, length, n_banks,
                    from_trace=sim.replayed)


def profile_trace(m: Mapping, trace: TimingTrace,
                  kernel: Optional[str] = None) -> FabricProfile:
    """Profile from a recorded ``TimingTrace`` — zero re-simulation; counts
    are bit-identical to the trace's recorded firings by construction."""
    return _profile(m, kernel or m.dfg.name, trace.cycles,
                    trace.arrival_cycles, trace.fu_firings, trace.bank_beats,
                    trace.length, trace.n_banks, from_trace=True)
