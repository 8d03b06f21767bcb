"""Fabric resource model: the 4x4 elastic PE array and its routing fabric.

Resources per PE (Figs. 1-4):
  * 4 input ports  IN_N/E/S/W   — Elastic Buffer + Fork Sender; an input port
    may fan out to the FU operand/control inputs and to the other three
    output ports (route-through).
  * 4 output ports OUT_N/E/S/W  — data/valid mux; carries exactly one signal.
  * FU inputs  FU_A / FU_B / FU_C — operand & control muxes.
  * FU output  FU_OUT           — registered datapath result + Fork Sender.

Inter-PE wiring is a nearest-neighbour mesh: OUT_S(r,c) feeds IN_N(r+1,c) etc.
IMNs feed IN_N of the north border; OMNs drain OUT_S of the south border
(Sec. IV-B mapping convention: inputs north, outputs south, E/W columns as
south-to-north return paths).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

# port name constants
IN_PORTS = ("IN_N", "IN_E", "IN_S", "IN_W")
OUT_PORTS = ("OUT_N", "OUT_E", "OUT_S", "OUT_W")
FU_INS = ("FU_A", "FU_B", "FU_C")
FU_OUT = "FU_OUT"

_OPPOSITE = {"N": "S", "S": "N", "E": "W", "W": "E"}


@dataclasses.dataclass(frozen=True)
class Res:
    """One routing resource: (pe row, pe col, port name). pe=(-1,c) denotes
    IMN c (north of row 0); pe=(rows,c) denotes OMN c (south of last row)."""

    r: int
    c: int
    port: str

    def __repr__(self):
        return f"{self.port}({self.r},{self.c})"


@dataclasses.dataclass
class Fabric:
    rows: int = 4
    cols: int = 4
    n_imns: int = 4
    n_omns: int = 4

    def __getstate__(self):
        # drop the routing-resource index memo (``rindex``): it is cheap
        # to rebuild and would otherwise bloat every pickled Mapping
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    def pes(self) -> Iterable[Tuple[int, int]]:
        for r in range(self.rows):
            for c in range(self.cols):
                yield (r, c)

    def pe_index(self, r: int, c: int) -> int:
        return r * self.cols + c

    # -- static connectivity -------------------------------------------------
    def imn_res(self, c: int) -> Res:
        return Res(-1, c, "IMN")

    def omn_res(self, c: int) -> Res:
        return Res(self.rows, c, "OMN")

    def next_hop(self, res: Res) -> Optional[Res]:
        """The unique sink wired to an OUT port / IMN (mesh wiring).

        The otherwise-dangling E/W ports of the border columns are wired as
        two extra vertical rails (Sec. IV-B: 'the CGRA now has n [vertical]
        paths plus two more' using the east and west borders). This is a
        reconstruction decision: without the two rails the fft butterfly of
        Fig. 7b is *provably* unroutable on a 4-wide mesh (min-cut 5 > 4
        column wires — see DESIGN.md §7), so the fabricated design must have
        had this extra border capacity.
        """
        r, c, p = res.r, res.c, res.port
        if p == "IMN":
            return Res(0, c, "IN_N")
        if not p.startswith("OUT_"):
            return None
        d = p[4:]
        if d == "N":
            return Res(r - 1, c, "IN_S") if r > 0 else None
        if d == "S":
            return Res(r + 1, c, "IN_N") if r + 1 < self.rows else \
                (self.omn_res(c) if c < self.n_omns else None)
        if d == "E":
            if c + 1 < self.cols:
                return Res(r, c + 1, "IN_W")
            # east border rail: dangling OUT_E feeds the PE below's IN_E
            return Res(r + 1, c, "IN_E") if r + 1 < self.rows else None
        if d == "W":
            if c - 1 >= 0:
                return Res(r, c - 1, "IN_E")
            # west border rail: dangling OUT_W feeds the PE below's IN_W
            return Res(r + 1, c, "IN_W") if r + 1 < self.rows else None
        return None

    def fanout(self, res: Res) -> List[Res]:
        """Resources reachable from ``res`` inside the same PE (fork/mux legs)
        or across the mesh (for OUT ports / IMN)."""
        r, c, p = res.r, res.c, res.port
        if p == "IMN" or p.startswith("OUT_"):
            nxt = self.next_hop(res)
            return [nxt] if nxt is not None else []
        if p.startswith("IN_"):
            side = p[3:]
            legs = [Res(r, c, fi) for fi in FU_INS]
            legs += [Res(r, c, f"OUT_{d}") for d in "NESW" if d != side]
            return legs
        if p in FU_INS:
            return [Res(r, c, FU_OUT)]
        if p == FU_OUT:
            # cardinal outputs + same-PE non-immediate feedback into the FU
            # data inputs (Fig. 3: dout_FU through an Elastic Buffer); the
            # control input never takes feedback (Sec. III-C).
            return ([Res(r, c, f"OUT_{d}") for d in "NESW"]
                    + [Res(r, c, "FU_A"), Res(r, c, "FU_B")])
        return []

    def rindex(self) -> "FabricIndex":
        """Cached integer index of this fabric's routing-resource graph.

        The negotiated router runs thousands of Dijkstra expansions per
        mapping; hashing frozen ``Res`` dataclasses dominated that cost.
        The index enumerates every resource once, assigns dense
        integer ids, and precomputes ``fanout`` as id adjacency lists, so
        the router's hot loop touches only ints and flat lists.
        """
        idx = self.__dict__.get("_rindex")
        if idx is None or idx.geometry != (self.rows, self.cols,
                                           self.n_imns, self.n_omns):
            idx = FabricIndex(self)
            self.__dict__["_rindex"] = idx
        return idx

    def hop_latency(self, res: Res) -> int:
        """Forward latency contributed by traversing ``res`` (cycles).

        Per Sec. III-C the PE output valid/ready FF was removed (0 cycles) and
        PE input Elastic Buffers register once (1 cycle); the FU datapath is
        registered (1 cycle, charged at firing). IMN/OMN bus beats take their
        cycle in the bank arbiter.
        """
        if res.port.startswith("IN_") or res.port in FU_INS:
            return 1
        return 0


class FabricIndex:
    """Dense-integer view of a fabric's routing resources.

    ``res_of[i]`` / ``id_of[res]`` translate between ids and ``Res``;
    ``fanout_ids[i]`` mirrors ``Fabric.fanout`` exactly (same order), and
    the ``is_*`` flags precompute the router's per-port skip tests.
    """

    def __init__(self, fabric: Fabric):
        self.geometry = (fabric.rows, fabric.cols, fabric.n_imns,
                         fabric.n_omns)
        res_list: List[Res] = []
        for c in range(fabric.n_imns):
            res_list.append(fabric.imn_res(c))
        for c in range(fabric.n_omns):
            res_list.append(fabric.omn_res(c))
        pe_ports = IN_PORTS + OUT_PORTS + tuple(FU_INS) + (FU_OUT,)
        for r in range(fabric.rows):
            for c in range(fabric.cols):
                for p in pe_ports:
                    res_list.append(Res(r, c, p))
        self.res_of: List[Res] = res_list
        self.id_of: Dict[Res, int] = {res: i for i, res in enumerate(res_list)}
        # router's view of fanout: FU_OUT entries are dropped up front (a
        # foreign FU is never traversable, and skipping it consumes no
        # router state), order otherwise preserved
        self.fanout_ids: List[List[int]] = [
            [self.id_of[n] for n in fabric.fanout(res) if n.port != FU_OUT]
            for res in res_list]
        # terminals may only be entered when they are the sink being routed
        self.is_terminal: List[bool] = [res.port in FU_INS or
                                        res.port == "OMN"
                                        for res in res_list]
