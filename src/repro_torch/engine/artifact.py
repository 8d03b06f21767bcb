"""CompiledArtifact — the serializable unit the execution engine runs.

One artifact bundles everything a fabric execution needs, so the whole
compile pipeline (trace -> lower -> partition -> place & route -> config
emission) runs at most once per (kernel, geometry, backend) and the result
can round-trip through a persistent cache (``engine/cache.py``):

  * the lowered DFG and its backend plan — a ``frontend.partition.Plan``,
    which is single-shot (one mapped sub-DFG) or multi-shot (an ordered
    shot sequence with stream bindings);
  * every shot's ``Mapping`` (place & route result on the target
    ``Fabric`` geometry);
  * the packed per-shot ISA configuration word streams (Sec. V-B bus
    format, five 32-bit words per active PE);
  * the config class — the batching key: requests whose artifacts share a
    config class can run back-to-back on the fabric paying only stream
    re-arm, not a full reconfiguration (the paper's multi-shot
    amortization, Sec. IV-B).

Artifacts are plain pickles of dataclass trees (DFG / Mapping / Fabric are
all dataclasses); ``SCHEMA_VERSION`` participates in every cache digest so
stale on-disk artifacts from older layouts are never resurrected.
"""
from __future__ import annotations

import dataclasses
import math
import pickle
from typing import Dict, List, Optional, Tuple

from repro_torch.core import dfg as D
from repro_torch.core.elastic_sim import TimingTrace
from repro_torch.core.mapper import Mapping
from repro_torch.core.multishot import rearm_cycles

# Bump whenever the artifact layout or any compile-pipeline semantics
# change; the version is hashed into cache keys, so old entries miss.
# v2: Edge.init became Optional (None = recirculation edge of a
#     data-dependent loop) and the frontend lowers while/fori/scan.
# v3: artifacts carry TimingTraces — per (shot key, length, layout, bank
#     count) cycle schedules recorded once for static-rate shots and
#     replayed on every later dispatch (timing/value decoupling).
# v4: artifacts carry their required capability feature set (``features``,
#     see engine/capabilities.py) so every dispatch layer validates against
#     the declared per-backend capability matrix instead of ad-hoc
#     ``backend == "pallas"`` special cases.
# v5: cache digests key on mapper identity + P&R seed and artifacts carry
#     ``mapper`` ("greedy" | "anneal", core/opt_mapper.py) — greedy and
#     annealed compilations of the same kernel must never alias on disk.
SCHEMA_VERSION = 5

# key of one recorded trace: (shot/config key, length, layout, n_banks)
TraceKey = Tuple[str, int, Tuple[int, ...], int]

Geometry = Tuple[int, int, int, int]          # (rows, cols, n_imns, n_omns)


class ArtifactError(RuntimeError):
    pass


@dataclasses.dataclass
class CompiledArtifact:
    """A compiled, mapped, config-emitted kernel ready for ``Engine.run``."""

    name: str
    key: str                                  # full cache digest
    backend: str                              # "sim" | "cuda"
    geometry: Geometry
    plan: "object"                            # frontend.partition.Plan
    config_words: Dict[str, List[int]]        # shot key -> packed 32-bit words
    config_class: str                         # batching key
    length: Optional[int] = None              # traced kernels fix the length
    element_mode: bool = False                # traced per-element (lax.cond)
    out_shapes: Optional[List[Tuple[int, ...]]] = None
    # value-independent cycle schedules of static-rate shots, recorded on
    # first execution and replayed ever after (persisted with the artifact)
    timing_traces: Dict[TraceKey, TimingTrace] = \
        dataclasses.field(default_factory=dict)
    # capability features this kernel requires of its execution substrate
    # (sorted flags from engine/capabilities.py, computed at compile time)
    features: Tuple[str, ...] = ()
    # which place & route produced the plan's mappings ("greedy" | "anneal")
    mapper: str = "greedy"
    schema: int = SCHEMA_VERSION

    # -- structure ---------------------------------------------------------
    @property
    def dfg(self) -> D.DFG:
        return self.plan.dfg

    @property
    def n_shots(self) -> int:
        return self.plan.n_shots

    @property
    def mapping(self) -> Mapping:
        if self.n_shots != 1:
            raise ArtifactError(f"{self.name}: multi-shot artifact has no "
                                f"single mapping")
        return self.plan.shots[0].mapping

    def total_config_words(self) -> int:
        return sum(len(w) for w in self.config_words.values())

    def trace_for(self, key: str, length: Optional[int] = None
                  ) -> Optional[TimingTrace]:
        """The recorded timing trace of shot/config-class ``key`` (first
        match when ``length`` is None — artifacts usually carry one trace
        per shot). Consumers: the fabric profiler attributes per-PE
        occupancy from exactly these firing counts (``repro_torch.obs``)."""
        for (k, tlen, _layout, _banks), tr in self.timing_traces.items():
            if k == key and (length is None or tlen == length):
                return tr
        return None

    def config_cycles(self) -> int:
        """Full-reconfiguration cost: config fetch for every shot class."""
        return sum(s.mapping.config_cycles() for s in self.plan.shots)

    # -- cost model --------------------------------------------------------
    def estimated_ii(self, n_banks: int = 4) -> float:
        """Static initiation-interval estimate (cycles/element), the max
        over the plan's shots."""
        return max(estimate_ii(s.dfg, n_banks) for s in self.plan.shots)

    def model_cycles(self, length: int, n_banks: int = 4) -> int:
        """Model-based execution estimate for a stream of ``length``:
        per shot, configuration fetch + stream re-arm + II x length. Used
        where no cycle-accurate measurement exists (the cuda backend)."""
        total = 0
        for shot in self.plan.shots:
            ii = estimate_ii(shot.dfg, n_banks)
            streams = len(shot.inputs) + len(shot.outputs)
            total += (shot.mapping.config_cycles() + rearm_cycles(streams)
                      + math.ceil(ii * length))
        return total

    # -- serialization -----------------------------------------------------
    def to_bytes(self) -> bytes:
        return pickle.dumps(self, protocol=pickle.HIGHEST_PROTOCOL)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "CompiledArtifact":
        art = pickle.loads(blob)
        if not isinstance(art, cls):
            raise ArtifactError(f"not a CompiledArtifact: {type(art)!r}")
        if art.schema != SCHEMA_VERSION:
            raise ArtifactError(f"artifact schema {art.schema} != "
                                f"{SCHEMA_VERSION}")
        return art

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.to_bytes())

    @classmethod
    def load(cls, path: str) -> "CompiledArtifact":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())


def estimate_ii(g: D.DFG, n_banks: int = 4) -> float:
    """Static II model of one shot DFG on the interleaved-bank bus.

    Two steady-state bottlenecks bound the element rate:
      * memory: each bank serves one beat per cycle, so ``ceil(full-rate
        streams / n_banks)`` cycles per element set (fft: 8 streams on 4
        banks -> 2, matching the measured 1.95);
      * loop-carried feedback: a back-edge cycle of k registered FUs can
        only accept a new element every k cycles (dither: 4-FU loop ->
        II = 4, Sec. VII-B). Immediate-feedback accumulators pipeline at
        II = 1 and impose no loop bound.
    """
    full_rate_outs = 0
    for name in g.outputs:
        if g.nodes[name].emit_every == 0:
            continue                      # last-value OMN (stride-0 store)
        e = g.operand(name, "a")
        producer = g.nodes[e.src]
        if not (producer.is_reduction() and producer.emit_every != 1):
            full_rate_outs += 1
    streams = len(g.inputs) + full_rate_outs
    ii_mem = math.ceil(streams / n_banks) if streams else 1

    ii_loop = 1
    funcs = {n for n, nd in g.nodes.items()
             if nd.kind in (D.ALU, D.CMP, D.MUX, D.BRANCH, D.MERGE)}
    fwd: Dict[str, List[str]] = {n: [] for n in funcs}
    rev: Dict[str, List[str]] = {n: [] for n in funcs}
    for e in g.edges:
        if not e.back and e.src in funcs and e.dst in funcs:
            fwd[e.src].append(e.dst)
            rev[e.dst].append(e.src)

    def _reach(start: str, adj: Dict[str, List[str]]) -> set:
        seen, stack = {start}, [start]
        while stack:
            for nxt in adj[stack.pop()]:
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return seen

    for e in g.back_edges():
        if e.src not in funcs or e.dst not in funcs:
            continue
        body = _reach(e.dst, fwd) & _reach(e.src, rev)
        body.update((e.src, e.dst))
        ii_loop = max(ii_loop, len(body))
    return float(max(1, ii_mem, ii_loop))
