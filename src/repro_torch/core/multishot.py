"""Multi-shot kernel planner & runner (mapping strategy 3, Sec. IV-B).

A multi-shot application is a sequence of *shots*: each shot is one fabric
execution of a small kernel, with the CPU re-arming stream parameters in
between (and reconfiguring PEs when the kernel — or a folded constant —
changes). The runners below implement the paper's Table II benchmarks:

  mm      — three dot-products per shot (Fig. 7c), rows x col-triples
  conv2d  — 3 shots, one per 3x3 filter row, partial sums memory-resident
  gemm    — mm shots + axpby epilogue (alpha*AB + beta*C)
  gemver  — fused outer-product row shots (consts re-configured per row),
            then A^T y and A x matvec shots with scale/add epilogues
  gesummv — dual-MAC row shots sharing the x stream + axpby epilogue
  2mm/3mm — chained mm phases

Numeric results come from the functional executor per shot (validated
against NumPy in the tests). Timing: every distinct (kernel, length,
stream-layout) class is simulated once cycle-accurately on its real
StreamSpecs (bank strides matter: mm's B-columns hammer single banks,
giving Table II's ~1.9 cycles/element), and identical shots reuse it.

Re-arm cost model (Sec. V-B preamble; fitted to Table II's mm16/mm64):
interrupt sync + MMIO stream writes + partial config-word streaming.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core import kernels_lib as K
from repro_torch.core.dfg import DFG
from repro_torch.core.elastic_sim import SimResult, TimingTrace, simulate
from repro_torch.core.executor import execute
from repro_torch.core.fabric import Fabric
from repro_torch.core.mapper import Mapping, map_dfg
from repro_torch.core.streams import BusConfig, StreamSpec

I32 = np.int32

SYNC_CYCLES = 16
CYCLES_PER_STREAM_WRITE = 14
CYCLES_PER_CONFIG_WORD = 5


def rearm_cycles(streams_changed: int, pe_config_words: int = 0) -> int:
    c = SYNC_CYCLES + CYCLES_PER_STREAM_WRITE * streams_changed
    if pe_config_words:
        c += CYCLES_PER_CONFIG_WORD * pe_config_words + 4
    return c


@dataclasses.dataclass
class Tally:
    """Accumulated offload cost of a multi-shot run."""

    config: int = 0
    rearm: int = 0
    exec: int = 0
    ops: int = 0           # measured FU firings
    shots: int = 0

    @property
    def total(self) -> int:
        return self.config + self.rearm + self.exec

    @property
    def duty(self) -> float:
        return self.exec / max(self.total, 1)

    def merge(self, other: "Tally") -> "Tally":
        return Tally(self.config + other.config, self.rearm + other.rearm,
                     self.exec + other.exec, self.ops + other.ops,
                     self.shots + other.shots)


class ShotRunner:
    """Executes shots functionally and accounts cycle costs, memoizing one
    cycle-level simulation per (kernel-name, length, layout) class.

    ``fabric`` selects the target geometry (rows/cols/IMN/OMN counts) for
    every mapping the runner performs itself; pre-seeded mappings keep the
    geometry they were produced with. ``bus`` sets the interleaved-bank
    count used for shot stream layouts.

    ``value_fn`` selects the *value substrate*: the callable producing a
    shot's numeric outputs (default: the functional executor). The pallas
    backend passes its fused-kernel dispatcher here, so multi-shot plans
    chain per-shot pallas kernels through the same IMN/OMN buffer handoff
    — while cycle accounting keeps flowing through the memoized timing
    simulation (timing/value decoupling, across backends).
    """

    def __init__(self, with_timing: bool = True,
                 fabric: Optional[Fabric] = None,
                 bus: Optional[BusConfig] = None,
                 value_fn: Optional[Callable] = None):
        self.with_timing = with_timing
        self.fabric = fabric or Fabric()
        self.bus = bus or BusConfig()
        self.value_fn = value_fn or execute
        self.tally = Tally()
        self._mappings: Dict[str, Mapping] = {}
        self._sims: Dict[Tuple, SimResult] = {}
        # timing traces: (cfg key, length, layout, n_banks) -> TimingTrace;
        # seeded from artifacts, recorded after fresh static-rate sims
        self._traces: Dict[Tuple, TimingTrace] = {}
        self._fresh_traces: Dict[Tuple, TimingTrace] = {}
        self._current_kernel: Optional[str] = None

    def mapping(self, key: str, g: DFG) -> Mapping:
        if key not in self._mappings:
            self._mappings[key] = map_dfg(g, self.fabric, restarts=300)
        return self._mappings[key]

    @property
    def current_config_class(self) -> Optional[str]:
        """Config class the fabric currently holds (None = unconfigured)."""
        return self._current_kernel

    def invalidate_config(self) -> None:
        """Forget the fabric's configuration state. Models independent
        per-request dispatch: between isolated requests the fabric cannot be
        assumed to still hold the caller's configuration, so the next shot
        pays a full configuration fetch."""
        self._current_kernel = None

    def seed_mapping(self, key: str, m: Mapping) -> None:
        """Pre-register a place-and-route result for a config class (e.g.
        computed at compile time by the frontend partitioner) so runs reuse
        it instead of re-mapping."""
        self._mappings.setdefault(key, m)

    def seed_trace(self, key: str, length: int, layout: Tuple[int, ...],
                   trace: TimingTrace) -> None:
        """Pre-register a recorded timing trace (e.g. carried inside a
        ``CompiledArtifact``) so a static-rate shot replays it instead of
        re-simulating — the repeat-dispatch path becomes O(length) NumPy."""
        self._traces.setdefault((key, length, tuple(layout), trace.n_banks),
                                trace)

    def fresh_traces(self) -> Dict[Tuple, TimingTrace]:
        """Traces recorded by this runner since the last harvest; the
        engine persists them back into the owning artifact. Clears the
        fresh set."""
        out, self._fresh_traces = self._fresh_traces, {}
        return out

    def run_shot(self, key: str, g: DFG,
                 inputs: Dict[str, np.ndarray],
                 streams_changed: int,
                 pe_config_words: int = 0,
                 layout: Tuple[int, ...] = (),
                 config_class: Optional[str] = None,
                 outs: Optional[Dict[str, np.ndarray]] = None
                 ) -> Dict[str, np.ndarray]:
        """config_class: kernels sharing a configuration family (e.g. gemver
        rows differ only in folded constants) avoid full config re-fetch.

        ``outs``: pre-computed shot values (e.g. one lane of a batched
        pallas grid) — cycle accounting still runs, value computation is
        skipped."""
        with obs.span("shot", key=key,
                      config_class=config_class or key) as sp:
            if outs is None:
                with obs.span("shot.values", key=key):
                    outs = self.value_fn(g, inputs)
            if not self.with_timing:
                return outs
            cfg_key = config_class or key
            m = self.mapping(cfg_key, g)
            if self._current_kernel != cfg_key:
                self.tally.config += m.config_cycles()
                self._current_kernel = cfg_key
                obs.inc("shot.config_fetches")
            (length,) = {v.shape[0] for v in inputs.values()}
            sig = (cfg_key, length, layout)
            if sig not in self._sims:
                tkey = (cfg_key, length, tuple(layout), self.bus.n_banks)
                trace = self._traces.get(tkey)
                if trace is not None and g.is_static_rate():
                    # timing/value decoupling: the cycle schedule of a
                    # static-rate DFG is value-independent, so replay the
                    # recorded trace and take the values from the functional
                    # executor — no simulation on the repeat-dispatch path
                    with obs.span("shot.trace_replay", key=cfg_key):
                        self._sims[sig] = trace.replay(outs)
                    obs.inc("shot.trace_replays")
                else:
                    sin, sout = _shot_streams(g, length, layout,
                                              self.bus.n_banks)
                    with obs.span("shot.simulate", key=cfg_key,
                                  length=length):
                        sim = simulate(m, inputs, streams_in=sin,
                                       streams_out=sout, bus=self.bus)
                    obs.inc("shot.fresh_sims")
                    self._sims[sig] = sim
                    if g.is_static_rate():
                        trace = TimingTrace.from_sim(sim, length,
                                                     tuple(layout),
                                                     self.bus.n_banks)
                        self._traces[tkey] = trace
                        self._fresh_traces[tkey] = trace
                        obs.inc("shot.traces_recorded")
            else:
                obs.inc("shot.sim_memo_hits")
            sim = self._sims[sig]
            self.tally.exec += sim.cycles
            self.tally.rearm += rearm_cycles(streams_changed,
                                             pe_config_words)
            self.tally.ops += sum(sim.fu_firings.values())
            self.tally.shots += 1
            sp.set(cycles=sim.cycles, length=length)
            return outs

    def rep_sims(self) -> Dict[Tuple, SimResult]:
        return dict(self._sims)

    def mappings(self) -> Dict[str, Mapping]:
        return dict(self._mappings)


def _shot_streams(g: DFG, length: int, layout: Tuple[int, ...],
                  n_banks: int = 4):
    """StreamSpecs matching the shot's real bank behaviour. ``layout`` holds
    per-(inputs+outputs) stride residues mod the bank count; residue 0 =
    single-bank stream (stride multiple of the bank count, e.g. a matrix
    column)."""
    names = list(g.inputs) + list(g.outputs)
    if not layout:
        layout = tuple([1] * len(names))
    sin, sout = {}, {}
    for i, name in enumerate(names):
        res = layout[i] if i < len(layout) else 1
        stride = n_banks if res == 0 else res
        spec = StreamSpec(base=i % n_banks, size=length, stride=stride)
        (sin if name in g.inputs else sout)[name] = spec
    return sin, sout


# ---------------------------------------------------------------------------
# Table II benchmark runners
# ---------------------------------------------------------------------------

def run_mm(A: np.ndarray, B: np.ndarray, out: np.ndarray,
           runner: Optional[ShotRunner] = None,
           with_timing: bool = True) -> Tally:
    """C = A @ B via mac3 shots (Fig. 7c)."""
    r = runner or ShotRunner(with_timing)
    M, Kd = A.shape
    _, N = B.shape
    Np = math.ceil(N / 3) * 3
    Bp = np.zeros((Kd, Np), dtype=I32)
    Bp[:, :N] = B
    g = K.mac3(Kd)
    key = f"mac3_{Kd}"
    for i in range(M):
        for j in range(0, Np, 3):
            outs = r.run_shot(key, g,
                              {"a": A[i].astype(I32),
                               "b0": Bp[:, j].astype(I32),
                               "b1": Bp[:, j + 1].astype(I32),
                               "b2": Bp[:, j + 2].astype(I32)},
                              streams_changed=6,
                              layout=(1, 0, 0, 0, 0, 0, 0))
            for t in range(3):
                if j + t < N:
                    out[i, j + t] = outs[f"out{t}"][0]
    return r.tally


def run_conv2d(img: np.ndarray, kern: np.ndarray, out: np.ndarray,
               runner: Optional[ShotRunner] = None,
               with_timing: bool = True) -> Tally:
    """3x3 'valid' convolution in exactly 3 shots (partial sums in memory)."""
    r = runner or ShotRunner(with_timing)
    H, W = img.shape
    L = (H - 2) * W
    flat = np.zeros(H * W + 2, dtype=np.int64)
    flat[:H * W] = img.reshape(-1)
    partial = np.zeros(L, dtype=I32)
    for row in range(3):
        k0, k1, k2 = (int(v) for v in kern[row])
        ins = {f"x{t}": flat[row * W + t: row * W + t + L].astype(I32)
               for t in range(3)}
        if row == 0:
            g = K.conv2d_row3(k0, k1, k2)
            outs = r.run_shot(f"convrow3_{k0}_{k1}_{k2}", g, ins,
                              streams_changed=4, layout=(1, 1, 1, 1))
        else:
            g = K.conv2d_row(k0, k1, k2)
            ins["pin"] = partial
            outs = r.run_shot(f"convrow_{k0}_{k1}_{k2}", g, ins,
                              streams_changed=5, layout=(1, 1, 1, 1, 1))
        partial = outs["pout"].astype(I32)
    plane = partial.reshape(H - 2, W)
    out[:, :] = plane[:, :W - 2]
    return r.tally


def run_axpby(alpha: int, x: np.ndarray, beta: int, y: np.ndarray,
              out: np.ndarray, runner: ShotRunner) -> None:
    """out = alpha*x + beta*y, one-shot elementwise epilogue."""
    g = K.axpby(alpha, beta)
    outs = runner.run_shot(f"axpby_{alpha}_{beta}", g,
                           {"x": x.astype(I32), "y": y.astype(I32)},
                           streams_changed=3, layout=(1, 1, 1))
    out[:] = outs["out"]


def _engine_for(runner: ShotRunner):
    """Engine sharing this runner's tally/mappings (lazy import: the engine
    package layers above core)."""
    from repro_torch.engine.scheduler import Engine
    return Engine(runner=runner)


def run_gemm(alpha: int, A: np.ndarray, B: np.ndarray, beta: int,
             C: np.ndarray, with_timing: bool = True,
             runner: Optional[ShotRunner] = None) -> Tally:
    """C = alpha*A@B + beta*C (PolyBench gemm). Engine client — see
    ``repro_torch.engine.clients``."""
    from repro_torch.engine import clients
    r = runner or ShotRunner(with_timing)
    return clients.run_gemm(_engine_for(r), alpha, A, B, beta, C)


def run_gesummv(alpha: int, beta: int, A: np.ndarray, B: np.ndarray,
                x: np.ndarray, y: np.ndarray, with_timing: bool = True,
                runner: Optional[ShotRunner] = None) -> Tally:
    """y = alpha*A@x + beta*B@x (dual-MAC row shots share the x stream).
    Engine client — see ``repro_torch.engine.clients``."""
    from repro_torch.engine import clients
    r = runner or ShotRunner(with_timing)
    return clients.run_gesummv(_engine_for(r), alpha, beta, A, B, x, y)


def run_gemver(alpha: int, beta: int, A: np.ndarray,
               u1: np.ndarray, v1: np.ndarray, u2: np.ndarray,
               v2: np.ndarray, w: np.ndarray, x: np.ndarray,
               y: np.ndarray, z: np.ndarray, with_timing: bool = True,
               runner: Optional[ShotRunner] = None) -> Tally:
    """PolyBench gemver: A' = A + u1 v1^T + u2 v2^T ;
    x = beta*A'^T y + z ; w = alpha*A' x.

    Decomposition uses fabric-level unrolling (the only way to land in the
    paper's 39.8k-cycle budget — see DESIGN.md): phase 1 fuses two rows per
    shot sharing the v1/v2 streams (u*_i folded as constants, re-configured
    per shot); phases 2/3 are mac3 shots sharing the y/x stream across three
    columns/rows at a time.
    """
    r = runner or ShotRunner(with_timing)
    N = A.shape[0]
    Ap = np.zeros_like(A, dtype=I32)
    # phase 1: two fused outer-product rows per shot
    for i in range(0, N, 2):
        i1 = min(i + 1, N - 1)
        g = K.outer_row2(int(u1[i]), int(u2[i]), int(u1[i1]), int(u2[i1]))
        outs = r.run_shot("outer_row2", g,
                          {"a0": A[i].astype(I32), "a1": A[i1].astype(I32),
                           "v1": v1.astype(I32), "v2": v2.astype(I32)},
                          streams_changed=4, pe_config_words=20,
                          layout=(1, 1, 1, 1, 1, 1),
                          config_class="outer_row2")
        Ap[i], Ap[i1] = outs["out0"], outs["out1"]
    # phase 2: x = beta * (A'^T y) + z — three columns per mac3 shot
    d = _matvec_mac3(r, np.ascontiguousarray(Ap.T), y, col_layout=True)
    gsa = K.scale_add(beta)
    outs = r.run_shot(f"scale_add_{beta}", gsa,
                      {"x": d, "y": z.astype(I32)}, streams_changed=3)
    xnew = outs["out"].astype(I32)
    x[:] = xnew
    # phase 3: w = alpha * (A' x) — three rows per mac3 shot
    d = _matvec_mac3(r, Ap, xnew, col_layout=False)
    gs = K.scale(alpha)
    outs = r.run_shot(f"scale_{alpha}", gs, {"x": d}, streams_changed=2)
    w[:] = outs["out"]
    A[:, :] = Ap
    return r.tally


def _matvec_mac3(r: ShotRunner, M: np.ndarray, v: np.ndarray,
                 col_layout: bool) -> np.ndarray:
    """d = M @ v using mac3 shots: the vector stream is shared across three
    simultaneous row dot-products (same structure as Fig. 7c)."""
    n_rows, n_cols = M.shape
    d = np.zeros(n_rows, dtype=I32)
    g = K.mac3(n_cols)
    vv = v.astype(I32)
    res = 0 if col_layout else 1      # columns of the original are stride-N
    for i in range(0, n_rows, 3):
        rows = [min(i + t, n_rows - 1) for t in range(3)]
        outs = r.run_shot(f"mac3_{n_cols}", g,
                          {"a": vv, "b0": M[rows[0]].astype(I32),
                           "b1": M[rows[1]].astype(I32),
                           "b2": M[rows[2]].astype(I32)},
                          streams_changed=6,
                          layout=(1, res, res, res, 0, 0, 0))
        for t in range(3):
            if i + t < n_rows:
                d[i + t] = outs[f"out{t}"][0]
    return d


def run_2mm(alpha: int, beta: int, A, B, C, D, with_timing=True,
            runner: Optional[ShotRunner] = None) -> Tally:
    """D = alpha*A@B@C + beta*D (PolyBench 2mm). Engine client — see
    ``repro_torch.engine.clients``."""
    from repro_torch.engine import clients
    r = runner or ShotRunner(with_timing)
    return clients.run_2mm(_engine_for(r), alpha, beta, A, B, C, D)


def run_3mm(A, B, C, D, with_timing=True,
            runner: Optional[ShotRunner] = None) -> Tuple[Tally, np.ndarray]:
    """G = (A@B) @ (C@D) (PolyBench 3mm)."""
    r = runner or ShotRunner(with_timing)
    NI, NJ = A.shape[0], B.shape[1]
    NL = D.shape[1]
    E = np.zeros((NI, NJ), dtype=I32)
    run_mm(A, B, E, runner=r)
    F = np.zeros((B.shape[1], NL), dtype=I32)  # (NJ x NL) = C@D
    run_mm(C, D, F, runner=r)
    G = np.zeros((NI, NL), dtype=I32)
    run_mm(E, F, G, runner=r)
    return r.tally, G


# algorithmic op counts (paper conventions, Sec. VII-B)
def ops_mm(n: int) -> int:
    return 2 * n ** 3 - n ** 2


def ops_conv2d(h: int, w: int) -> int:
    return (h - 2) * (w - 2) * 17
