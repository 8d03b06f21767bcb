"""The port's paper layer: ``core/paper_data``, ``paper_mappings``,
``soc``, ``energy``, ``obs/profiler`` and ``obs/report``.

The cases of ``tests/test_paper_golden.py``, ``tests/test_energy.py`` and
the profiler/report cases of ``tests/test_obs.py`` on the port's copies,
plus their parity with the reference: the same published tables, the same
mappings and the same profiles of the paper kernels.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
    settings.register_profile("ci", deadline=None, derandomize=True,
                              max_examples=60)
    settings.register_profile("dev", deadline=None, max_examples=25)
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "dev"))
except ModuleNotFoundError:
    from hypothesis_stub import given, settings, st

from repro_torch import obs
from repro_torch.core import kernels_lib as K
from repro_torch.core import paper_data as PD
from repro_torch.core.elastic_sim import TimingTrace, simulate
from repro_torch.core.energy import (PowerFeatures, PowerModel, energy_uj,
                                     features_from_profile,
                                     features_from_sim)
from repro_torch.core.isa import config_cycles
from repro_torch.core.mapper import map_dfg
from repro_torch.core.paper_mappings import paper_mapping
from repro_torch.obs.profiler import profile_sim, profile_trace


@pytest.fixture(autouse=True)
def _obs_off_after():
    """Every test leaves the process in the disabled default."""
    yield
    obs.disable()


# ---------------------------------------------------------------------------
# golden paper pins (tests/test_paper_golden.py)
# ---------------------------------------------------------------------------

def _sim(name, inputs):
    return simulate(paper_mapping(name), inputs)


@pytest.fixture(scope="module")
def fft_sim():
    rng = np.random.default_rng(0)
    m = paper_mapping("fft")
    ins = {k: rng.integers(-4096, 4096, 256).astype(np.int32)
           for k in m.dfg.inputs}          # 4 streams x 256 = 1024 elements
    return simulate(m, ins)


def test_fft_outputs_per_cycle_pin(fft_sim):
    """Paper Table I: fft streams 1.95 outputs/cycle; the model: 2.0."""
    paper = PD.TABLE_I["fft"][3]
    assert fft_sim.outputs_per_cycle() == 2.0
    assert abs(fft_sim.outputs_per_cycle() - paper) / paper < 0.03


def test_fft_exec_cycles_pin(fft_sim):
    """Paper Table I: 523 execution cycles for 1024 elements; model: 512."""
    paper = PD.TABLE_I["fft"][1]
    assert fft_sim.cycles == 512
    assert abs(fft_sim.cycles - paper) / paper < 0.03


def test_fft_config_cycles_pin():
    """Paper Table I: 84 configuration cycles (16 PEs x 5 words + launch)."""
    m = paper_mapping("fft")
    assert m.config_cycles() == PD.TABLE_I["fft"][0] == 84
    assert config_cycles(16) == 84 and config_cycles(14) == 74


def test_dither_ii_pin():
    """Paper Sec. VII-B: dither's 4-FU feedback loop gives exactly II=4."""
    rng = np.random.default_rng(0)
    s = _sim("dither", {"x": rng.integers(0, 256, 1024).astype(np.int32)})
    assert s.steady_ii() == 4.0
    assert s.cycles == 4097


def test_dither_c2_cycles_pin():
    """Paper Table I: 4617 cycles for the x2-unrolled dither; model: 4097."""
    rng = np.random.default_rng(0)
    m = paper_mapping("dither_c2")
    ins = {k: rng.integers(0, 256, 512).astype(np.int32) for k in m.dfg.inputs}
    s = simulate(m, ins)
    paper = PD.TABLE_I["dither"][1]
    assert s.cycles == 4097
    assert abs(s.cycles - paper) / paper < 0.15


def test_find2min_ii_pin():
    """find2min (irregular loop): the mux form sustains II=2, 2052 cycles."""
    rng = np.random.default_rng(0)
    s = _sim("find2min", {"x": rng.integers(0, 10**6, 1024).astype(np.int32)})
    assert s.steady_ii() == 2.0
    assert s.cycles == 2052
    paper_opc = PD.TABLE_I["find2min"][3]
    assert s.outputs_per_cycle() == pytest.approx(4 / 2052)
    assert abs(s.outputs_per_cycle() - paper_opc) / paper_opc < 3.6


def test_find2min_brmg_ii_pin():
    """The Branch/Merge recirculation form of find2min runs at II=3."""
    rng = np.random.default_rng(0)
    s = _sim("find2min_brmg",
             {"x": rng.integers(0, 10**6, 1024).astype(np.int32)})
    assert s.steady_ii() == 3.0
    assert s.cycles == 3077


# ---------------------------------------------------------------------------
# the power/energy model (tests/test_energy.py)
# ---------------------------------------------------------------------------

erng = np.random.default_rng(11)


@pytest.fixture(scope="module")
def paper_samples():
    """(kernel name, mapping, sim, PowerFeatures) for each Table I kernel,
    simulated at a reduced stream length."""
    out = []
    for name, maker in K.ONE_SHOT.items():
        g = maker()
        m = map_dfg(g, restarts=300, seed=3)
        lo, hi = (0, 255) if name == "dither" else (-100, 100)
        ins = {k: erng.integers(lo, hi, 128).astype(np.int32)
               for k in g.inputs}
        sim = simulate(m, ins)
        t1 = PD.TABLE_I[name]
        out.append((name, m, sim,
                    features_from_sim(m, sim, 1.0, t1[5], t1[11])))
    return out


@pytest.fixture(scope="module")
def fitted(paper_samples):
    pm = PowerModel()
    pm.fit([f for _, _, _, f in paper_samples])
    return pm


def test_features_from_sim_are_physical(paper_samples):
    for name, m, sim, f in paper_samples:
        assert 0.0 <= f.duty <= 1.0, name
        assert f.arith_act >= 0 and f.ctrl_act >= 0, name
        assert f.route_pes >= 0, name
        assert f.mem_rate > 0, name
        assert f.arith_act + f.ctrl_act <= len(m.dfg.nodes), name
    by_name = {name: f for name, _, _, f in paper_samples}
    assert by_name["fft"].arith_act > by_name["relu"].arith_act
    assert by_name["find2min"].ctrl_act > 0


def test_features_row_matches_model_structure():
    f = PowerFeatures(duty=0.5, arith_act=2.0, ctrl_act=1.0, route_pes=4.0,
                      mem_rate=0.25)
    assert f.row() == [0.5, 2.0, 1.0, 4.0 * 0.5, 0.25, 1.0]
    assert dataclasses.replace(f, duty=0.0).row()[3] == 0.0


def test_features_from_sim_delegates_through_profiler(paper_samples):
    """``features_from_sim`` goes through the fabric profiler and
    reproduces the direct formula exactly."""
    from repro_torch.core import dfg as D

    for name, m, sim, f in paper_samples:
        g = m.dfg
        cycles = max(sim.cycles, 1)
        arith = sum(cnt for n, cnt in sim.fu_firings.items()
                    if g.nodes[n].kind == D.ALU) / cycles
        ctrl = sum(cnt for n, cnt in sim.fu_firings.items()
                   if g.nodes[n].kind != D.ALU) / cycles
        assert f.arith_act == arith, name
        assert f.ctrl_act == ctrl, name
        assert f.route_pes == m.n_active_pes() - len(m.place), name
        assert f.mem_rate == sim.bank_beats / cycles, name
        p = profile_sim(m, sim)
        assert p.pe_firings == sum(sim.fu_firings.values()), name
        assert features_from_profile(p, 1.0, f.cgra_mw_paper,
                                     f.soc_mw_paper) == f, name


def test_fit_report_round_trip(fitted, paper_samples):
    rows = fitted.report()
    assert len(rows) == len(paper_samples)
    for row in rows:
        for key in ("cgra_mw_model", "cgra_mw_paper", "cgra_rel_err",
                    "soc_mw_model", "soc_mw_paper", "soc_rel_err"):
            assert np.isfinite(row[key]), key
        assert abs(row["cgra_rel_err"]) < 0.75, row
        assert abs(row["soc_rel_err"]) < 0.75, row
        assert row["cgra_mw_model"] > 0
        assert row["soc_mw_model"] > row["cgra_mw_model"] * fitted.gamma[1] \
            - 1e-9


def test_fit_coefficients_nonnegative(fitted):
    assert fitted.beta is not None and fitted.gamma is not None
    assert np.all(fitted.beta >= 0)
    assert np.all(fitted.gamma >= 0)


def test_predict_requires_fit():
    with pytest.raises(AssertionError):
        PowerModel().cgra_mw(PowerFeatures(1, 1, 1, 0, 0.1))


def test_energy_uj_arithmetic():
    assert energy_uj(10.0, 250_000_000, clock_mhz=250.0) == \
        pytest.approx(1e4)
    assert energy_uj(5.0, 1000) == pytest.approx(energy_uj(10.0, 500))
    assert energy_uj(123.0, 0) == 0.0
    assert energy_uj(8.0, 4096, clock_mhz=500.0) == \
        pytest.approx(energy_uj(8.0, 4096, clock_mhz=250.0) / 2)


def test_cpu_energy_comparison_reproduces_table_i_esave():
    """Table I's energy-saving column: fft/relu/dither save energy,
    find2min does not (esave 0.70), within the paper's rounding."""
    for name, t1 in PD.TABLE_I.items():
        cgra = energy_uj(t1[5], t1[0] + t1[1])
        cpu = energy_uj(t1[8], t1[7])
        esave = cpu / cgra
        assert (esave > 1) == (t1[10] > 1), name
        assert esave == pytest.approx(t1[10], rel=0.3), name


_PM_CACHE = []


def _fitted_for_property():
    if not _PM_CACHE:
        samples = []
        prng = np.random.default_rng(11)
        for name, maker in K.ONE_SHOT.items():
            g = maker()
            m = map_dfg(g, restarts=300, seed=3)
            ins = {k: prng.integers(0, 100, 64).astype(np.int32)
                   for k in g.inputs}
            t1 = PD.TABLE_I[name]
            samples.append(features_from_sim(m, simulate(m, ins), 1.0,
                                             t1[5], t1[11]))
        pm = PowerModel()
        pm.fit(samples)
        _PM_CACHE.append(pm)
    return _PM_CACHE[0]


@given(duty=st.floats(0.0, 1.0), arith=st.floats(0.0, 16.0),
       ctrl=st.floats(0.0, 16.0), route=st.integers(0, 12),
       extra=st.integers(1, 8), mem=st.floats(0.0, 4.0))
@settings(deadline=None)
def test_property_power_nonnegative_and_monotone_in_pes(
        duty, arith, ctrl, route, extra, mem):
    pm = _fitted_for_property()
    f = PowerFeatures(duty=duty, arith_act=arith, ctrl_act=ctrl,
                      route_pes=float(route), mem_rate=mem)
    p = pm.cgra_mw(f)
    assert p >= 0.0
    assert pm.soc_mw(f) >= 0.0
    more = dataclasses.replace(f, route_pes=float(route + extra))
    assert pm.cgra_mw(more) >= p - 1e-12


# ---------------------------------------------------------------------------
# the fabric profiler and the report CLI (tests/test_obs.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["fft", "dither", "find2min"])
def test_profiler_counts_match_timing_trace(name):
    """Per-PE rows sum to the exact firing counts the TimingTrace
    recorded — the profiler is attribution, not estimation."""
    rng = np.random.default_rng(7)
    m = paper_mapping(name)
    g = m.dfg
    lo, hi = (0, 255) if name == "dither" else (-100, 100)
    ins = {k: rng.integers(lo, hi, 64).astype(np.int32) for k in g.inputs}
    sim = simulate(m, ins)
    trace = TimingTrace.from_sim(sim, 64, (), 4)
    p = profile_trace(m, trace, kernel=name)
    assert p.from_trace and p.kernel == name
    assert p.cycles == trace.cycles == sim.cycles
    assert p.length == 64 and p.n_banks == 4
    assert p.bank_beats == trace.bank_beats
    rows = {r.name: r for r in p.rows if r.kind == "pe"}
    assert set(rows) == set(m.place)
    for n, r in rows.items():
        assert r.firings == trace.fu_firings.get(n, 0), n
    assert p.pe_firings == sum(trace.fu_firings.values())
    for r in p.rows:
        if r.kind == "omn":
            assert r.firings == len(trace.arrival_cycles[r.name]), r.name
        if r.kind == "imn":
            assert r.firings == 64
        assert r.occupancy == r.firings / p.cycles
        assert r.bubbles == p.cycles - r.firings
    assert p.ops_per_cycle == p.pe_firings / p.cycles
    ps = profile_sim(m, sim, kernel=name, length=64)
    assert ps.pe_firings == p.pe_firings
    assert ps.bank_beats == p.bank_beats
    table = p.table()
    assert name in table and "bottleneck:" in table
    for r in p.rows:
        assert r.pos in table
    label, occ = p.bottleneck()
    assert 0.0 < occ <= 1.0


def test_profiler_steady_ii_matches_sim():
    rng = np.random.default_rng(7)
    m = paper_mapping("fft")
    ins = {k: rng.integers(-100, 100, 64).astype(np.int32)
           for k in m.dfg.inputs}
    sim = simulate(m, ins)
    p = profile_sim(m, sim, length=64)
    assert p.steady_ii == sim.steady_ii()


def test_report_cli_writes_all_exports(tmp_path, capsys):
    from repro_torch.obs import report

    rc = report.main(["--kernel", "fft", "--kernel", "dither", "--length",
                      "16", "--requests", "2",
                      "--chrome-trace", str(tmp_path / "t.json"),
                      "--metrics", str(tmp_path / "m.prom"),
                      "--jsonl", str(tmp_path / "m.jsonl")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "fft:" in out and "dither:" in out and "bottleneck:" in out
    doc = json.loads((tmp_path / "t.json").read_text())
    assert {e["name"] for e in doc["traceEvents"]} >= \
        {"compile", "pnr", "schedule.flush", "dispatch.sim", "shot"}
    prom = (tmp_path / "m.prom").read_text()
    assert "strela_engine_requests 4" in prom
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert all(json.loads(line)["name"] for line in lines)


# ---------------------------------------------------------------------------
# parity with the reference's paper layer
# ---------------------------------------------------------------------------

def test_paper_tables_equal_the_reference():
    from repro.core import paper_data as RPD
    from repro.core import soc as RSOC

    from repro_torch.core import soc as SOC
    for table in ("TABLE_I", "TABLE_II"):
        assert getattr(PD, table) == getattr(RPD, table)
    assert PD.CLOCK_MHZ == RPD.CLOCK_MHZ
    assert sorted(vars(SOC)) == sorted(vars(RSOC))


@pytest.mark.parametrize("name", ["fft", "relu", "dither", "dither_c2",
                                  "find2min", "find2min_brmg"])
def test_paper_profiles_equal_the_reference(name):
    """Each paper mapping and its profile (rows, firings, cycles, the
    heat-table) are the reference's, so the energy features are too."""
    from repro.core.elastic_sim import simulate as rsimulate
    from repro.core.energy import features_from_sim as rfeatures
    from repro.core.paper_mappings import paper_mapping as rpaper_mapping
    from repro.obs.profiler import profile_sim as rprofile_sim

    m, rm = paper_mapping(name), rpaper_mapping(name)
    assert m.place == rm.place
    assert m.config_cycles() == rm.config_cycles()
    rng = np.random.default_rng(2)
    lo, hi = (0, 255) if name.startswith("dither") else (-100, 100)
    ins = {k: rng.integers(lo, hi, 96).astype(np.int32) for k in m.dfg.inputs}
    p = profile_sim(m, simulate(m, ins), kernel=name, length=96)
    rsim = rsimulate(rm, ins)
    rp = rprofile_sim(rm, rsim, kernel=name, length=96)
    assert p.table() == rp.table()
    assert [(r.name, r.kind, r.firings) for r in p.rows] == \
        [(r.name, r.kind, r.firings) for r in rp.rows]
    assert (p.cycles, p.pe_firings, p.bank_beats, p.steady_ii) == \
        (rp.cycles, rp.pe_firings, rp.bank_beats, rp.steady_ii)
    assert dataclasses.astuple(features_from_sim(m, simulate(m, ins))) == \
        dataclasses.astuple(rfeatures(rm, rsim))
