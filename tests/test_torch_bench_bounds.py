"""The kernel bench's bounds, on the CPU with no card and no build
(``repro_torch.bench_kernels``): importing it loads no kernel; each bound
function reads the H100's peaks from ``roofline.analysis`` at call time and
gives the figure ``PERF.md`` §6 quotes for its row; no other module of the
port, nor a script at the root, writes a peak of its own; run as a script
with another tree's ``--src``, it keeps its own tree's peaks; ``--only``
takes the path run and every case and nothing else; :func:`counts` reads
every kernel's launch counter."""
import os
import re
import subprocess
import sys

import pytest

from repro_torch import bench_kernels as bk
from repro_torch.core import kernels_lib as K
from repro_torch.roofline import analysis as RA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_4K = (36, 4096, 4096, 64, True)    # minicpm-2b.train-4k's attention
MINICPM_PARAMS = 2_725_173_504           # minicpm-2b's parameters


def test_importing_the_bench_loads_no_kernel():
    code = ("import sys, repro_torch.bench_kernels\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.startswith('repro_torch.kernels')))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_a_product_at_train_4k():
    """The causal mask allows s (s + 1) / 2 pairs a head: 38.66 GFLOP a
    product of 2 d flop a pair."""
    pairs = bk.allowed_pairs(*TRAIN_4K[:3], True)
    assert pairs == 36 * 4096 * 4097 // 2
    assert 2 * 64 * pairs == 38_664_142_848
    assert bk.allowed_pairs(36, 4096, 4096, False) == 36 * 4096 ** 2
    # one query against 49 keys sees all of them
    assert bk.allowed_pairs(144, 1, 49, True) == 144 * 49


@pytest.mark.parametrize("kernel,passes", [
    ("forward", 4), ("backward", 11), ("flash_bwd_dkdv", 8),
    ("flash_bwd_dq", 5)])
def test_bf16_route_bounds_count_passes_at_the_bf16_rate(kernel, passes):
    ms, by = bk.flash_tc_bound(kernel, *TRAIN_4K)
    product = 2 * 64 * bk.allowed_pairs(*TRAIN_4K[:3], True)
    assert by == "operations"
    assert ms == passes * product / RA.PEAK_FLOPS * 1e3


@pytest.mark.parametrize("kernel,products", [
    ("backward", 5), ("flash_bwd_dkdv", 4), ("flash_bwd_dq", 3)])
def test_float32_backward_bounds_run_three_tf32_passes(kernel, products):
    ms, by = bk.flash_bwd_bound(kernel, *TRAIN_4K)
    product = 2 * 64 * bk.allowed_pairs(*TRAIN_4K[:3], True)
    assert by == "operations"
    assert ms == pytest.approx(products * product / (RA.TF32_FLOPS / 3)
                               * 1e3, rel=1e-12)
    ms32, _ = bk.flash_bwd_bound(kernel, *TRAIN_4K, fp32_units=True)
    assert ms32 == pytest.approx(products * product / RA.FP32_FLOPS * 1e3,
                                 rel=1e-12)


def _perf_rows():
    """(label, bound function, arguments, figure as PERF.md §6 writes it)
    for every bound its kernel table quotes."""
    minicpm_bwd = (144, 512, 512, 64, True)
    rows = [
        ("lanes gemm mac3", bk.fabric_bound, (K.mac3(240), 14800, 240, 0, 3),
         "0.0170"),
        ("stream relu", bk.fabric_bound, (K.relu(), 1, 1 << 24, 1, 0),
         "0.0401"),
        ("matmul f32", bk.matmul_bound, (*bk.MM, 4, 4), "1.6226"),
        ("matmul bf16", bk.matmul_bound, (*bk.MM, 2, 4), "0.1099"),
        ("matmul bf16 S2", bk.matmul_bound, (*bk.MM_HEAD, 2, 4), "0.6254"),
        ("conv", bk.conv_bound, bk.CONV, "0.0400"),
        ("adamw update", bk.adamw_bound, (MINICPM_PARAMS, 22), "17.90"),
        ("adamw norm", bk.adamw_bound, (MINICPM_PARAMS, 2), "1.63")]
    flash = {"minicpm-2b 4k": "1.1542", "minicpm-2b decode": "0.0011",
             "granite-moe decode": "0.00072",
             "internvl2-76b prefill": "0.0407",
             "zamba2-2.7b decode": "0.00122",
             "whisper-base encoder": "0.2751",
             "whisper-base cross decode": "0.00734"}
    rows += [(f"flash {s[0]}", bk.flash_bound, s[1:], flash[s[0]])
             for s in bk.FLASH_SHAPES if s[0] in flash]
    for kernel, fig in (("forward", "0.1564"), ("backward", "0.4300"),
                        ("flash_bwd_dkdv", "0.3128"),
                        ("flash_bwd_dq", "0.1955")):
        rows.append((f"bf16 {kernel} train-4k", bk.flash_tc_bound,
                     (kernel, *TRAIN_4K), fig))
    for kernel, fp32, tf32 in (("backward", "0.1806", "0.0734"),
                               ("flash_bwd_dkdv", "0.1445", "0.0587"),
                               ("flash_bwd_dq", "0.1084", "0.0440"),
                               ("flash_bwd_preprocess", "0.0114", "0.0114")):
        rows.append((f"f32 {kernel} minicpm-2b 512", bk.flash_bwd_bound,
                     (kernel, *minicpm_bwd), tf32))
        rows.append((f"f32 {kernel} minicpm-2b 512 fp32 units",
                     bk.flash_bwd_bound, (kernel, *minicpm_bwd, True), fp32))
    for label, fp32, tf32 in (("zamba2", "0.2007", "0.0815"),
                              ("internvl2", "0.1606", "0.0652"),
                              ("whisper-base encoder", "0.6878", "0.2793"),
                              ("whisper-base cross", "0.2348", "0.0953")):
        shape = next(s[1:] for s in bk.BWD_SHAPES if s[0].startswith(label))
        rows.append((f"f32 backward {label}", bk.flash_bwd_bound,
                     ("backward", *shape), tf32))
        rows.append((f"f32 backward {label} fp32 units", bk.flash_bwd_bound,
                     ("backward", *shape, True), fp32))
    return rows


@pytest.mark.parametrize("label,fn,args,figure", _perf_rows(),
                         ids=[r[0] for r in _perf_rows()])
def test_each_bound_gives_the_figure_perf_md_quotes(label, fn, args, figure):
    ms, by = fn(*args)
    assert by in ("bytes", "operations")
    assert round(ms, len(figure.split(".")[1])) == float(figure), ms


@pytest.mark.parametrize("peak,fn,args", [
    ("HBM_BW", bk.adamw_bound, (MINICPM_PARAMS, 22)),
    ("HBM_BW", bk.fabric_bound, (K.relu(), 1, 1 << 24, 1, 0)),
    ("HBM_BW", bk.conv_bound, bk.CONV),
    ("PEAK_FLOPS", bk.flash_tc_bound, ("forward", *TRAIN_4K)),
    ("PEAK_FLOPS", bk.matmul_bound, (*bk.MM, 2, 4)),
    ("FP32_FLOPS", bk.flash_bound, TRAIN_4K),
    ("FP32_FLOPS", bk.matmul_bound, (*bk.MM, 4, 4)),
    ("TF32_FLOPS", bk.flash_bwd_bound, ("backward", *TRAIN_4K))])
def test_bounds_read_their_peak_from_the_roofline(monkeypatch, peak, fn,
                                                  args):
    """Each bound moves with the ``roofline.analysis`` peak that binds it:
    twice the peak, half the bound."""
    ms, _ = fn(*args)
    monkeypatch.setattr(RA, peak, 2 * getattr(RA, peak))
    assert fn(*args)[0] == pytest.approx(ms / 2, rel=1e-12)


PEAK = re.compile(r"(?<![\w.])(989|495|67|33\.5|3\.35)e12\b")


def test_only_the_roofline_writes_the_cards_peaks():
    assert PEAK.search("HBM = 3.35e12") and PEAK.search("x = 67e12 / 2")
    files = [os.path.join(ROOT, n) for n in os.listdir(ROOT)
             if n.endswith(".py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    writers = []
    for f in files:
        with open(f) as fh:
            if PEAK.search(fh.read()):
                writers.append(os.path.relpath(f, ROOT))
    assert writers == [os.path.join("src", "repro_torch", "roofline",
                                    "analysis.py")]
    assert (RA.FP32_FLOPS, RA.TF32_FLOPS) == (67e12, 495e12)
    assert not [n for n, v in vars(bk).items()
                if isinstance(v, float) and v >= 1e9]


def test_the_script_binds_its_own_trees_peaks_before_src(tmp_path):
    """As a script, with no ``PYTHONPATH`` and ``--src`` naming a tree
    with no port at all, the bench imports its own tree's
    ``roofline.analysis`` and gets as far as asking for a card."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "src", "repro_torch",
                                      "bench_kernels.py"),
         "--src", str(tmp_path), "--only", "flash"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, proc.stderr
    assert "no CUDA device" in proc.stderr
    assert bk.RA is RA


def test_only_takes_every_case_and_nothing_else():
    assert bk.parse_args([]).only == list(bk.ONLY)
    assert bk.parse_args(["--only", "flash,adamw"]).only == ["flash",
                                                             "adamw"]
    for case in bk.ONLY:
        assert bk.parse_args(["--only", case]).only == [case]
        assert f"``{case}``" in bk.__doc__
    with pytest.raises(SystemExit):
        bk.parse_args(["--only", "flash,nothing"])
    assert set(bk.CASES) == {"lanes", "stream", "f32", "bf16", "conv",
                             "flash", "flash_bwd", "flash_bf16", "adamw"}
    assert bk.ONLY == ("path", *bk.CASES)       # the path run goes first


def test_counts_read_every_kernels_counter(monkeypatch):
    """:func:`counts` reads each ``COUNTERS`` attribute of its kernel
    module; a float32 flash kernel's count leaves out the bf16 route's
    launches, which its counter also counts, and ``flash backward`` is the
    float32 route's dq launches, one a backward call."""
    import importlib
    base = bk.counts()
    assert set(base) == set(bk.COUNTERS) | {"flash backward"}
    for name, (mod, attr) in bk.COUNTERS.items():
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        monkeypatch.setattr(m, attr, getattr(m, attr) + 7)
        got = bk.counts()
        moved = {k for k in got if got[k] != base[k]}
        monkeypatch.undo()
        if name in bk.ON_TC.values():      # the route's: both counters
            fp32 = next(k for k, tc in bk.ON_TC.items() if tc == name)
            assert got[name] - base[name] == 7
            assert got[fp32] - base[fp32] == -7
            assert moved == ({name, fp32, "flash backward"}
                             if fp32 == "flash_bwd_dq" else {name, fp32})
        elif name == "flash_bwd_dq":
            assert moved == {name, "flash backward"}
        else:
            assert moved == {name} and got[name] - base[name] == 7
