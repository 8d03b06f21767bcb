"""The benchmark stands alone and is found by name: no module under
``portbench/`` imports JAX or the JAX package ``repro`` (and nothing in
``reference/`` imports the port), compared by whole top-level name since
``repro_torch`` begins with ``repro``; every piece ``BENCHMARK.json``
names is a file of its own."""
import ast
import os
import subprocess
import sys

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def modules():
    return sorted(p for p in harness.HERE.rglob("*.py")
                  if "__pycache__" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    names = set(top_level_imports(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    if "reference" in path.relative_to(harness.HERE).parts:
        assert "repro_torch" not in names


def test_a_run_loads_no_jax():
    code = ("import sys, importlib\n"
            f"sys.path[:0] = [{str(harness.ROOT)!r}, "
            f"{str(harness.ROOT / 'src')!r}]\n"
            "import torch, repro_torch.launch.train, repro_torch.models.api\n"
            "import repro_torch.convert\n"
            "for m in ['portbench.run', 'portbench.control', "
            "'portbench.drivers.train', 'portbench.drivers.prefill']:\n"
            "    importlib.import_module(m)\n"
            "from portbench import harness\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_scan_names_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models",
                                      "reprox", "torch"]) == []
    assert harness.forbidden_modules(["jax.numpy", "repro.core",
                                      "flax"]) == ["flax", "jax", "repro"]


BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
HELD = harness.load_json(harness.HELD)


@pytest.mark.parametrize("wl", BENCH["workloads"] + HELD["workloads"],
                         ids=lambda w: w["name"])
def test_every_cell_finds_its_pieces_by_name(wl):
    cell = harness.load_cell(wl["name"], BENCH)
    assert (harness.HERE / "drivers" / f"{cell.mix['kind']}.py").exists()
    assert cell.conf["name"] == wl["config"]
    assert {m["name"] for m in cell.end_to_end()} >= {"setup_s",
                                                      "peak_mem_gib"}
    assert len(cell.end_to_end()) >= 3 and cell.per_layer()
    for m in cell.per_layer():
        assert callable(harness.reader(m["name"]).read)
        moved = {e["name"] for e in cell.end_to_end()}
        assert m["moves"] in moved
    numbers = {"train": {"loss_err", "grad_gap", "update_gap"},
               "prefill": {"logits_err", "logits_err_median", "kv_err",
                           "kv_err_median"}}[cell.mix["kind"]]
    assert cell.limits["limits"] and set(cell.limits["limits"]) <= numbers
    for lim in cell.limits["limits"].values():
        assert lim["lower"] < lim["limit"] < lim["upper"]
        assert lim["upper"] >= 3 * lim["lower"]
        # more room above the sound readings than below the control's
        assert lim["limit"] / lim["lower"] >= lim["upper"] / lim["limit"]


def test_the_configuration_files_state_their_source_and_departures():
    for c in BENCH["configs"] + HELD["configs"]:
        conf = harness.load_json(harness.ROOT / c["file"])
        assert conf["source"] == c["source"]
        # each key changed from the source is listed, with its published
        # value beside the one run
        assert conf["reduced"] == c["reduced"] == list(conf["published"])
        assert all(conf[k] != v for k, v in conf["published"].items())
        assert conf["departures"] and conf["assumed"]
        assert conf["as_run"]["d_model"] == conf["hidden_size"]
        assert conf["as_run"]["n_layers"] == conf["num_hidden_layers"]
        assert conf["as_run"]["d_ff"] == conf["intermediate_size"]
        assert conf["as_run"]["vocab"] == conf["vocab_size"]


def test_held_cells_stay_out_of_the_benchmark():
    names = {w["name"] for w in BENCH["workloads"]}
    for wl in HELD["workloads"]:
        assert wl["name"] not in names
        cell = harness.load_cell(wl["name"], BENCH)
        assert {"setup_s", "peak_mem_gib"} <= {
            m["name"] for m in cell.end_to_end()}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for table in harness.TABLES:
        ours = {e["name"] for e in BENCH[table]}
        assert not ours & {e["name"] for e in HELD[table]}


def test_variants_share_the_reader_and_the_value_of_their_base():
    assert harness.reader("mfu.small_batch").__file__ \
        == str(harness.HERE / "metrics" / "mfu.py")
    values = {"train_tokens_per_s": 5.0, "setup_s": 1.0}
    assert harness.by_name("train_tokens_per_s.small_batch", values) == 5.0
    assert harness.by_name("setup_s", values) == 1.0
    with pytest.raises(KeyError):
        harness.by_name("prefill_tokens_per_s", values)


def test_the_run_refuses_without_a_card(capsys, monkeypatch):
    import torch
    from portbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed",
                   "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err
    assert BENCH["command"] == ["python3", "portbench/run.py"]
