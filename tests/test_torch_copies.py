"""The modules the port copies verbatim from the reference stay equal to
it: the cycle model (``core/``), observability (``obs/``), the engine's
artifact and clients, the multi-shot partitioner, the serving loop, the
fleet's config, the synthetic data pipeline and the dry run's report. A
fix to the cycle model must be made in both copies; this test fails when
it is made in one.

Each module and its reference are parsed as text (nothing of ``repro`` is
imported), ``repro`` is renamed ``repro_torch`` in the reference, the
docstrings are stripped, and the two syntax trees must be equal.
``serve/health.py`` orders the names of its one (lazy) import otherwise:
there each import's names are compared as a set, and the rest of the
module as it is."""
import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = (os.path.join(ROOT, "src", p) for p in ("repro", "repro_torch"))

COPIED = [f"core/{m}.py" for m in (
    "__init__", "dfg", "isa", "fabric", "streams", "executor", "mapper",
    "opt_mapper", "elastic_sim", "elastic_sim_ref", "multishot", "energy",
    "soc", "paper_data", "paper_mappings")] + [
    f"obs/{m}.py" for m in ("__init__", "trace", "metrics", "profiler",
                            "report")] + [
    "engine/artifact.py", "engine/clients.py", "frontend/partition.py",
    "serve/clock.py", "serve/slo.py", "serve/health.py", "serve/loop.py",
    "fleet/config.py", "data/pipeline.py", "roofline/report.py"]
IMPORT_ORDER_ONLY = {"serve/health.py"}
RENAME = re.compile(r"\brepro\b(?!_)")


def _read(path, rename=False):
    with open(path) as fh:
        text = fh.read()
    return RENAME.sub("repro_torch", text) if rename else text


def _tree(text):
    """The module's syntax tree without its docstrings."""
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return tree


def _dump(tree, import_sets):
    if import_sets:
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                node.names.sort(key=lambda a: (a.name, a.asname or ""))
    return ast.dump(tree)


def test_the_list_is_the_one_roadmap_names():
    assert len(COPIED) == len(set(COPIED)) == 30
    for rel in COPIED:
        assert os.path.exists(os.path.join(REF, rel)), rel
        assert os.path.exists(os.path.join(PORT, rel)), rel


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_the_reference(rel):
    sets = rel in IMPORT_ORDER_ONLY
    want = _dump(_tree(_read(os.path.join(REF, rel), rename=True)), sets)
    got = _dump(_tree(_read(os.path.join(PORT, rel))), sets)
    assert got == want, f"{rel} has drifted from src/repro/{rel}"


def test_a_drifted_copy_is_caught():
    """One changed constant in a copy of the cycle model makes it differ;
    a changed docstring does not."""
    text = _read(os.path.join(REF, "core/multishot.py"), rename=True)
    want = ast.dump(_tree(text))
    doc = ast.parse(text).body[0].value.value
    assert ast.dump(_tree(text.replace(doc, doc + " (edited)", 1))) == want
    m = re.search(r"=\s*(\d+)\b", text)
    drifted = text[:m.start(1)] + str(int(m.group(1)) + 1) + text[m.end(1):]
    assert ast.dump(_tree(drifted)) != want


# classes the port copies verbatim into a module of its own making
COPIED_CLASSES = {"runtime/fault_tolerance.py": (
    "Heartbeat", "HealthMonitor", "StragglerDetector")}


def _class(path, name, rename):
    tree = _tree(_read(path, rename=rename))
    found = [n for n in tree.body
             if isinstance(n, ast.ClassDef) and n.name == name]
    assert len(found) == 1, (path, name)
    return ast.dump(found[0])


@pytest.mark.parametrize("rel,name", [(rel, name) for rel, names in
                                      COPIED_CLASSES.items()
                                      for name in names])
def test_copied_class_equals_the_reference(rel, name):
    """The trainer's straggler detector and the liveness primitives stay
    the reference's classes, decorators included."""
    assert _class(os.path.join(PORT, rel), name, False) == \
        _class(os.path.join(REF, rel), name, True), \
        f"{name} in {rel} has drifted from src/repro/{rel}"
