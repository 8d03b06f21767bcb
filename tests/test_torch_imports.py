"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
``torch``, never ``jax`` and nothing of the JAX package ``repro``, and the
``"cuda"`` backend never computes on the CPU unless it is asked to."""
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")

FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s)"
    r"|from\s+jax\b|import\s+jax)", re.M)


def _port_modules():
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def test_port_imports_neither_jax_nor_the_reference():
    mods = _port_modules()
    assert "repro_torch.kernels.fabric_reduce" in mods
    # named, so that dropping either subpackage fails here
    for m in ("repro_torch.workloads", "repro_torch.fleet"):
        assert m in mods, m
        mods.remove(m)
    mods = ["repro_torch.workloads", "repro_torch.fleet"] + mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_source_scan_finds_no_jax_or_reference_import():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    offenders = []
    for f in files:
        with open(f) as fh:
            for m in FORBIDDEN.finditer(fh.read()):
                offenders.append(f"{f}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                "from repro.core import dfg", "from repro import obs",
                "import repro", "    from repro.engine import x"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("from repro_torch.core import dfg", "import repro_torch",
               "# the reference repro.core.dfg"):
        assert not FORBIDDEN.search(ok), ok


def test_cuda_engine_without_a_card_raises_at_construction(monkeypatch):
    from repro_torch.engine import ArtifactCache, Engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}, {"device": "cuda:0"}):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            Engine(backend="cuda", cache=ArtifactCache(memory_only=True),
                   **kw)
    eng = Engine(backend="cuda", device="cpu",
                 cache=ArtifactCache(memory_only=True))
    assert eng.device == torch.device("cpu")


def test_kernel_entry_points_default_to_the_card():
    """Numpy inputs with no device go to the card; without one that is an
    error, never a quiet computation on the CPU."""
    from repro_torch.core import kernels_lib as K
    from repro_torch.kernels import fabric_reduce as fr
    from repro_torch.kernels import fabric_stream as fs
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    plain = (fr.plain_calls, fs.plain_calls)
    with pytest.raises((RuntimeError, AssertionError)):
        fr.run_dfg(K.relu(), {"x": np.ones(8, np.int32)})
    with pytest.raises((RuntimeError, AssertionError)):
        fs.fabric_stream(K.relu(), {"x": np.ones(8, np.int32)})
    assert (fr.plain_calls, fs.plain_calls) == plain
