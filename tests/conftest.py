"""Test configuration: make the repo root importable (for ``benchmarks``)
and the tests dir itself (for ``hypothesis_stub``) so the canonical
``PYTHONPATH=src pytest tests/`` invocation works.

The engine's persistent artifact cache is disabled (memory-only) so test
outcomes — cache hit/miss counters in particular — don't depend on what a
previous run left under ``~/.cache/strela``."""
import os
import sys

os.environ.setdefault("STRELA_CACHE", "0")

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
for _p in (_ROOT, _HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (with its reason) where "
        "there is none")
