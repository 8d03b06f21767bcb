"""What every cell's run shares: finding its pieces by name, the card
check, the result line, and the scan for JAX in the process."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module of the benchmark by file path (names may hold dots)."""
    name = "portbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its pieces loaded."""
    bench: Dict
    workload: Dict
    conf: Dict
    mix: Dict
    limits: Dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def applies(self, metric: Dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.bench["end_to_end"] if self.applies(m)]

    def per_layer(self) -> List[Dict]:
        moved = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]


HELD = HERE / "held.json"
TABLES = ("configs", "workloads", "end_to_end", "per_layer")


def load_cell(name: str, bench: Optional[Dict] = None) -> Cell:
    """A cell of ``BENCHMARK.json``, or one of the cells ``held.json`` keeps
    out of it, with the entries of both."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    if not any(w["name"] == name for w in bench["workloads"]) \
            and HELD.exists():
        held = load_json(HELD)
        bench = dict(bench, **{k: bench[k] + held.get(k, []) for k in TABLES})
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    wl = found[0]
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return Cell(bench, wl, load_json(ROOT / conf["file"]),
                load_json(HERE / "mixes" / f"{wl['traffic']}.json"),
                load_json(HERE / "limits" / f"{name}.json"))


def by_name(name: str, table: Dict[str, Any]) -> Any:
    """``table[name]``, else the entry of the name's base (up to its first
    dot), which its variants share: ``train_tokens_per_s.small_batch``
    is a driver's ``train_tokens_per_s`` in another cell."""
    return table[name] if name in table else table[name.split(".")[0]]


def reader(name: str) -> ModuleType:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, else
    the file of its base name."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path)


def forbidden_modules(modules=None) -> List[str]:
    """JAX, its kin and the JAX package, by whole top-level name, among
    ``modules`` (default: those this process has loaded)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank over every value."""
    if not values:
        raise ValueError("p95 of no values")
    ordered = sorted(values)
    return ordered[max(math.ceil(0.95 * len(ordered)) - 1, 0)]


def check_lines(checks: Dict[str, Dict[str, float]]) -> List[str]:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
            for name, c in checks.items()]


def emit(result: Dict, checks: Dict[str, Dict[str, float]]) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, and the result as the last line on standard output,
    with the numbers under ``checks``, its last key."""
    for line in check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}), flush=True)
