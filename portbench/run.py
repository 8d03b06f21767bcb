#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

  python3 portbench/run.py --workload minicpm-2b.train-512 --seed 7 \\
      --seconds 10 --trace 0

Set-up (weights from the seed, the model, warm-up of every shape the
cell uses) runs from process start to the window; the window measures
for ``--seconds``; with ``--trace 1`` a profiled stretch follows it. Once
the program's state is freed, the plain reference checks what the timed
path produced. The last line of standard output is one JSON object; the
compared numbers beside their limits are the last lines of standard
error. Without enough CUDA devices, or with JAX or the JAX package
loaded, it prints no result and exits nonzero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, cell=None) -> int:
    """``device`` and ``cell`` are for the benchmark's own tests, which
    drive a small cell on the CPU; a run on the card passes neither."""
    args = parse(argv)
    import torch
    from portbench import check, harness
    from portbench.spec import model_spec
    cell = cell or harness.load_cell(args.workload)
    chips = cell.workload["chips"]
    if device is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < chips:
            print(f"portbench: {cell.name} needs {chips} CUDA device(s), "
                  f"found {found}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = args.seconds if args.seconds is not None \
        else cell.bench["run_seconds"]
    driver = harness.load_module(harness.HERE / "drivers"
                                 / f"{cell.mix['kind']}.py")
    out = driver.run(cell, args.seed, seconds, bool(args.trace), device,
                     T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}", file=sys.stderr)
        return 3
    correct, checks = check.decide(out["numbers"], cell.limits)
    tr = out["trace"]
    if args.trace:
        ctx = types.SimpleNamespace(trace=tr, spec=model_spec(cell.conf),
                                    mix=cell.mix, window=out["window"])
        metrics = {}
        for m in cell.per_layer():
            value = harness.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": harness.by_name(m["name"],
                                                        out["e2e"]),
                               "unit": m["unit"]} for m in cell.end_to_end()}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": chips, "memory_peak_bytes": out["peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = tr.breakdown()
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
