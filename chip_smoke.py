#!/usr/bin/env python3
"""One command on a card for the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

It checks and times nothing itself. In order, it:

1. prints the card's name and power limit, torch's and CUDA's versions and
   the device count, and both TF32 switches, which it turns off;
2. builds the CUDA kernels of ``src/repro_torch/csrc``;
3. runs the ``gpu`` tests (``GPU_TESTS``) in a subprocess, and fails if any
   test fails, errs or skips: on a card none may skip;
4. runs ``repro_torch.bench_kernels``: its ``path`` run (the trainer at
   minicpm-2b's full width, the engine and the kernel ops, whose launches
   fill each row's ``launches``), then every case; prints each row whole
   and then one ``{"kernels": [...]}`` line, a row a kernel and shape with
   the fields of ``bench_kernels.FIELDS``;
5. prints ``{"ok": true, "device": {...}}`` last.

It exits non-zero, with no ``ok`` line, when there is no CUDA device or a
step fails. It imports neither ``jax`` nor the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, SRC)
GPU_TESTS = ("tests/test_torch_gpu.py", "tests/test_torch_gpu_adamw.py")


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def gpu_tests() -> None:
    """Runs ``GPU_TESTS`` under pytest; raises if any failed, erred or
    skipped."""
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "gpu.xml")
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-rfEs",
             "-p", "no:cacheprovider", f"--junitxml={report}", *GPU_TESTS],
            cwd=ROOT, env=env)
        suite = ET.parse(report).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    n = {k: int(suite.get(k)) for k in ("tests", "failures", "errors",
                                        "skipped")}
    passed = n["tests"] - n["failures"] - n["errors"] - n["skipped"]
    print(f"[gpu-tests] {passed} passed, {n['failures']} failed, "
          f"{n['errors']} errors, {n['skipped']} skipped in "
          f"{time.perf_counter() - t0:.1f} s (pytest exit {proc.returncode})",
          flush=True)
    if proc.returncode or passed != n["tests"]:
        raise RuntimeError("a gpu test failed, erred or skipped on the card")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch import bench_kernels
    from repro_torch.kernels import _build
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[device] {nvidia_smi()}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{count} device(s), device 0: {name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    print(f"[build] {len(_build.sources())} sources into "
          f"{_build.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    gpu_tests()
    t0 = time.perf_counter()
    rows = bench_kernels.run()
    for r in rows:
        print(f"[bench] {json.dumps(r)}")
    print(f"[bench] {len(rows)} rows in {time.perf_counter() - t0:.1f} s")
    print(nvidia_smi())                  # name, power limit: a line alone
    print(json.dumps({"kernels": [{k: r[k] for k in bench_kernels.FIELDS}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
