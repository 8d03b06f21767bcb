"""Table II benchmark kernels as execution-engine clients.

These reimplement the hand-written ``core.multishot`` helpers (``run_gemm``,
``run_gesummv``, ``run_2mm``) on top of ``Engine.compile`` + ``submit`` /
``flush``: kernels are compiled once into cached artifacts, independent
shots within a phase are submitted and batched by config class, and
data-dependent phases flush in between. Cycle accounting is identical to
the legacy helpers (same shot structure, stream counts, and layouts), which
is the proof that the old per-benchmark runner code can be retired in favor
of the one pipeline.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from repro_torch.core import kernels_lib as K
from repro_torch.core.multishot import Tally
from repro_torch.engine.scheduler import Engine

I32 = np.int32


def run_mm(eng: Engine, A: np.ndarray, B: np.ndarray,
           out: np.ndarray) -> None:
    """C = A @ B via batched mac3 shots (Fig. 7c)."""
    M, Kd = A.shape
    _, N = B.shape
    Np = math.ceil(N / 3) * 3
    Bp = np.zeros((Kd, Np), dtype=I32)
    Bp[:, :N] = B
    art = eng.compile(K.mac3(Kd))
    handles = []
    for i in range(M):
        for j in range(0, Np, 3):
            h = eng.submit(art,
                           {"a": A[i].astype(I32),
                            "b0": Bp[:, j].astype(I32),
                            "b1": Bp[:, j + 1].astype(I32),
                            "b2": Bp[:, j + 2].astype(I32)},
                           streams_changed=6,
                           layout=(1, 0, 0, 0, 0, 0, 0))
            handles.append((i, j, h))
    eng.flush()
    for i, j, h in handles:
        outs = h.result()
        for t in range(3):
            if j + t < N:
                out[i, j + t] = outs[f"out{t}"][0]


def run_axpby(eng: Engine, alpha: int, x: np.ndarray, beta: int,
              y: np.ndarray, out: np.ndarray) -> None:
    """out = alpha*x + beta*y, one-shot elementwise epilogue."""
    art = eng.compile(K.axpby(alpha, beta))
    h = eng.submit(art, {"x": x.astype(I32), "y": y.astype(I32)},
                   streams_changed=3, layout=(1, 1, 1))
    eng.flush()
    out[:] = h.result()["out"]


def run_gemm(eng: Engine, alpha: int, A: np.ndarray, B: np.ndarray,
             beta: int, C: np.ndarray) -> Tally:
    """C = alpha*A@B + beta*C (PolyBench gemm)."""
    NI, NJ = A.shape[0], B.shape[1]
    tmp = np.zeros((NI, NJ), dtype=I32)
    run_mm(eng, A, B, tmp)
    res = np.zeros(NI * NJ, dtype=I32)
    run_axpby(eng, alpha, tmp.reshape(-1), beta, C.reshape(-1), res)
    C[:, :] = res.reshape(NI, NJ)
    return eng.tally


def run_gesummv(eng: Engine, alpha: int, beta: int, A: np.ndarray,
                B: np.ndarray, x: np.ndarray, y: np.ndarray) -> Tally:
    """y = alpha*A@x + beta*B@x (dual-MAC row shots share the x stream)."""
    N = A.shape[0]
    art = eng.compile(K.mac2x(N))
    xi = x.astype(I32)
    handles = []
    for i in range(N):
        # only the two row bases change between shots (x, outputs, sizes
        # and strides persist) -> 2 MMIO writes per re-arm
        h = eng.submit(art,
                       {"a": A[i].astype(I32), "b": B[i].astype(I32),
                        "x": xi},
                       streams_changed=2, layout=(1, 1, 1, 0, 0))
        handles.append(h)
    eng.flush()
    d1 = np.array([h.result()["out0"][0] for h in handles], dtype=I32)
    d2 = np.array([h.result()["out1"][0] for h in handles], dtype=I32)
    run_axpby(eng, alpha, d1, beta, d2, y)
    return eng.tally


def run_2mm(eng: Engine, alpha: int, beta: int, A: np.ndarray,
            B: np.ndarray, C: np.ndarray, D: np.ndarray) -> Tally:
    """D = alpha*A@B@C + beta*D (PolyBench 2mm)."""
    NI, NJ = A.shape[0], B.shape[1]
    NL = C.shape[1]
    tmp = np.zeros((NI, NJ), dtype=I32)
    run_mm(eng, A, B, tmp)
    tmp2 = np.zeros((NI, NL), dtype=I32)
    run_mm(eng, tmp, C, tmp2)
    res = np.zeros(NI * NL, dtype=I32)
    run_axpby(eng, alpha, tmp2.reshape(-1), beta, D.reshape(-1), res)
    D[:, :] = res.reshape(NI, NL)
    return eng.tally
