"""Build every ``csrc/*.cu`` into one shared library at first use and load it.

Each source compiles on its own (``nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -c``, all started together) and one ``nvcc -shared`` links the objects
into ``csrc/build/libstrela_<digest>.so`` (git-ignored), with a plain C
interface that ``ctypes`` binds: every pointer and the stream travel as
``c_void_p``. The digest covers every source, every header they share
(``csrc/*.cuh``) and the flags, so an edit to any of them rebuilds, and
concurrent processes race benignly (tmp file + rename). Nothing here runs
at import: the CPU tests import every module, and this machine may have no
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("building the CUDA kernels needs nvcc (the CUDA "
                       "toolkit); none was found on PATH or in "
                       "/usr/local/cuda/bin")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libstrela_{h.hexdigest()[:12]}.so"


def _run(procs: List[Tuple[str, subprocess.Popen]], verbose: bool) -> None:
    failed = []
    for what, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"{what}:\n{out}\n{err}")
        elif verbose:
            print(out + err, end="")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(verbose: bool = False) -> Path:
    """Compile the library unless this set of sources' build exists
    already: one ``nvcc`` per source, all at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    ptxas = ["-Xptxas", "-v"] if verbose else []
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append((src.name, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        _run(procs, verbose)
        _run([(out.name, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))],
            verbose)
        os.replace(tmp, out)
    finally:
        for obj in (*objs, tmp):
            obj.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built on first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.strela_fabric_reduce_lanes.argtypes = [
            vp, i, i, vp, i, vp, i, vp, vp, i, vp, vp, ll, ll, vp]
        lib.strela_fabric_reduce_lanes.restype = i
        lib.strela_fabric_stream.argtypes = [vp, i, i, vp, i, vp, i, ll, vp]
        lib.strela_fabric_stream.restype = i
        lib.strela_stream_matmul.argtypes = [
            vp, vp, vp, i, i, i, i, i, i, vp, ll, vp]
        lib.strela_stream_matmul.restype = i
        lib.strela_stream_matmul_scratch.argtypes = [vp, vp, i, i, i]
        lib.strela_stream_matmul_scratch.restype = ll
        lib.strela_stream_conv2d.argtypes = [vp, vp, vp, i, i, vp]
        lib.strela_stream_conv2d.restype = i
        lib.strela_flash_attention.argtypes = [
            vp, vp, vp, vp, vp, i, i, i, i, i, i, ctypes.c_float, vp]
        lib.strela_flash_attention.restype = i
        lib.strela_flash_bwd_preprocess.argtypes = [vp, vp, vp, ll, i, i, vp]
        lib.strela_flash_bwd_preprocess.restype = i
        lib.strela_flash_bwd_dkdv.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i,
            ctypes.c_float, vp]
        lib.strela_flash_bwd_dkdv.restype = i
        lib.strela_flash_bwd_dq.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, ctypes.c_float, vp]
        lib.strela_flash_bwd_dq.restype = i
        lib.strela_flash_attention_tc.argtypes = [
            vp, vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float, vp]
        lib.strela_flash_attention_tc.restype = i
        lib.strela_flash_bwd_dkdv_tc.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float,
            vp]
        lib.strela_flash_bwd_dkdv_tc.restype = i
        lib.strela_flash_bwd_dq_tc.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float, vp]
        lib.strela_flash_bwd_dq_tc.restype = i
        lib.strela_sq_norm_partials.argtypes = [vp, i]
        lib.strela_sq_norm_partials.restype = ll
        lib.strela_sq_norm.argtypes = [vp, vp, vp, i, vp, vp, vp, vp]
        lib.strela_sq_norm.restype = i
        f = ctypes.c_float
        lib.strela_adamw.argtypes = [vp, vp, vp, vp, vp, vp, i, vp, vp, vp,
                                     vp, f, f, f, f, f, f, vp, vp]
        lib.strela_adamw.restype = i
        lib.strela_error_string.argtypes = [i]
        lib.strela_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by an entry point."""
    if rc != 0:
        msg = lib.strela_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
