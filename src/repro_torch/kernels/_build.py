"""Build ``csrc/fabric.cu`` into a shared library at first use and load it.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` compiles the one
source into ``csrc/build/libstrela_fabric_<digest>.so`` (git-ignored), with a
plain C interface that ``ctypes`` binds: every pointer and the stream travel
as ``c_void_p``. The digest covers the source and the flags, so an edited
source rebuilds and concurrent processes race benignly (tmp file + rename).
Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCE = CSRC / "fabric.cu"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("building the fabric kernels needs nvcc (the CUDA "
                       "toolkit); none was found on PATH or in "
                       "/usr/local/cuda/bin")


def library_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libstrela_fabric_{h.hexdigest()[:12]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the library unless this source's build exists already."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{SOURCE.name}:\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, end="")
    os.replace(tmp, out)
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
        lib.strela_error_string.argtypes = [i]
        lib.strela_error_string.restype = ctypes.c_char_p
        lib.strela_chunk_elements.argtypes = []
        lib.strela_chunk_elements.restype = i
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by an entry point."""
    if rc != 0:
        msg = lib.strela_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
