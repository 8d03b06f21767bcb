"""Mesh-agnostic checkpointing in the reference's on-disk format
(counterpart of ``repro.checkpoint.ckpt``): one directory ``step_%08d``
holding ``manifest.json`` and ``data.msgpack.zst``.

  * **the reference's format**: tensors in global layout, keyed by
    ``_flatten``'s paths (``/`` between dict keys, ``#i`` for list and
    tuple items), the payload a msgpack map from key to raw bytes
    (bfloat16 as its 16-bit words, marked ``<bf16>`` in the manifest),
    so a checkpoint of the reference's ``train.py`` restores here and one
    written here restores there;
  * **atomic**: writes go to ``step_XXXXXXXX.tmp`` then rename; the last
    ``keep`` checkpoints stay;
  * **async**: ``save_async`` makes the device-to-host copy on the
    caller's thread and writes on a thread.

The host tree is made of CPU tensors. Two departures, so that the port
needs no package beyond numpy and torch: the one msgpack shape the format
uses (a map from str to bin) is written and read by :func:`packb` and
:func:`unpackb` here, byte for byte what ``msgpack.packb(...,
use_bin_type=True)`` writes; and the payload is compressed with zstd only
where ``zstandard`` imports, as the reference does, while reading
decompresses whenever the file starts with zstd's magic bytes (and raises
by name where it does and ``zstandard`` is missing), rather than whenever
the package is present. bfloat16 travels through ``view(torch.int16)``,
so ``ml_dtypes`` is not needed.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading
from typing import Any, Dict, Optional, Tuple

import torch

try:
    import zstandard as zstd
    _Z = zstd.ZstdCompressor(level=3)
    _ZD = zstd.ZstdDecompressor()
except Exception:  # pragma: no cover
    _Z = _ZD = None

ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_BF16_MARK = "<bf16>"
# the manifest's dtype names (numpy's) for the dtypes a tree may hold
DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
               torch.float16: "float16", torch.int64: "int64",
               torch.int32: "int32", torch.int16: "int16",
               torch.int8: "int8", torch.uint8: "uint8",
               torch.bool: "bool", torch.bfloat16: _BF16_MARK}
DTYPES = {name: dt for dt, name in DTYPE_NAMES.items()}


# ---------------------------------------------------------------------------
# msgpack: a map from str to bin
# ---------------------------------------------------------------------------

def _head(n: int, small: Optional[int], small_max: int,
          codes: Tuple[int, int, int]) -> bytes:
    if small is not None and n <= small_max:
        return bytes([small | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} passes 2^32 - 1")


def packb(payload: Dict[str, bytes]) -> bytes:
    """``msgpack.packb(payload, use_bin_type=True)`` for a dict of str to
    bytes: a fixmap / map16 / map32 head, each key a fixstr / str8 / str16
    / str32, each value a bin8 / bin16 / bin32, in the dict's order."""
    out = [_head(len(payload), 0x80, 15, (0, 0xDE, 0xDF))]
    for k, v in payload.items():
        kb = k.encode("utf-8")
        out += [_head(len(kb), 0xA0, 31, (0xD9, 0xDA, 0xDB)), kb,
                _head(len(v), None, 0, (0xC4, 0xC5, 0xC6)), bytes(v)]
    return b"".join(out)


def unpackb(blob: bytes) -> Dict[str, bytes]:
    """The inverse of :func:`packb`; anything but a map from str to bin
    raises."""
    view = memoryview(blob)
    pos = 0

    def length(small_base, small_max, codes) -> int:
        nonlocal pos
        b = view[pos]
        pos += 1
        if small_base is not None and 0 <= b - small_base <= small_max:
            return b - small_base
        for code, fmt, size in zip(codes, (">B", ">H", ">I"), (1, 2, 4)):
            if code and b == code:
                (n,) = struct.unpack_from(fmt, view, pos)
                pos += size
                return n
        raise ValueError(f"msgpack: byte 0x{b:02x} at {pos - 1} is not the "
                         f"map / str / bin this format writes")

    n = length(0x80, 15, (0, 0xDE, 0xDF))
    out: Dict[str, bytes] = {}
    for _ in range(n):
        kn = length(0xA0, 31, (0xD9, 0xDA, 0xDB))
        key = bytes(view[pos:pos + kn]).decode("utf-8")
        pos += kn
        vn = length(None, 0, (0xC4, 0xC5, 0xC6))
        out[key] = bytes(view[pos:pos + vn])
        pos += vn
    if pos != len(view):
        raise ValueError(f"msgpack: {len(view) - pos} bytes after the map")
    return out


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _flatten(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            key = f"{prefix}/{k}" if prefix else str(k)
            out.update(_flatten(tree[k], key))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}"))
    elif tree is None:
        pass
    else:
        out[prefix] = torch.as_tensor(tree)
    return out


def _unflatten_into(template: Any, flat: Dict[str, torch.Tensor],
                    prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat,
                                   f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, tuple):
        return tuple(_unflatten_into(v, flat, f"{prefix}#{i}")
                     for i, v in enumerate(template))
    if isinstance(template, list):
        return [_unflatten_into(v, flat, f"{prefix}#{i}")
                for i, v in enumerate(template)]
    if template is None:
        return None
    return flat[prefix].to(torch.as_tensor(template).dtype)


def _dtype_name(dtype: torch.dtype) -> str:
    if dtype not in DTYPE_NAMES:
        raise ValueError(f"checkpoint: cannot store dtype {dtype}")
    return DTYPE_NAMES[dtype]


def _encode_array(t: torch.Tensor) -> bytes:
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _decode_array(buf: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype not in DTYPES:
        raise ValueError(f"checkpoint: unknown dtype {dtype!r}")
    dt = DTYPES[dtype]
    raw = torch.int16 if dt == torch.bfloat16 else dt
    t = torch.frombuffer(bytearray(buf), dtype=raw) if buf else \
        torch.empty(0, dtype=raw)
    return t.view(dt).reshape(tuple(shape))


def _host(tree: Any) -> Any:
    """A snapshot of ``tree`` on the host: every tensor copied to a new
    CPU tensor (so later in-place updates of the source do not reach a
    write in flight)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_host(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    if tree is None:
        return None
    return torch.as_tensor(tree).detach().to("cpu", copy=True)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
        return self._write(step, _host(tree), extra or {})

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict] = None) -> None:
        self.wait()
        host_tree = _host(tree)
        self._thread = threading.Thread(
            target=self._write, args=(step, host_tree, extra or {}))
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_tree: Any, extra: Dict) -> str:
        flat = _flatten(host_tree)
        manifest = {"step": step, "extra": extra,
                    "tensors": {k: {"shape": list(v.shape),
                                    "dtype": _dtype_name(v.dtype)}
                                for k, v in flat.items()}}
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        blob = packb({k: _encode_array(v) for k, v in flat.items()})
        if _Z is not None:
            blob = _Z.compress(blob)
        with open(os.path.join(tmp, "data.msgpack.zst"), "wb") as f:
            f.write(blob)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None
                ) -> Tuple[Any, int, Dict]:
        """Restore into ``template``'s structure and dtypes, as CPU
        tensors (the caller moves them to its device)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with open(os.path.join(path, "data.msgpack.zst"), "rb") as f:
            blob = f.read()
        if blob[:4] == ZSTD_MAGIC:
            if _ZD is None:
                raise RuntimeError(f"checkpoint {path} is zstd-compressed "
                                   f"and the zstandard package is missing")
            blob = _ZD.decompress(blob)
        payload = unpackb(blob)
        flat = {k: _decode_array(payload[k], meta["dtype"], meta["shape"])
                for k, meta in manifest["tensors"].items()}
        tree = _unflatten_into(template, flat)
        return tree, manifest["step"], manifest.get("extra", {})
