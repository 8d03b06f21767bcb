"""Persistent artifact cache: memory layer over an on-disk store.

Replaces the in-memory-only compilation cache that used to live inside
``frontend/offload.py``: compiled artifacts survive the process, so the
expensive part of the pipeline (trace -> partition -> place & route, with
its randomized-restart search) is paid once per (kernel, length, geometry,
backend) *ever*, not once per process. Keys are content digests computed by
``engine/compiler.py`` (jaxpr hash or DFG structural hash, x length x
geometry x backend x schema version), so a key can never alias two
different compilation requests.

Layout: one ``<key>.pkl`` per artifact under the cache root. Writes are
atomic (tmp file + rename) so concurrent processes compiling the same
kernel race benignly. Corrupt or schema-stale files behave as misses and
are removed.

Root resolution order:
  1. explicit ``root=`` argument,
  2. ``$STRELA_CACHE_DIR/torch``,
  3. ``~/.cache/strela_torch/artifacts``.
The port's root never coincides with the reference package's: the pickles
name their module paths, so a port that loaded a reference artifact would
import the reference package.
``STRELA_CACHE=0`` in the environment disables the disk layer globally
(memory-only), for hermetic runs.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

from repro_torch import obs
from repro_torch.engine.artifact import ArtifactError, CompiledArtifact


def default_cache_root() -> str:
    env = os.environ.get("STRELA_CACHE_DIR")
    if env:
        return os.path.join(env, "torch")
    return os.path.join(os.path.expanduser("~"), ".cache", "strela_torch",
                        "artifacts")


def disk_cache_enabled() -> bool:
    return os.environ.get("STRELA_CACHE", "1") != "0"


class ArtifactCache:
    """Two-level artifact store: dict in front of a directory of pickles."""

    def __init__(self, root: Optional[str] = None,
                 memory_only: bool = False):
        # STRELA_CACHE=0 turns off the *implicit* disk layer; an explicit
        # root is a deliberate opt-in and keeps its disk store.
        self.root = root or default_cache_root()
        self.memory_only = memory_only or (root is None
                                           and not disk_cache_enabled())
        self._mem: Dict[str, CompiledArtifact] = {}
        self.hits = 0            # memory hits
        self.disk_hits = 0
        self.misses = 0

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.pkl")

    def get(self, key: str) -> Optional[CompiledArtifact]:
        art = self._mem.get(key)
        if art is not None:
            self.hits += 1
            obs.inc("artifact_cache.hit")
            return art
        if not self.memory_only:
            path = self._path(key)
            try:
                art = CompiledArtifact.load(path)
            except FileNotFoundError:
                art = None
            except Exception:
                # corrupt / stale entry: drop it and recompile
                try:
                    os.unlink(path)
                except OSError:
                    pass
                art = None
            if art is not None:
                if art.key != key:
                    art = None          # never serve a mislabeled artifact
                else:
                    self._mem[key] = art
                    self.disk_hits += 1
                    obs.inc("artifact_cache.disk_hit")
                    return art
        self.misses += 1
        obs.inc("artifact_cache.miss")
        return None

    def put(self, art: CompiledArtifact) -> None:
        self._mem[art.key] = art
        obs.inc("artifact_cache.put")
        if self.memory_only:
            return
        os.makedirs(self.root, exist_ok=True)
        blob = art.to_bytes()
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._path(art.key))
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def clear(self, disk: bool = False) -> None:
        self._mem.clear()
        if disk and not self.memory_only and os.path.isdir(self.root):
            for fn in os.listdir(self.root):
                if fn.endswith(".pkl"):
                    try:
                        os.unlink(os.path.join(self.root, fn))
                    except OSError:
                        pass

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "disk_hits": self.disk_hits,
                "misses": self.misses, "entries": len(self._mem)}


_default: Optional[ArtifactCache] = None


def default_cache() -> ArtifactCache:
    """Process-wide cache instance (re-resolved if the env changed)."""
    global _default
    if _default is None or _default.root != default_cache_root() \
            or _default.memory_only != (not disk_cache_enabled()):
        # no explicit root: STRELA_CACHE / STRELA_CACHE_DIR keep control
        _default = ArtifactCache()
    return _default
