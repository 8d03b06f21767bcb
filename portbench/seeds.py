"""Seeds of the benchmark's own streams, derived from ``--seed`` (any whole
number, negative or past 64 bits included) and a stream's name."""
from __future__ import annotations

import hashlib


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for the stream ``keys`` of run seed ``seed``."""
    h = hashlib.sha256(repr((int(seed),) + tuple(keys)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1
