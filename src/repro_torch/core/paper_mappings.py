"""Frozen 'manual' mappings for the paper's benchmark kernels (Fig. 7).

The paper maps kernels by hand; we freeze mapper-discovered placements here
so benchmark and test runs are deterministic and fast (the search that found
them is reproducible via ``map_dfg(g, restarts=400)``). Active-PE counts are
in the same range as the configuration-cycle data of Table I (fft uses the
whole 4x4 fabric + all 8 memory nodes, exactly as described for Fig. 7b).
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core import kernels_lib as K
from repro_torch.core.dfg import DFG, unroll, unroll_chained
from repro_torch.core.mapper import Mapping, map_dfg

# node -> (row, col) placements; imn/omn stream bindings
_PLACEMENTS: Dict[str, dict] = {
    "fft": {
        "place": {"t1": (0, 2), "t2": (0, 3), "t3": (0, 1), "t4": (1, 3),
                  "ti": (1, 1), "oi0": (2, 1), "oi1": (2, 2), "tr": (1, 2),
                  "or0": (2, 0), "or1": (3, 2)},
        "imn": {"ar": 0, "ai": 1, "br": 2, "bi": 3},
        "omn": {"out_or0": 0, "out_oi0": 1, "out_or1": 2, "out_oi1": 3},
    },
    "relu_x3": {
        "place": {"c@0": (0, 1), "o@0": (1, 0), "c@1": (0, 2), "o@1": (1, 1),
                  "c@2": (0, 3), "o@2": (1, 2)},
        "imn": {"x@0": 0, "x@1": 1, "x@2": 2},
        "omn": {"out@0": 0, "out@1": 1, "out@2": 2},
    },
    "dither_c2": {
        "place": {"v@0": (0, 0), "c@0": (1, 0), "o@0": (2, 0), "e@0": (3, 0),
                  "v@1": (3, 1), "c@1": (3, 2), "o@1": (2, 2), "e@1": (2, 1)},
        "imn": {"x@0": 0, "x@1": 1},
        "omn": {"out@0": 0, "out@1": 1},
    },
    "find2min": {
        "place": {"c1": (0, 0), "cand": (1, 0), "c2": (2, 0), "idx": (0, 1),
                  "i1": (1, 1), "iold": (1, 2), "i2": (3, 2), "m1": (2, 1),
                  "m2": (3, 0)},
        "imn": {"x": 0},
        "omn": {"out_m1": 1, "out_i1": 3, "out_m2": 0, "out_i2": 2},
    },
    "find2min_brmg": {
        "place": {"c1": (0, 1), "brm": (1, 1), "brx": (1, 0), "cand": (2, 0),
                  "c2": (3, 0), "brc": (3, 1), "brm2": (3, 2), "m1": (2, 1),
                  "m2": (2, 2)},
        "imn": {"x": 0},
        "omn": {"out_m1": 0, "out_m2": 1},
    },
    "relu": {
        "place": {"c": (0, 0), "o": (1, 0)},
        "imn": {"x": 0}, "omn": {"out": 0},
    },
    "dither": {
        "place": {"v": (0, 0), "c": (1, 0), "o": (2, 0), "e": (3, 0)},
        "imn": {"x": 0}, "omn": {"out": 0},
    },
}

_BUILDERS = {
    "fft": K.fft_butterfly,
    "relu": K.relu,
    "relu_x3": lambda: unroll(K.relu(), 3),
    "dither": K.dither,
    "dither_c2": lambda: unroll_chained(K.dither(), 2),
    "find2min": K.find2min,
    "find2min_brmg": K.find2min_brmg,
}


def paper_dfg(name: str) -> DFG:
    return _BUILDERS[name]()


def paper_mapping(name: str) -> Mapping:
    """Deterministically rebuild the frozen mapping for a paper kernel."""
    g = paper_dfg(name)
    info = _PLACEMENTS[name]
    return map_dfg(g, hints=dict(info["place"]), imn_hint=dict(info["imn"]),
                   omn_hint=dict(info["omn"]), restarts=8)


PAPER_KERNELS = tuple(_PLACEMENTS)
