"""The lane and stream kernels' layout rules and the wrappers' caches
(``repro_torch.kernels.fabric_reduce``, ``fabric_stream``), on the CPU.

``lane_layout`` mirrors how ``strela_fabric_reduce_lanes`` cuts a lane grid
into units: the Python side sizes the partials and counts the fold launches
from it, so its constants and branches are held here against
``csrc/fabric.cu`` itself, as ``tests/test_torch_routes.py`` holds the
matmul's route rule. ``stream_geometry`` mirrors the items a thread holds
and the tile a block walks in ``strela_fabric_stream``, which the tests on
the card use to reach the tile's edges; it is held here the same way. The caches: a DFG is lowered once and its instruction
table copied to a device once, however many grids run it.
"""
import os
import pickle
import re

import numpy as np
import pytest
import torch

from repro_torch.core import kernels_lib as K
from repro_torch.kernels import fabric_reduce as fr
from repro_torch.kernels import fabric_stream as fs

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "csrc", "fabric.cu")


def _source():
    with open(CSRC) as f:
        return f.read()


@pytest.mark.parametrize("name,value", [("kWarpLane", fr.WARP_LANE),
                                        ("kBlockLane", fr.BLOCK_LANE)])
def test_layout_constants_match_the_cuda_source(name, value):
    m = re.search(rf"constexpr int {name} = (\d+);", _source())
    assert m is not None and int(m[1]) == value


def test_layout_branches_match_the_cuda_source():
    src = " ".join(_source().split())
    body = src[src.index("int strela_fabric_reduce_lanes("):]
    marks = ["if (n_red == 0) {", "p.mode = kModeFlat;",
             "if (length <= kWarpLane) {", "p.mode = kModeWarp;",
             "} else if (length <= kBlockLane) {", "p.mode = kModeBlock;",
             "p.mode = kModeSplit;",
             "p.slices = (length + kBlockLane - 1) / kBlockLane;"]
    at = [body.find(m) for m in marks]
    assert -1 not in at and at == sorted(at), dict(zip(marks, at))


@pytest.mark.parametrize("n_red,length,want", [
    (0, 1, ("flat", 0)), (0, 100000, ("flat", 0)),
    (1, 1, ("warp", 0)), (3, 240, ("warp", 0)), (2, 256, ("warp", 0)),
    (2, 257, ("block", 0)), (1, 4095, ("block", 0)), (1, 4096, ("block", 0)),
    (1, 4097, ("split", 2)), (2, 8192, ("split", 2)),
    (2, 8193, ("split", 3)), (1, 70000, ("split", 18)),
])
def test_lane_layout(n_red, length, want):
    assert fr.lane_layout(n_red, length) == want


@pytest.mark.parametrize("name,value", [("kLThreads", fs.THREADS),
                                        ("kSlotBytes", fs.SLOT_BYTES)])
def test_stream_constants_match_the_cuda_source(name, value):
    m = re.search(rf"constexpr int {name} = ([\d *]+);", _source())
    assert m is not None and eval(m[1]) == value     # "64 * 1024"


def test_stream_geometry_matches_the_cuda_source():
    src = " ".join(_source().split())
    rule = src[src.index("int items_per_thread(int n_slots) {"):]
    rule = rule[:rule.index("return kv; }")]
    assert rule.endswith("int kv = 8; while (kv > 1 && "
                         "static_cast<size_t>(n_slots) * kv * kLThreads * "
                         "sizeof(int32_t) > kSlotBytes) kv /= 2; "), rule
    entry = src[src.index("int strela_fabric_stream("):]
    for mark in ("const int kv = items_per_thread(n_slots);",
                 "const long long tile = static_cast<long long>(kLThreads) "
                 "* kv;",
                 "p.n_units = (length + tile - 1) / tile;"):
        assert mark in entry, mark


@pytest.mark.parametrize("n_slots,want", [
    (1, (8, 2048)), (3, (8, 2048)), (8, (8, 2048)), (9, (4, 1024)),
    (14, (4, 1024)), (16, (4, 1024)), (17, (2, 512)), (32, (2, 512)),
    (33, (1, 256)), (64, (1, 256)),
])
def test_stream_geometry(n_slots, want):
    assert fs.stream_geometry(n_slots) == want


def test_stream_tables_of_the_timed_cases():
    # relu and vadd: 3 slots, a 2048-element tile; fft_butterfly: 14 slots
    # and 18 rows, a 1024-element tile
    for g, rows, slots, tile in ((K.relu(), 4, 3, 2048),
                                 (K.vadd(), 4, 3, 2048),
                                 (K.fft_butterfly(), 18, 14, 1024)):
        prog = fs.lower(g)
        assert (len(prog.table), prog.n_slots) == (rows, slots), g.name
        assert fs.stream_geometry(prog.n_slots)[1] == tile


def _ins(g, n_lanes, length, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(-1000, 1000, (n_lanes, length),
                                             dtype=np.int64)
                                .astype(np.int32)) for k in g.inputs}


def test_two_grids_of_one_dfg_lower_it_once():
    g = K.mac3(240)
    ins = _ins(g, 5, 240)
    lowered = fs.lowerings
    first = fr.reduce_lanes(g, ins)
    second = fr.reduce_lanes(g, ins)
    assert fs.lowerings == lowered + 1
    for r in first[1]:
        assert torch.equal(first[1][r], second[1][r])
    # another DFG object, even of the same name, is lowered again: the memo
    # lives on the DFG, never under its name
    fr.reduce_lanes(K.mac3(240), ins)
    assert fs.lowerings == lowered + 2
    # a pickled copy (an artifact from the disk cache) drops the memo
    fr.reduce_lanes(pickle.loads(pickle.dumps(g)), ins)
    assert fs.lowerings == lowered + 3


def test_a_program_copies_its_table_once_per_device():
    prog = fs.lower(K.fft_butterfly())
    uploads = fs.table_uploads
    dev = torch.device("cpu")
    first = prog.device_table(dev)
    assert prog.device_table(dev) is first
    assert fs.table_uploads == uploads + 1
    assert np.array_equal(first.numpy(), prog.table)
