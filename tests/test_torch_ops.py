"""The port's kernel entry point ``repro_torch.kernels.ops`` on
``device="cpu"`` (the kernels' plain PyTorch versions) against the
reference Pallas kernels in interpret mode and ``repro.kernels.ref``, with
``tests/test_kernels_pallas.py``'s tolerances: 1e-4 for float32 matmul,
5e-2 for bfloat16, atol 1e-4 / rtol 1e-3 for conv, 3e-5 for attention.

Also a torch emulation of the CUDA flash kernel's tile loop (its tile
sizes, skip rule, -1e30 fill and ``max(l, 1e-30)`` epilogue) held against
the Pallas kernel, so that a masking fault shows before the card; and the
device rules: numpy inputs go to the card, CPU tensors take the plain
version, and nothing falls back quietly."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels_lib as RK
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro.kernels.stream_conv2d import stream_conv2d as pallas_conv2d
from repro.kernels.stream_matmul import stream_matmul as pallas_matmul
from repro_torch.convert import dfg_from_reference
from repro_torch.kernels import fabric_stream as fs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import stream_conv2d as sc
from repro_torch.kernels import stream_matmul as sm

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "csrc")


def _close(got, want, tol_a, tol_r):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               atol=tol_a, rtol=tol_r)


def _torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(x).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,dtype", [
    (70, 90, 50, "float32"),       # the reference's small-block case
    (1, 1, 1, "float32"),
    (130, 70, 100, "float32"),     # ragged against every block size
    (70, 90, 50, "bfloat16"),
    (33, 17, 65, "bfloat16"),
])
def test_matmul_matches_pallas_and_ref(m, k, n, dtype):
    rng = np.random.default_rng(m * 7 + k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ja, jb = jnp.asarray(a, dtype=dtype), jnp.asarray(b, dtype=dtype)
    got = ops.matmul(_torch(a, dtype), _torch(b, dtype), device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    tol = 1e-4 if dtype == "float32" else 5e-2
    _close(got, pallas_matmul(ja, jb, bm=32, bn=32, bk=32), tol, tol)
    _close(got, rref.matmul(ja, jb), tol, tol)


def test_matmul_out_dtype_bfloat16_matches_pallas():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((40, 70)).astype(np.float32)
    b = rng.standard_normal((70, 30)).astype(np.float32)
    got = ops.matmul(a, b, out_dtype=torch.bfloat16, device="cpu")
    want = pallas_matmul(jnp.asarray(a), jnp.asarray(b), bm=32, bn=32, bk=32,
                         out_dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    # one bfloat16 rounding of nearly equal fp32 sums: at most one ulp,
    # 2^-7 relative
    _close(got.float(), np.asarray(want.astype(jnp.float32)), 1e-6, 2 ** -7)


def test_matmul_both_settings_and_numpy_float64():
    rng = np.random.default_rng(6)
    a, b = rng.standard_normal((9, 4)), rng.standard_normal((4, 6))
    for use_kernel in (True, False):
        got = ops.matmul(a, b, use_kernel=use_kernel, device="cpu")
        assert got.dtype == torch.float32
        _close(got, rops.matmul(jnp.asarray(a), jnp.asarray(b),
                                use_pallas=False), 1e-4, 1e-4)


def test_matmul_inner_dimension_mismatch_raises():
    with pytest.raises(ValueError, match="inner dimensions"):
        ops.matmul(np.ones((3, 4), np.float32), np.ones((5, 2), np.float32),
                   device="cpu")


# ---------------------------------------------------------------------------
# conv2d_3x3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,block_rows", [(3, 200, 1), (20, 37, 4),
                                            (64, 50, 8)])
def test_conv2d_matches_pallas_and_ref(h, w, block_rows):
    rng = np.random.default_rng(h + w)
    img = rng.standard_normal((h, w)).astype(np.float32)
    kern = rng.standard_normal((3, 3)).astype(np.float32)
    got = ops.conv2d_3x3(img, kern, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (h - 2, w - 2)
    want = pallas_conv2d(jnp.asarray(img), jnp.asarray(kern),
                         block_rows=block_rows)
    _close(got, want, 1e-4, 1e-3)
    _close(got, rref.conv2d_3x3(jnp.asarray(img), jnp.asarray(kern)),
           1e-4, 1e-3)
    _close(ops.conv2d_3x3(img, kern, use_kernel=False, device="cpu"), got,
           0, 0)


def test_conv2d_rejects_an_image_below_3x3():
    with pytest.raises(ValueError, match="H >= 3"):
        ops.conv2d_3x3(np.ones((2, 9), np.float32),
                       np.ones((3, 3), np.float32), device="cpu")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTENTION = [
    # h, sq, sk, d, causal
    (2, 100, 100, 80, True),
    (2, 64, 300, 64, False),       # long keys, sk not a multiple of 64
    (1, 1, 200, 16, True),         # decode alignment: one query, last key
    (2, 40, 130, 64, True),        # causal with sq < sk, ragged sk
    (3, 150, 70, 16, False),       # more queries than keys, non-causal
]


def _qkv(h, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((h, sq, d)).astype(np.float32),
            rng.standard_normal((h, sk, d)).astype(np.float32),
            rng.standard_normal((h, sk, d)).astype(np.float32))


@pytest.mark.parametrize("h,sq,sk,d,causal", ATTENTION)
def test_attention_matches_pallas_and_ref(h, sq, sk, d, causal):
    q, k, v = _qkv(h, sq, sk, d, sq + sk + d)
    got = ops.attention(q, k, v, causal=causal, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (h, sq, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, pallas_attention(jq, jk, jv, causal=causal, bq=64, bk=64),
           3e-5, 3e-5)
    _close(got, rref.flash_attention(jq, jk, jv, causal=causal), 3e-5, 3e-5)


def test_attention_bfloat16_keeps_q_dtype():
    q, k, v = _qkv(2, 30, 90, 64, 11)
    tq, tk, tv = (_torch(x, "bfloat16") for x in (q, k, v))
    got = ops.attention(tq, tk, tv, causal=True, device="cpu")
    assert got.dtype == torch.bfloat16
    want = rref.flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                                  for x in (q, k, v)), causal=True)
    # the same fp32 arithmetic on the same bfloat16 inputs, rounded once
    _close(got.float(), np.asarray(want.astype(jnp.float32)), 1e-2, 2 ** -7)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_causal_attention_with_more_queries_than_keys_raises(use_kernel):
    q, k, v = _qkv(1, 9, 8, 16, 0)
    with pytest.raises(ValueError, match="sq=9 > sk=8"):
        ops.attention(q, k, v, causal=True, use_kernel=use_kernel,
                      device="cpu")
    assert ops.attention(q, k, v, causal=False, use_kernel=use_kernel,
                         device="cpu").shape == (1, 9, 16)


# ---------------------------------------------------------------------------
# the CUDA flash kernel's tile loop, emulated in torch
# ---------------------------------------------------------------------------

def _flash_tiles(q, k, v, causal):
    """``flash_kernel``'s loop in ``csrc/flash_attention.cu``: per query
    tile of BLOCK_Q rows (zero-filled past sq), key tiles of BLOCK_K
    (zero-filled past sk) in order until the first that starts past the
    tile's last query, the -1e30 fill, the online softmax in fp32 over
    scores in log2 units (``exp2``, as the kernel takes it), and
    ``acc / max(l, 1e-30)``."""
    h, sq, d = q.shape
    sk = k.shape[1]
    bq, bk = fa.BLOCK_Q, fa.BLOCK_K
    scale = 1.0 / (d ** 0.5) * 1.4426950408889634
    q_off = sk - sq
    out = torch.empty((h, sq, d), dtype=torch.float32)

    def tile(x, start, size):
        t = torch.zeros((h, size, d), dtype=torch.float32)
        part = x[:, start:start + size].float()
        t[:, :part.shape[1]] = part
        return t

    for q0 in range(0, sq, bq):
        qt = tile(q, q0, bq)
        qi = q_off + q0 + torch.arange(bq)[:, None]
        m = torch.full((h, bq, 1), fa.NEG_INF)
        l = torch.zeros((h, bq, 1))
        acc = torch.zeros((h, bq, d))
        for k0 in range(0, sk, bk):
            if causal and k0 > q_off + q0 + bq - 1:
                break
            kt, vt = tile(k, k0, bk), tile(v, k0, bk)
            ki = k0 + torch.arange(bk)[None, :]
            s = (qt @ kt.transpose(1, 2)) * scale
            mask = ki < sk
            if causal:
                mask = mask & (qi >= ki)
            s = torch.where(mask, s, torch.tensor(fa.NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp2(s - m_new)
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vt
            m = m_new
        n = min(bq, sq - q0)
        out[:, q0:q0 + n] = (acc / torch.clamp(l, min=1e-30))[:, :n]
    return out.to(q.dtype)


@pytest.mark.parametrize("h,sq,sk,d,causal", [
    (2, 70, 200, 16, True),        # causal sq < sk, two query tiles
    (1, 130, 130, 64, True),       # the skip rule cuts the key loop
    (2, 1, 129, 80, True),         # decode: one key past a tile edge
    (1, 100, 65, 16, False),       # a key tile of one real key
    (1, 257, 257, 64, True),       # one query past two full query tiles
    (2, 127, 200, 80, False),      # one query short of a query tile
])
def test_flash_tile_loop_matches_pallas(h, sq, sk, d, causal):
    q, k, v = _qkv(h, sq, sk, d, 3 * sq + sk)
    got = _flash_tiles(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, pallas_attention(jq, jk, jv, causal=causal, bq=64, bk=64),
           3e-5, 3e-5)
    assert torch.isfinite(got).all()


def test_tile_sizes_and_head_dims_match_the_cuda_source():
    with open(os.path.join(CSRC, "flash_attention.cu")) as f:
        src = f.read()
    assert int(re.search(r"constexpr int kBQ = (\d+);", src)[1]) == \
        fa.BLOCK_Q
    assert int(re.search(r"constexpr int kBK = (\d+);", src)[1]) == \
        fa.BLOCK_K
    assert float(re.search(r"constexpr float kNegInf = ([-\de.]+)f;",
                           src)[1]) == fa.NEG_INF
    cases = tuple(int(c) for c in re.findall(
        r"case (\d+): return launch<T, \1>", src))
    assert cases == fa.HEAD_DIMS


# ---------------------------------------------------------------------------
# fabric_elementwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("maker", [RK.relu, RK.fft_butterfly,
                                   lambda: RK.axpby(3, 5)])
def test_fabric_elementwise_matches_reference_ops(maker, use_kernel):
    rg = maker()
    g = dfg_from_reference(rg)
    rng = np.random.default_rng(len(rg.inputs))
    ins = {n: rng.integers(-2 ** 31, 2 ** 31, 1000, dtype=np.int64)
           .astype(np.int32) for n in rg.inputs}
    got = ops.fabric_elementwise(g, ins, use_kernel=use_kernel, device="cpu")
    want = rops.fabric_elementwise(
        rg, {n: jnp.asarray(x) for n, x in ins.items()},
        use_pallas=use_kernel)
    assert set(got) == set(want)
    for o in want:
        assert got[o].device.type == "cpu"
        np.testing.assert_array_equal(got[o].numpy(), np.asarray(want[o]))


# ---------------------------------------------------------------------------
# where the work runs
# ---------------------------------------------------------------------------

def _calls():
    mods = (sm, sc, fa, fs)
    return ([m.launches for m in mods], [m.plain_calls for m in mods])


def test_numpy_inputs_go_to_the_card_with_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    before = _calls()
    x = np.ones((4, 4), np.float32)
    q = np.ones((1, 4, 16), np.float32)
    for call in (lambda: ops.matmul(x, x),
                 lambda: ops.matmul(x, x, use_kernel=False),
                 lambda: ops.conv2d_3x3(x, np.ones((3, 3), np.float32)),
                 lambda: ops.attention(q, q, q),
                 lambda: ops.fabric_elementwise(
                     dfg_from_reference(RK.relu()),
                     {"x": np.ones(8, np.int32)})):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
    assert _calls() == before


def test_plain_calls_move_only_for_cpu_tensors():
    x = torch.ones((4, 4))
    q = torch.ones((1, 4, 16))
    launches, plain = _calls()
    ops.matmul(x, x)
    ops.conv2d_3x3(x, torch.ones((3, 3)))
    ops.attention(q, q, q)
    ops.fabric_elementwise(dfg_from_reference(RK.relu()),
                           {"x": torch.ones(8, dtype=torch.int32)})
    assert _calls() == (launches, [p + 1 for p in plain])
    # the kernels take CUDA tensors only, and refuse before counting
    for call in (lambda: sm.matmul_kernel(x, x),
                 lambda: sc.conv_kernel(x, torch.ones((3, 3))),
                 lambda: fa.attention_kernel(q, q, q)):
        with pytest.raises(ValueError, match="runs on CUDA tensors"):
            call()
    assert _calls() == (launches, [p + 1 for p in plain])


@pytest.mark.parametrize("call,match", [
    (lambda: sm.matmul_plain(torch.ones(2, 2, dtype=torch.int32),
                             torch.ones(2, 2, dtype=torch.int32)),
     "share a dtype"),
    (lambda: sm.matmul_plain(torch.ones(2, 2), torch.ones(2, 2),
                             torch.float16), "out_dtype"),
    (lambda: sc.conv_plain(torch.ones(5, 5), torch.ones(2, 3)), r"\(3, 3\)"),
    (lambda: fa.attention_plain(torch.ones(1, 2, 16), torch.ones(1, 3, 8),
                                torch.ones(1, 3, 8)), "head_dim"),
    (lambda: fa.attention_plain(torch.ones(1, 2, 16), torch.ones(1, 0, 16),
                                torch.ones(1, 0, 16), causal=False),
     "at least one key"),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()
