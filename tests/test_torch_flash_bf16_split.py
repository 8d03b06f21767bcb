"""The bf16 tensor-core flash route's numeric contract and tile geometry, on
the CPU (``flash_kernel_tc``, ``flash_bwd_dq_kernel_tc`` and
``flash_bwd_dkdv_kernel_tc`` in ``src/repro_torch/csrc/flash_attention.cu``).

The kernels take bfloat16 q, k, v and dO. Every product of two bfloat16 is
exact in float32, so S = Q K^T and dP = dO V^T run as one bf16 pass; P and
dS are float32, and each is split into three bfloat16 pieces (hi =
bf16_rn(x), mid = bf16_rn(x - hi), lo = bf16_rn(x - hi - mid)), its product
run as three passes into one float32 accumulator, smallest piece first. A
CUDA kernel cannot run here, so a torch emulation of the kernels' tile
loops stands in for them: each ``wgmma`` k16 step adds 16 exact products
(float64) to a float32 accumulator with one rounding, in the kernels' k
order over their tiles (the causal skip and the warpgroups' 64 rows
included); P and dS come from the saved lse and D as the kernels form
them. The emulation is held to the reference's attention and to
``jax.vjp`` of its "full" branch within the same 2e-5 as
``tests/test_torch_flash_bwd_tiles.py`` holds the 3xTF32 kernels, at both
widths the route takes and at the tiles' edges; a single piece of P and dS
(plain bf16 flash) must miss by at least 10x more, so the test can tell
the two apart. The split itself gives back every float32 exactly down to
2^-110, below which lo falls under bfloat16's smallest subnormal. D read
from the bfloat16 O the forward writes keeps dQ and dK within 2^-8 of
max |ref| of ``jax.vjp``, and leaves dV as it was.

The tile constants and the per-d shared-memory formulas are read from the
CUDA source (``TcLayout``): the emulation's tiles must be the kernels', and
every width the route takes must fit the 232,448 bytes a block may use, as
the source note's table says.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as RK
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "csrc", "flash_attention.cu")
SMEM_LIMIT = 232448            # bytes a block may use on the H100
LOG2E = np.float32(1.4426950408889634)
NEG_INF = -1e30


def _source():
    with open(CSRC) as f:
        return f.read()


def _layout():
    src = _source()
    at = src.index("struct TcLayout {")
    return " ".join(src[at:src.index("};", at)].split())


def _const(name):
    """``constexpr int ... name = <int>`` at the source's namespace
    scope."""
    m = re.search(rf"constexpr int (?:\w+ = \d+, )*{name} = (\d+)[,;]",
                  _source())
    assert m is not None, name
    return int(m[1])


def _tc_layout(d):
    """TcLayout<D>'s constants at D = d, each expression evaluated over
    the ones before it (C's integer division)."""
    names = {"D": d, "kTcRows": _const("kTcRows"),
             "kTcStages": _const("kTcStages")}
    for name, expr in re.findall(
            r"static constexpr (?:int|size_t) (\w+) = ([^;]+);", _layout()):
        expr = re.sub(r"(?<![/])/(?![/])", "//", expr)
        names[name] = eval(expr, {}, dict(names))
    return names


ROWS = _const("kTcRows")        # a block's own rows, 64 a warpgroup
LAY = _tc_layout(64)
BK, KT, QT = LAY["BK"], LAY["KT"], LAY["QT"]


# --- geometry --------------------------------------------------------------

@pytest.mark.parametrize("d", fa.TC_HEAD_DIMS)
def test_tiles_match_the_source_and_fit_every_width(d):
    lay = _tc_layout(d)
    assert (ROWS, lay["BK"], lay["KT"], lay["QT"]) == (ROWS, BK, KT, QT)
    assert ROWS == 2 * 64 and BK % 16 == KT % 16 == QT % 16 == 0
    # a box starts on 1,024 bytes: every tile is whole 8-row atoms
    assert all(n % 8 == 0 for n in (ROWS, BK, KT, QT))
    # lse and D: a box of QT + 4 floats (whole 16-byte words) in a slot
    assert (QT + 4) * 4 % 16 == 0 and lay["kLseSlot"] >= (QT + 4) * 4
    assert lay["kDkdvStage"] % 1024 == 0
    got = [lay[k] for k in ("fwd_bytes", "dq_bytes", "dkdv_bytes")]
    assert max(got) <= SMEM_LIMIT
    # the source note's table states the same bytes
    col = fa.TC_HEAD_DIMS.index(d)
    for which, n in zip(("fwd_tc", "dq_tc", "dkdv_tc"), got):
        row = re.search(rf"^//\s+{which}\s+([\d, ]+)$", _source(), re.M)
        assert row is not None, which
        assert int(row[1].split()[col].replace(",", "")) == n


def test_setmaxnreg_split_fits_the_block():
    """The producer's and the two consumers' registers add up to what the
    block's 384 threads start with (65,536 over 384, in steps of 8)."""
    threads = _const("kTcThreads")
    start = 65536 // threads // 8 * 8
    assert threads == 3 * 128
    assert (_const("kTcProducerRegs") + 2 * _const("kTcConsumerRegs")
            <= 3 * start)


def test_the_wrapper_routes_by_dtype_width_and_queries():
    def q(dtype, sq, d):
        return torch.empty((2, sq, d), dtype=dtype)
    assert fa.TC_HEAD_DIMS == (64, 128)
    assert fa.tc_route(q(torch.bfloat16, 64, 64), 64)
    assert fa.tc_route(q(torch.bfloat16, 4096, 128), 4096)
    assert not fa.tc_route(q(torch.float32, 4096, 64), 4096)
    assert not fa.tc_route(q(torch.bfloat16, 4096, 80), 4096)
    assert not fa.tc_route(q(torch.bfloat16, 4096, 16), 4096)
    assert not fa.tc_route(q(torch.bfloat16, fa.TC_MIN_QUERIES - 1, 64), 49)


# --- the split -------------------------------------------------------------

def bf16_rn(x):
    """float32 -> bfloat16 -> float32, rounding to nearest even as
    ``cvt.rn.bf16x2.f32`` does (subnormals kept)."""
    return x.to(torch.bfloat16).to(torch.float32)


def split3(x):
    hi = bf16_rn(x)
    mid = bf16_rn(x - hi)
    return hi, mid, bf16_rn(x - hi - mid)


def _bits(*words):
    return torch.tensor(words, dtype=torch.int64).to(torch.int32).view(
        torch.float32)


def test_three_pieces_give_back_every_float32():
    """Exact wherever lo's last bit (x's, 2^-23 of its exponent) is one
    bfloat16 holds, |x| >= 2^-110 (bfloat16's smallest subnormal is
    2^-133), and at 0 and the smallest normals, whose low bits are 0."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        1 << 16).astype(np.float32))
    x = torch.cat([x, x * 1e-25, x * 1e30, x.abs() * 1e-3])
    assert float(x.abs().min()) >= 2.0 ** -110
    # +-0, the smallest normals, 2^-110 with an odd 24-bit significand,
    # the largest float32 that bfloat16 rounding leaves finite, and odd
    # significands near 1 and 2
    x = torch.cat([x, _bits(0, 0x80000000, 0x00800000, 0x80800000,
                            0x08800001, 0x88800001, 0x7F7F7FFF, 0xFF7F7FFF,
                            0x3F800001, 0x3FFFFFFF, 0x3F7FFFFF)])
    hi, mid, lo = split3(x)
    back = hi.double() + mid.double() + lo.double()
    # the same value (-0 comes back as +0, which sums the same)
    assert torch.equal(back, x.double())
    # each piece is a bfloat16
    for piece in (hi, mid, lo):
        assert torch.equal(bf16_rn(piece), piece)


def test_a_lo_below_bfloat16_subnormals_is_the_only_loss():
    """Near the smallest normals lo falls below bfloat16's smallest
    subnormal (2^-133) and rounds away: the sum then misses by at most
    half of it, 2^-134; P and dS lose nothing a float32 sum of them could
    hold there. Past the largest bfloat16 hi rounds to infinity, which P
    (at most 1) and dS never reach."""
    x = _bits(0x00800001, 0x00800003, 0x00FFFFFF, 0x01000001)
    hi, mid, lo = split3(x)
    err = (hi.double() + mid.double() + lo.double() - x.double()).abs()
    assert float(err.max()) > 0
    assert float(err.max()) <= 2.0 ** -134
    assert torch.isinf(split3(_bits(0x7F7FFFFF))[0]).all()


# --- the emulation ---------------------------------------------------------

def mma(acc, a, b):
    """``acc (.., m, n) += a (.., m, K) b (.., K, n)`` as wgmma k16 steps:
    each step's 16 products exact (float64), added to the float32
    accumulator with one rounding."""
    for k0 in range(0, a.shape[-1], 16):
        acc = (acc.double() + a[..., k0:k0 + 16].double()
               @ b[..., k0:k0 + 16, :].double()).float()
    return acc


def mma_split(acc, p, b, pieces):
    """``acc += p b`` with p float32: three pieces, smallest first (each a
    pass over the tile's k), or hi alone."""
    hi, mid, lo = split3(p)
    for part in ((lo, mid, hi) if pieces == 3 else (hi,)):
        acc = mma(acc, part, b)
    return acc


def _pad(x, n):
    out = torch.zeros((x.shape[0], n) + tuple(x.shape[2:]), dtype=x.dtype)
    out[:, :x.shape[1]] = x
    return out


def _scale(d):
    return np.float32(1.0 / d ** 0.5)


def emulate_forward(q, k, v, causal, pieces=3):
    """O and lse by ``flash_kernel_tc``'s loop: a warpgroup per 64
    queries, key tiles of BK up to the first past its last query, S in one
    pass, the online softmax in log2 units, O += P V in pieces."""
    h, sq, d = q.shape
    sk = k.shape[1]
    q_off, scale2 = sk - sq, _scale(d) * LOG2E
    n_kb = -(-sk // BK)
    kp, vp = _pad(k, n_kb * BK), _pad(v, n_kb * BK)
    qp = _pad(q, -(-sq // 64) * 64)
    out, lse = torch.zeros(h, qp.shape[1], d), torch.zeros(h, qp.shape[1])
    for q0 in range(0, sq, 64):
        qt = qp[:, q0:q0 + 64]
        qi = q_off + q0 + torch.arange(64)[:, None]
        tiles = min(n_kb, (q_off + q0 + 63) // BK + 1) if causal else n_kb
        m = torch.full((h, 64, 1), NEG_INF)
        l, acc = torch.zeros(h, 64, 1), torch.zeros(h, 64, d)
        for j in range(tiles):
            k0 = j * BK
            s = mma(torch.zeros(h, 64, BK), qt, kp[:, k0:k0 + BK].mT)
            ki = k0 + torch.arange(BK)[None]
            ok = (ki < sk) & ((not causal) | (qi >= ki))
            s = torch.where(ok, s * scale2, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = mma_split(acc * alpha, p, vp[:, k0:k0 + BK], pieces)
            m = m_new
        out[:, q0:q0 + 64] = acc / torch.clamp(l, min=1e-30)
        lse[:, q0:q0 + 64] = ((m + torch.log2(l)) * np.float32(
            0.6931471805599453))[..., 0]
    return out[:, :sq], lse[:, :sq]


def _p_ds(s, dp, lse2, dl, qi, ki, sq, sk, causal, scale2):
    q_off = sk - sq
    ok = (qi < sq) & (ki < sk) & ((not causal) | (q_off + qi >= ki))
    p = torch.where(ok, torch.exp2(s * scale2 - lse2), torch.zeros(()))
    return p, torch.where(ok, p * (dp - dl), torch.zeros(()))


def emulate_dkdv(q, k, v, do, lse, delta, causal, pieces=3):
    """dK, dV by ``flash_bwd_dkdv_kernel_tc``'s loop: a block per ROWS
    keys from the query tile that sees its first key, a warpgroup per 64
    keys skipping tiles none of whose queries see them, S^T and dP^T in
    one pass, then dV += P^T dO and dK += dS^T Q in pieces."""
    h, sq, d = q.shape
    sk = k.shape[1]
    q_off, scale2 = sk - sq, _scale(d) * LOG2E
    n_kb, n_qb = -(-sk // ROWS), -(-sq // QT)
    kp, vp = _pad(k, n_kb * ROWS), _pad(v, n_kb * ROWS)
    qp, dop = _pad(q, n_qb * QT), _pad(do, n_qb * QT)
    lse2, dl = _pad(lse * LOG2E, n_qb * QT), _pad(delta, n_qb * QT)
    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)
    for k0 in range(0, n_kb * ROWS, ROWS):
        qb0 = max(0, k0 - q_off) // QT if causal else 0
        for wk0 in (k0, k0 + 64):
            kt, vt = kp[:, wk0:wk0 + 64], vp[:, wk0:wk0 + 64]
            ki = torch.arange(wk0, wk0 + 64)[:, None]
            acc_k, acc_v = torch.zeros(h, 64, d), torch.zeros(h, 64, d)
            for qb in range(qb0, n_qb):
                q0 = qb * QT
                if wk0 >= sk or (causal and q_off + q0 + QT - 1 < wk0):
                    continue
                qs, dos = qp[:, q0:q0 + QT], dop[:, q0:q0 + QT]
                s = mma(torch.zeros(h, 64, QT), kt, qs.mT)
                dp = mma(torch.zeros(h, 64, QT), vt, dos.mT)
                p, ds = _p_ds(s, dp, lse2[:, None, q0:q0 + QT],
                              dl[:, None, q0:q0 + QT],
                              torch.arange(q0, q0 + QT)[None], ki, sq, sk,
                              causal, scale2)
                acc_v = mma_split(acc_v, p, dos, pieces)
                acc_k = mma_split(acc_k, ds, qs, pieces)
            dk[:, wk0:wk0 + 64] = acc_k * _scale(d)
            dv[:, wk0:wk0 + 64] = acc_v
    return dk[:, :sk], dv[:, :sk]


def emulate_dq(q, k, v, do, lse, delta, causal, pieces=3):
    """dQ by ``flash_bwd_dq_kernel_tc``'s loop: a warpgroup per 64
    queries, key tiles of KT up to the first past its last query, S and dP
    in one pass, then dQ += dS K in pieces."""
    h, sq, d = q.shape
    sk = k.shape[1]
    q_off, scale2 = sk - sq, _scale(d) * LOG2E
    n_kb, n_q = -(-sk // KT), -(-sq // 64) * 64
    kp, vp = _pad(k, n_kb * KT), _pad(v, n_kb * KT)
    qp, dop = _pad(q, n_q), _pad(do, n_q)
    lse2, dl = _pad(lse * LOG2E, n_q), _pad(delta, n_q)
    dq = torch.zeros_like(qp)
    for q0 in range(0, sq, 64):
        qs, dos = qp[:, q0:q0 + 64], dop[:, q0:q0 + 64]
        qi = torch.arange(q0, q0 + 64)[:, None]
        tiles = min(n_kb, (q_off + q0 + 63) // KT + 1) if causal else n_kb
        acc = torch.zeros(h, 64, d)
        for kb in range(tiles):
            k0 = kb * KT
            ks, vs = kp[:, k0:k0 + KT], vp[:, k0:k0 + KT]
            s = mma(torch.zeros(h, 64, KT), qs, ks.mT)
            dp = mma(torch.zeros(h, 64, KT), dos, vs.mT)
            _, ds = _p_ds(s, dp, lse2[:, q0:q0 + 64, None],
                          dl[:, q0:q0 + 64, None], qi,
                          torch.arange(k0, k0 + KT)[None], sq, sk, causal,
                          scale2)
            acc = mma_split(acc, ds, ks, pieces)
        dq[:, q0:q0 + 64] = acc * _scale(d)
    return dq[:, :sq]


def _inputs(h, sq, sk, d, causal, seed):
    """bfloat16 q, k, v, dO (as float32 arrays for jax), with o, lse and D
    as the backward gets them."""
    rng = np.random.default_rng(seed)
    arrays = [bf16_rn(torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))).numpy()
        for s in ((h, sq, d), (h, sk, d), (h, sk, d), (h, sq, d))]
    tq, tk, tv, tdo = map(torch.from_numpy, arrays)
    o, lse = ref.flash_attention_lse(tq, tk, tv, causal)
    return arrays, (tq, tk, tv, tdo, lse, (tdo * o).sum(-1))


def _jax_grads(q, k, v, do, causal):
    _, vjp = jax.vjp(lambda a, b, c: RK.flash_attention(a, b, c,
                                                        causal=causal),
                     q, k, v)
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _emulated(t, causal, pieces):
    dk, dv = emulate_dkdv(*t, causal, pieces=pieces)
    return emulate_dq(*t, causal, pieces=pieces), dk, dv


# (h, sq, sk, causal): causal with sq < sk, a ragged last tile under both
# masks, the fewest queries the route takes, a block of 128 keys with a
# second ragged one
EDGES = [(2, 70, 100, True), (2, 70, 100, False), (1, 64, 200, True),
         (1, 130, 130, True), (1, 129, 257, False)]


@pytest.mark.parametrize("h,sq,sk,causal", EDGES)
@pytest.mark.parametrize("d", fa.TC_HEAD_DIMS)
def test_forward_emulation_matches_the_reference(d, h, sq, sk, causal):
    arrays, t = _inputs(h, sq, sk, d, causal, seed=d + sq + sk)
    out, lse = emulate_forward(*t[:3], causal)
    want = RK.flash_attention(*map(jnp.asarray, arrays[:3]), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), t[4].numpy(), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("h,sq,sk,causal", EDGES)
@pytest.mark.parametrize("d", fa.TC_HEAD_DIMS)
def test_three_piece_emulation_matches_jax_vjp(d, h, sq, sk, causal):
    arrays, t = _inputs(h, sq, sk, d, causal, seed=d + sq + sk)
    want = _jax_grads(*arrays, causal)
    for got, w, name in zip(_emulated(t, causal, 3), want,
                            ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), w, atol=2e-5, rtol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("h,sq,sk,causal", EDGES)
@pytest.mark.parametrize("d", fa.TC_HEAD_DIMS)
def test_d_from_the_bf16_output_keeps_its_budget(d, h, sq, sk, causal):
    """The model hands the kernels bfloat16 q, k, v, so the forward writes
    O in bfloat16 and ``flash_bwd_preprocess`` reads that O: D =
    rowsum(dO o bf16(O)) is off the float32 D by at most 2^-9
    rowsum|dO o O| (O's rounding), dV does not read D, and dS = P (dP - D)
    carries the rest into dQ and dK. Budget against ``jax.vjp``: dV
    within the same 2e-5 as above, dQ and dK within 2^-8 of max |ref|,
    the order of their own rounding to bfloat16 (up to 2^-9 of each
    element) and a tenth of the GPU tests' 2e-2."""
    arrays, t = _inputs(h, sq, sk, d, causal, seed=d + sq + sk)
    tq, tk, tv, tdo, lse, delta = t
    o = ref.flash_attention_lse(tq, tk, tv, causal)[0]
    d16 = (tdo * bf16_rn(o)).sum(-1)
    assert bool(((d16 - delta).abs()
                 <= 2.0 ** -9 * (tdo * o).abs().sum(-1) + 1e-6).all())
    want = _jax_grads(*arrays, causal)
    got = _emulated((tq, tk, tv, tdo, lse, d16), causal, 3)
    for g, w, name, lim in zip(got, want, ("dq", "dk", "dv"),
                               (2.0 ** -8, 2.0 ** -8, None)):
        if lim is None:
            np.testing.assert_allclose(g.numpy(), w, atol=2e-5, rtol=2e-5,
                                       err_msg=name)
        else:
            assert float(np.abs(g.numpy() - w).max()) <= \
                lim * float(np.abs(w).max()), name


@pytest.mark.parametrize("h,sq,sk,causal", EDGES[:2])
@pytest.mark.parametrize("d", fa.TC_HEAD_DIMS)
def test_one_piece_misses_by_10x_more(d, h, sq, sk, causal):
    """The broken copy: P and dS rounded to one bfloat16 (plain bf16
    flash). Its error against the reference must be at least 10x the
    three pieces', forward and backward, or the tests above could not tell
    them apart."""
    arrays, t = _inputs(h, sq, sk, d, causal, seed=d + sq + sk)
    want = _jax_grads(*arrays, causal)
    want_o = np.asarray(RK.flash_attention(*map(jnp.asarray, arrays[:3]),
                                           causal=causal))

    def err(pieces):
        grads = max(float(np.abs(g.numpy() - w).max())
                    for g, w in zip(_emulated(t, causal, pieces), want))
        out = float(np.abs(emulate_forward(*t[:3], causal, pieces)[0]
                           .numpy() - want_o).max())
        return grads, out
    (g3, o3), (g1, o1) = err(3), err(1)
    assert g1 >= 10 * g3, (g1, g3)
    assert o1 >= 10 * o3, (o1, o3)
