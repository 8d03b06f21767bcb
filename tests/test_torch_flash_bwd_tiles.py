"""The flash backward kernels' numeric contract and tile geometry, on the
CPU (``flash_bwd_dkdv_kernel`` and ``flash_bwd_dq_kernel`` in
``src/repro_torch/csrc/flash_attention.cu``).

The kernels run every product on the TF32 tensor cores in three passes
(``mma.sync.m16n8k8`` on hi/lo splits: a b = lo_a hi_b + hi_a lo_b +
hi_a hi_b). A CUDA kernel cannot run here, so a torch emulation of their
tile loop stands in for them: each float32 operand splits into hi =
tf32_rna(x) and lo = tf32_rna(x - hi), with tf32_rna done on the int32
view as ``cvt.rna.tf32.f32`` does it (round to nearest, ties away from
zero, 10 mantissa bits kept); each pass adds one 8-deep TF32 product
(exact in float64) to a float32 accumulator, small terms first, in the
kernels' k order over their tiles (the causal skip included); P and dS
come from the saved lse and D as the kernels form them. The emulation is
held to ``jax.vjp`` of the reference's "full" attention branch within
2e-5, as ``tests/test_torch_train.py`` holds the plain backward, at every
head width and at the tiles' edges; one TF32 pass (hi parts only) must
miss by at least 10x more, so the test can tell the two apart.

The tile constants, the row stride and the per-d shared-memory formula
are read from the CUDA source, as ``tests/test_torch_lanes.py`` reads
``fabric.cu``: the emulation's tiles must be the kernels' tiles, every
d must fit in the 232,448 bytes a block may use, and the source note's
table of bytes must match the formula.
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

# the kernels' tiles (BwdLayout<D>), held to the source below
SMEM_LIMIT = 232448            # bytes a block may use on the H100
LOG2E = np.float32(1.4426950408889634)


def warps(d):
    """Warps a block (``W``)."""
    return 4 if d >= 128 else 8


def rows(d):
    """A block's own keys (dkdv) or queries (dq), 16 a warp (``R``)."""
    return 16 * warps(d)


def query_tile(d):
    """dkdv's streamed query tile (``QT``)."""
    return 32 if d >= 128 else 64


def key_tile(d):
    """dq's streamed key tile (``KT``)."""
    return 32 if d >= 128 else 64


def stride(d):
    """Row stride of every tile in floats (``S``)."""
    return d + 4


def smem_bytes(d):
    """(dkdv, dq) bytes of dynamic shared memory: the block's own two
    tiles; the streamed tile's two landing buffers and four hi and lo
    planes; dkdv's lse and D, landed and for the tile in use."""
    r, s, qt, kt = rows(d), stride(d), query_tile(d), key_tile(d)
    return (4 * (2 * r * s + 6 * qt * s + 4 * qt),
            4 * (2 * r * s + 6 * kt * s))


def _source():
    with open(CSRC) as f:
        return f.read()


def _layout():
    src = _source()
    return src[src.index("struct BwdLayout {"):src.index("};",
                         src.index("struct BwdLayout {"))]


def _per_d(name, d):
    """``static constexpr int name = ...;`` of BwdLayout at D = d: a
    number or a chain of ``cond ? a : b`` over D."""
    m = re.search(rf"int {name} = ([^;]+);", _layout())
    assert m is not None, name
    expr = m[1]
    while "?" in expr:
        cond, rest = expr.split("?", 1)
        a, b = rest.split(":", 1)
        expr = a if eval(cond.replace("D", str(d))) else b
    return int(expr)


# --- geometry --------------------------------------------------------------

@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_tiles_and_stride_match_the_cuda_source(d):
    layout = _layout()
    m = re.search(r"int S = D \+ (\d+);", layout)
    assert m is not None and d + int(m[1]) == stride(d)
    assert re.search(r"int R = 16 \* W;", layout) is not None
    assert _per_d("W", d) == warps(d)
    assert _per_d("QT", d) == query_tile(d)
    assert _per_d("KT", d) == key_tile(d)
    assert query_tile(d) % 8 == 0 and key_tile(d) % 8 == 0


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_registers_fit_the_block(d):
    """At the 255 registers a thread the compiler may use, the block's
    warps fit in the SM's 65,536 registers."""
    assert 32 * warps(d) * 255 <= 65536


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_shared_memory_formula_fits_every_head_dim(d):
    layout = " ".join(_layout().split())
    names = {"R": rows(d), "S": stride(d), "QT": query_tile(d),
             "KT": key_tile(d)}
    got = []
    for which in ("dkdv_bytes", "dq_bytes"):
        m = re.search(rf"size_t {which} = sizeof\(float\) \* \(([^;]+)\);",
                      layout)
        assert m is not None, which
        got.append(4 * eval(m[1], names))
    assert tuple(got) == smem_bytes(d)
    assert max(got) <= SMEM_LIMIT
    # the source note's table states the same bytes
    col = fa.HEAD_DIMS.index(d)
    for which, n in zip(("dkdv", "dq"), got):
        row = re.search(rf"^//\s+{which}\s+([\d, ]+)$", _source(), re.M)
        assert row is not None, which
        assert int(row[1].split()[col].replace(",", "")) == n


# --- the numeric contract --------------------------------------------------

def tf32_rna(x):
    """float32 -> TF32 on the int32 view, as ``cvt.rna.tf32.f32``: add half
    a TF32 unit (bit 12) to the magnitude and clear the 13 low bits, which
    rounds to nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mma(acc, a, b, passes):
    """``acc (.., m, n) += a (.., m, 8) b (.., 8, n)``: three passes (lo hi,
    hi lo, hi hi) or one (hi hi), each an 8-deep TF32 product, exact in
    float64, added to the float32 accumulator with one rounding."""
    ah, al = split(a)
    bh, bl = split(b)
    terms = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    for x, y in terms:
        acc = (acc.double() + x.double() @ y.double()).float()
    return acc


def product(acc, a, b, passes):
    """``acc += a b`` over k in the kernels' order, 8 at a time."""
    for k0 in range(0, a.shape[-1], 8):
        acc = mma(acc, a[..., k0:k0 + 8], b[..., k0:k0 + 8, :], passes)
    return acc


def _pad(x, n):
    out = torch.zeros((x.shape[0], n) + tuple(x.shape[2:]), dtype=x.dtype)
    out[:, :x.shape[1]] = x
    return out


def _p_ds(s, dp, lse2, dl, qi, ki, sq, sk, causal, scale2):
    """P and dS from S and dP as the kernels form them: exp2 of the score
    in log2 units less lse2, exactly 0 where the forward's mask is."""
    q_off = sk - sq
    ok = (qi < sq) & (ki < sk) & ((not causal) | (q_off + qi >= ki))
    p = torch.where(ok, torch.exp2(s * scale2 - lse2), torch.zeros(()))
    return p, p * (dp - dl)


def emulate_dkdv(q, k, v, do, lse, delta, causal, passes=3):
    """dK, dV by ``flash_bwd_dkdv_kernel``'s tile loop: a block per
    ``rows(d)`` keys, the query tiles that see it in order, S^T and dP^T
    over d, then dV += P^T dO and dK += dS^T Q over the tile's queries."""
    h, sq, d = q.shape
    sk = k.shape[1]
    rb, qt, q_off = rows(d), query_tile(d), sk - sq
    scale = np.float32(1.0 / d ** 0.5)
    scale2 = scale * LOG2E
    n_kb, n_qb = -(-sk // rb), -(-sq // qt)
    kp, vp = _pad(k, n_kb * rb), _pad(v, n_kb * rb)
    qp, dop = _pad(q, n_qb * qt), _pad(do, n_qb * qt)
    lse2, dl = _pad(lse * LOG2E, n_qb * qt), _pad(delta, n_qb * qt)
    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)
    for kb in range(n_kb):
        k0 = kb * rb
        kt, vt = kp[:, k0:k0 + rb], vp[:, k0:k0 + rb]
        ki = torch.arange(k0, k0 + rb)[:, None]
        acc_k, acc_v = torch.zeros(h, rb, d), torch.zeros(h, rb, d)
        for qb in range(max(0, k0 - q_off) // qt if causal else 0, n_qb):
            q0 = qb * qt
            qs, dos = qp[:, q0:q0 + qt], dop[:, q0:q0 + qt]
            s = product(torch.zeros(h, rb, qt), kt, qs.mT, passes)
            dp = product(torch.zeros(h, rb, qt), vt, dos.mT, passes)
            p, ds = _p_ds(s, dp, lse2[:, None, q0:q0 + qt],
                          dl[:, None, q0:q0 + qt],
                          torch.arange(q0, q0 + qt)[None], ki, sq, sk,
                          causal, scale2)
            acc_v = product(acc_v, p, dos, passes)
            acc_k = product(acc_k, ds, qs, passes)
        dk[:, k0:k0 + rb], dv[:, k0:k0 + rb] = acc_k * scale, acc_v
    return dk[:, :sk], dv[:, :sk]


def emulate_dq(q, k, v, do, lse, delta, causal, passes=3):
    """dQ by ``flash_bwd_dq_kernel``'s tile loop: a block per ``rows(d)``
    queries, key tiles of ``key_tile(d)`` up to the first past its last
    query, S and dP over d, then dQ += dS K over the tile's keys."""
    h, sq, d = q.shape
    sk = k.shape[1]
    rb, kt, q_off = rows(d), key_tile(d), sk - sq
    scale = np.float32(1.0 / d ** 0.5)
    scale2 = scale * LOG2E
    n_qb, n_kb = -(-sq // rb), -(-sk // kt)
    qp, dop = _pad(q, n_qb * rb), _pad(do, n_qb * rb)
    kp, vp = _pad(k, n_kb * kt), _pad(v, n_kb * kt)
    lse2, dl = _pad(lse * LOG2E, n_qb * rb), _pad(delta, n_qb * rb)
    dq = torch.zeros_like(qp)
    for qb in range(n_qb):
        q0 = qb * rb
        qs, dos = qp[:, q0:q0 + rb], dop[:, q0:q0 + rb]
        qi = torch.arange(q0, q0 + rb)[:, None]
        n_tiles = (min(n_kb, (q_off + q0 + rb - 1) // kt + 1)
                   if causal else n_kb)
        acc = torch.zeros(h, rb, d)
        for kb in range(n_tiles):
            k0 = kb * kt
            ks, vs = kp[:, k0:k0 + kt], vp[:, k0:k0 + kt]
            s = product(torch.zeros(h, rb, kt), qs, ks.mT, passes)
            dp = product(torch.zeros(h, rb, kt), dos, vs.mT, passes)
            _, ds = _p_ds(s, dp, lse2[:, q0:q0 + rb, None],
                          dl[:, q0:q0 + rb, None], qi,
                          torch.arange(k0, k0 + kt)[None], sq, sk,
                          causal, scale2)
            acc = product(acc, ds, ks, passes)
        dq[:, q0:q0 + rb] = acc * scale
    return dq[:, :sq]


def _inputs(h, sq, sk, d, causal, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((h, sq, d), (h, sk, d), (h, sk, d), (h, sq, d)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_attention_lse(tq, tk, tv, causal)
    delta = (tdo * o).sum(-1)
    return (q, k, v, do), (tq, tk, tv, tdo, lse, delta)


def _emulated(t, causal, passes):
    dk, dv = emulate_dkdv(*t, causal, passes=passes)
    return emulate_dq(*t, causal, passes=passes), dk, dv


def _jax_grads(q, k, v, do, causal):
    _, vjp = jax.vjp(lambda a, b, c: RK.flash_attention(a, b, c,
                                                        causal=causal),
                     q, k, v)
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


# (h, sq, sk, causal): causal with sq < sk, a ragged last query tile (70)
# and key tile (100, 130) under both masks, one query, whole tiles
EDGES = [(2, 70, 100, True), (2, 70, 100, False), (1, 1, 77, True),
         (1, 130, 130, True)]


@pytest.mark.parametrize("h,sq,sk,causal", EDGES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_three_pass_emulation_matches_jax_vjp(d, h, sq, sk, causal):
    arrays, t = _inputs(h, sq, sk, d, causal, seed=d + sq + sk)
    want = _jax_grads(*arrays, causal)
    for got, w, name in zip(_emulated(t, causal, 3), want,
                            ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), w, atol=2e-5, rtol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("h,sq,sk,causal", EDGES[:2])
@pytest.mark.parametrize("d", [64, 128])
def test_one_tf32_pass_misses_by_10x_more(d, h, sq, sk, causal):
    """The broken copy: hi parts only, one TF32 pass a product. Its error
    against jax.vjp must be at least 10x the three passes' at the same
    inputs, or the test above could not tell them apart."""
    arrays, t = _inputs(h, sq, sk, d, causal, seed=d + sq + sk)
    want = _jax_grads(*arrays, causal)

    def err(passes):
        return max(float(np.abs(g.numpy() - w).max())
                   for g, w in zip(_emulated(t, causal, passes), want))
    three, one = err(3), err(1)
    assert one >= 10 * three, (one, three)


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),          # 1.0: exact
    (0x3F800FFF, 0x3F800000),          # below half a unit: down
    (0x3F801000, 0x3F802000),          # a tie: away from zero
    (0x3F801001, 0x3F802000),          # above half: up
    (0x3F803000, 0x3F804000),          # a tie with an odd unit: away
    (0xBF801000, 0xBF802000),          # negative tie: away from zero
    (0xBF800FFF, 0xBF800000),          # negative, below half: toward 0
    (0x3FFFF000, 0x40000000),          # carries into the exponent
])
def test_tf32_rna_rounds_ties_away_from_zero(bits, want):
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32)
    got = tf32_rna(x.view(torch.float32)).view(torch.int32)
    assert int(got) & 0xFFFFFFFF == want


def test_split_keeps_float32_grade():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        4096).astype(np.float32))
    hi, lo = split(x)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -21
