"""The arithmetic of two CUDA kernels that cannot run here, emulated in
numpy on the CPU from constants and expressions read out of their sources:

- the ``wgmma_realign`` route of the bfloat16 ``stream_matmul``
  (``src/repro_torch/csrc/stream_matmul.cu``), for rows TMA cannot address
  as they lie. ``repack_rows_kernel`` copies each such operand into
  scratch whose rows are the row length rounded up to 8 elements apart,
  each 16-byte word of the copy taken from the two aligned words of the
  source holding it and shifted by the row's element offset
  (``realign8``: two selects and a funnel shift on 32-bit words); the
  ``wgmma`` kernel then reads the copy through a tensor map that ends at
  the operand's last column. The emulation runs the host's choice of
  copies, the copy kernel's grid and index expressions thread by thread
  on a flat uint16 memory holding each operand at an element offset with
  random bits around it (checking that no word outside the operand is
  read and that every word of the copy is written once), then TMA's boxes
  over the copy (zero past its last row and column) into the 128-byte
  swizzled stages; it holds every stage of every block bit for bit to the
  zero-padded tiles of A and B, and the stages' products to the
  reference's Pallas ``stream_matmul`` (interpret mode on the CPU, as
  ``tests/test_kernels_pallas.py`` runs it) within that file's bfloat16
  tolerance, at every element offset of A's and B's bases, every K % 8
  and N % 8, ragged M, N and K, and K = 0.
- ``flash_bwd_preprocess`` (``src/repro_torch/csrc/flash_attention.cu``):
  D = rowsum(dO o O) with its lanes and rows laid out by ``PreLayout`` and
  summed in its fixed order (each lane's words and elements in order by
  fmaf, then the lane group's butterfly), held to ``jnp.sum(dO * O, -1)``
  on the output of ``jax.vjp`` of the reference attention at every head
  width, in float32 and from bfloat16 inputs.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as RK
from repro.kernels.stream_matmul import stream_matmul as ref_stream_matmul
from repro_torch.kernels import flash_attention as fa

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "csrc")
BF16_TOL = 5e-2                # tests/test_kernels_pallas.py, bfloat16


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


MM_SRC = _source("stream_matmul.cu")


def _const(name, src=MM_SRC):
    """``constexpr int ... name = <expr>`` of the source, evaluated over
    the constants before it."""
    m = re.search(rf"\b{name} =\s*([^,;]+)[,;]", src)
    assert m is not None, name
    expr = m[1]
    for other in re.findall(r"\bk[A-Z]\w*", expr):
        expr = expr.replace(other, str(_const(other, src)))
    return int(eval(expr.replace("/", "//")))


BM, BN, BK = _const("kWBM"), _const("kWBN"), _const("kWBK")
ABYTES, BBYTES, BBOX = _const("kWABytes"), _const("kWBBytes"), _const("kWBBox")
PTHREADS, PROWS = _const("kPThreads"), _const("kPRows")
KERNEL = MM_SRC[MM_SRC.index("repack_rows_kernel("):]
KERNEL = KERNEL[:KERNEL.index("// cuTensorMapEncodeTiled")]
HOST = MM_SRC[MM_SRC.index("long long round8("):]
HOST = HOST[:HOST.index("}  // namespace")]


def _c_expr(expr):
    """A C expression of ints as Python over numpy arrays: casts dropped,
    ``&&`` as ``&`` of its parenthesised terms, integer division."""
    expr = " ".join(expr.split())
    expr = re.sub(r"static_cast<[\w ]+>\(", "(", expr)
    if "&&" in expr:
        return " & ".join(f"({_c_expr(t)})" for t in expr.split("&&"))
    return expr.replace("/", "//")


def _fn(expr, *args):
    """A Python function of ``args`` computing a C expression of the
    kernel (numpy arrays in, elementwise)."""
    return eval(f"lambda {', '.join(args)}: {_c_expr(expr)}")


def _grab(pattern, src=KERNEL):
    m = re.search(pattern, src, re.S)
    assert m is not None, pattern
    return [" ".join(g.split()) for g in m.groups()]


# the copy kernel's expressions, as it writes them
E_AT = _fn(_grab(r"const long long e = (.*?);")[0], "off", "r", "cols", "x")
Q_OF = _fn(_grab(r"const long long q = (.*?);")[0], "e")
S_OF = _fn(_grab(r"const uint32_t s = (.*?);")[0], "e")
HI_IF = _fn(_grab(r"const uint4 hi = (.*?) \?")[0], "s", "q", "src_words")
DST_AT = _fn(_grab(r"dst\[(.*?)\] = realign8")[0], "r", "ld8", "x")
# its grid-stride loops: (first, step) over rows and over a row's words
ROW_LOOP = _grab(r"for \(int r = (.*?); r < rows; r \+= (.*?)\)")
WORD_LOOP = _grab(r"for \(int x = (.*?); x < ld8;\s*x \+= (.*?)\)")
# the host's launch: the source's offset in elements, words a copied row,
# the source's words, the grid
OFF_OF = _fn(_grab(r"const int off = (.*?);", HOST)[0], "at")
LD8_OF = _fn(_grab(r"const int ld8 = (.*?);", HOST)[0].replace(
    "round8(cols)", "((cols + 7) / 8 * 8)"), "cols")
SRC_WORDS = _fn(_grab(r"const long long src_words =\s*(.*?);", HOST)[0],
                "off", "rows", "cols")


def test_the_stage_and_landing_layouts_fit():
    """The wgmma kernel's 4-stage ring fits the block's shared memory; a
    copied row lands on whole 16-byte words; the copy kernel's grid and
    the wgmma kernel's register split fit the card."""
    assert (BM, BN, BK) == (128, 256, 64)
    assert ABYTES == BM * BK * 2 and BBYTES == BN // 64 * BBOX
    assert _const("kWSmem") <= 232448        # a block's shared memory
    for cols in range(1, 40):
        assert LD8_OF(cols) * 8 >= cols and LD8_OF(cols) * 8 - cols < 8
    assert ROW_LOOP == ["blockIdx.y", "gridDim.y"]
    assert WORD_LOOP == ["blockIdx.x * kPThreads + threadIdx.x",
                         "gridDim.x * kPThreads"]
    assert PTHREADS == 256 and PROWS == 65535  # the grid's y limit
    # setmaxnreg moves registers within the block only: the wgmma kernel's
    # 40 + 2 x 232 must fit three times the 168 a thread starts with
    start = 65536 // _const("kWThreads") // 8 * 8
    assert start == _const("kWStartRegs") == 168 and 40 + 2 * 232 <= 3 * start


# --- the copy, thread by thread ---------------------------------------------

def _realign8(lo, hi, s):
    """realign8 on uint32 words: (n, 4) lo and hi, shift s (n,)."""
    x = np.concatenate([lo, hi], axis=1).astype(np.uint64)
    by4, by2 = (s & 4).astype(bool)[:, None], (s & 2).astype(bool)[:, None]
    x[:, :6] = np.where(by4, x[:, 2:8], x[:, :6])
    x[:, :5] = np.where(by2, x[:, 1:6], x[:, :5])
    sh = ((s & 1) * 16).astype(np.uint64)[:, None]
    out = ((x[:, 1:5] << np.uint64(32)) | x[:, :4]) >> sh
    return (out & np.uint64(0xFFFFFFFF)).astype(np.uint32)


class Operand:
    """A (rows, cols) operand in a flat uint16 memory whose element 0
    starts a 16-byte word: its first element at ``off``, random bits
    before and after it. ``direct``: TMA can address it as it lies."""

    def __init__(self, bits, off, rng):
        rows, cols = bits.shape
        n = off + rows * cols
        self.mem = rng.integers(0, 1 << 16, 8 * (-(-n // 8) + 2),
                                dtype=np.uint16)
        self.mem[off:n] = bits.ravel()
        self.rows, self.cols, self.off = rows, cols, off
        self.direct = cols % 8 == 0 and off == 0

    def repack(self):
        """repack_rows into a fresh 16-byte aligned scratch: the copy,
        (rows, ld) uint16, every thread of the grid as the kernel runs
        it."""
        rows, cols = self.rows, self.cols
        off = OFF_OF(2 * self.off)            # the base's bytes past a word
        ld8, src_words = LD8_OF(cols), SRC_WORDS(off, rows, cols)
        gx, gy = -(-ld8 // PTHREADS), min(rows, PROWS)
        words = self.mem.view(np.uint32).reshape(-1, 4)
        # every (r, x) the grid-stride loops visit, with its thread
        r = np.concatenate([np.arange(by, rows, gy) for by in range(gy)])
        x = np.concatenate([np.arange(t, ld8, gx * PTHREADS)
                            for t in range(gx * PTHREADS)])
        r, x = np.repeat(r, x.size), np.tile(x, r.size)
        e = E_AT(off, r, cols, x)
        q, s = Q_OF(e), S_OF(e).astype(np.uint32)
        hi_ok = HI_IF(s, q, src_words)
        # no word of memory outside the operand's words is read
        assert src_words == (off + rows * cols - 1) // 8 + 1
        assert q.min() >= 0 and q.max() < src_words
        assert (q[hi_ok] + 1 < src_words).all()
        lo = words[q]
        hi = np.where(hi_ok[:, None], words[np.where(hi_ok, q + 1, 0)], 0)
        out = _realign8(lo, hi, s).view(np.uint16).reshape(-1, 8)
        dst = DST_AT(r, ld8, x)
        copy = np.full(rows * ld8 * 8, 0xFFFF, np.uint16).reshape(-1, 8)
        written = np.zeros(rows * ld8, int)
        np.add.at(written, dst, 1)
        assert (written == 1).all()           # every word once
        copy[dst] = out
        return copy.reshape(rows, ld8 * 8)

    def tma_source(self):
        """(memory, stride) the wgmma kernel's map reads: the operand as
        it lies, or its copy."""
        if self.direct:
            return self.mem[:self.rows * self.cols], self.cols
        copy = self.repack()
        return copy.ravel(), copy.shape[1]


def _box(mem, stride, n_rows, n_cols, x0, y0, w, h):
    """A TMA box of h rows of w elements at (x0, y0) of a (n_rows,
    n_cols) map with rows ``stride`` apart, zero out of bounds."""
    y = y0 + np.arange(h)[:, None]
    x = x0 + np.arange(w)[None]
    ok = (y < n_rows) & (x < n_cols)
    return np.where(ok, mem[np.where(ok, y * stride + x, 0)], 0).astype(
        np.uint16)


def _swizzled(tile):
    """A (rows, 64) tile as TMA's 128-byte swizzle lays it out, flat."""
    rows = np.arange(tile.shape[0])[:, None]
    chunk = np.arange(64)[None] // 8
    out = np.zeros(tile.size, np.uint16)
    out[rows * 64 + (chunk ^ (rows % 8)) * 8 + np.arange(64)[None] % 8] = tile
    return out


def emulate_stage(a_src, b_src, M, N, K, m0, n0, kt):
    """Block (m0, n0)'s stage kt as TMA leaves it, read back through the
    swizzle as the wgmma descriptors read it: (A tile (BM, BK), B tile
    (BK, 64 n_boxes))."""
    n_boxes = min(BN // 64, (N - n0 + 63) // 64)
    a_stage = _swizzled(_box(*a_src, M, K, kt * BK, m0, BK, BM))
    b_stage = np.concatenate([
        _swizzled(_box(*b_src, K, N, n0 + 64 * q, kt * BK, 64, BK))
        for q in range(n_boxes)])
    assert b_stage.size <= BBYTES // 2 and a_stage.size == ABYTES // 2
    rows = np.arange(BM)[:, None]
    k = np.arange(BK)[None]
    a_tile = a_stage[rows * 64 + ((k // 8) ^ (rows % 8)) * 8 + k % 8]
    kr = np.arange(BK)[:, None]
    n = np.arange(n_boxes * 64)[None]
    b_tile = b_stage[(n // 64) * (BBOX // 2) + kr * 64
                     + (((n % 64) // 8) ^ (kr % 8)) * 8 + n % 8]
    return a_tile, b_tile


def _bf16_bits(rng, shape):
    return rng.standard_normal(shape).astype(jnp.bfloat16).view(np.uint16)


def _f64(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def emulate_realign(a_bits, b_bits, a_off, b_off, seed):
    """C (float32) from the emulated stages, each stage checked against the
    zero-padded tiles of A and B."""
    rng = np.random.default_rng(seed)
    (M, K), N = a_bits.shape, b_bits.shape[1]
    a, b = Operand(a_bits, a_off, rng), Operand(b_bits, b_off, rng)
    a_pad = np.zeros((-(-M // BM) * BM, -(-K // BK) * BK), np.uint16)
    b_pad = np.zeros((a_pad.shape[1], -(-N // BN) * BN), np.uint16)
    a_pad[:M, :K], b_pad[:K, :N] = a_bits, b_bits
    c = np.zeros((a_pad.shape[0], b_pad.shape[1]), np.float64)
    if K == 0:      # the host copies nothing and encodes no map
        return c[:M, :N].astype(np.float32)
    a_src, b_src = a.tma_source(), b.tma_source()
    for m0 in range(0, M, BM):
        for n0 in range(0, N, BN):
            for kt in range(-(-K // BK)):
                k0 = kt * BK
                a_tile, b_tile = emulate_stage(a_src, b_src, M, N, K, m0,
                                               n0, kt)
                w = b_tile.shape[1]
                np.testing.assert_array_equal(
                    a_tile, a_pad[m0:m0 + BM, k0:k0 + BK])
                np.testing.assert_array_equal(
                    b_tile, b_pad[k0:k0 + BK, n0:n0 + w])
                c[m0:m0 + BM, n0:n0 + w] += _f64(a_tile) @ _f64(b_tile)
    return c[:M, :N].astype(np.float32)


# (M, K, N, a_off, b_off): every offset of A's and of B's base, every
# K % 8 and N % 8 (two k stages, two column tiles), ragged M, N and K,
# both operands copied
CASES = ([(130, 72, 264, off, 0) for off in range(1, 8)]
         + [(70, 136, 300, 0, off) for off in range(8)]
         + [(100, 64 + k8, 96, 3, 0) for k8 in range(1, 8)]
         + [(129, 40, 256 + n8, 0, 5) for n8 in range(1, 8)]
         + [(130, 72, 264, 0, 0), (1, 1, 1, 1, 1), (257, 65, 1, 7, 2),
            (1, 130, 257, 0, 0), (200, 7, 513, 6, 3), (9, 9, 9, 0, 0)])


@pytest.mark.parametrize("m,k,n,a_off,b_off", CASES)
def test_realigned_stages_and_product_match_the_reference(m, k, n, a_off,
                                                          b_off):
    rng = np.random.default_rng(m * 1000 + k * 10 + n + a_off + b_off)
    a_bits, b_bits = _bf16_bits(rng, (m, k)), _bf16_bits(rng, (k, n))
    got = emulate_realign(a_bits, b_bits, a_off, b_off, seed=m + n)
    want = ref_stream_matmul(jnp.asarray(a_bits.view(jnp.bfloat16)),
                             jnp.asarray(b_bits.view(jnp.bfloat16)),
                             bm=128, bn=128, bk=128)
    np.testing.assert_allclose(got, np.asarray(want), atol=BF16_TOL,
                               rtol=BF16_TOL)


@pytest.mark.parametrize("m,n,a_off,b_off", [(100, 300, 0, 0),
                                             (1, 1, 5, 3)])
def test_k_zero_gives_zeros_and_loads_nothing(m, n, a_off, b_off):
    """At K = 0 the host needs no scratch and copies nothing, and the
    wgmma kernel runs no k step: C is zeros."""
    body = " ".join(HOST[HOST.index("long long realign_scratch("):].split())
    assert body.split("{", 1)[1].lstrip().startswith(
        "if (K == 0) return 0;")
    assert "K > 0 && !(K % 8 == 0 && aligned16(a))" in HOST
    assert "K > 0 && !(N % 8 == 0 && aligned16(b))" in HOST
    a_bits = np.zeros((m, 0), np.uint16)
    b_bits = np.zeros((0, n), np.uint16)
    got = emulate_realign(a_bits, b_bits, a_off, b_off, seed=0)
    np.testing.assert_array_equal(got, np.zeros((m, n), np.float32))
    want = np.asarray(RK.matmul(jnp.zeros((m, 0), jnp.bfloat16),
                                jnp.zeros((0, n), jnp.bfloat16)))
    np.testing.assert_array_equal(got, want)


def test_realign8_takes_any_eight_of_sixteen():
    """realign8's selects and funnel shift pick elements s .. s + 7 of the
    16 in (lo, hi), at every s."""
    rng = np.random.default_rng(1)
    window = rng.integers(0, 1 << 16, (8, 16), dtype=np.uint16)
    words = window.view(np.uint32)
    s = np.arange(8)
    got = _realign8(words[:, :4], words[:, 4:], s).view(np.uint16)
    want = np.stack([window[i, i:i + 8] for i in s])
    np.testing.assert_array_equal(got, want)


# --- flash_bwd_preprocess ---------------------------------------------------

FA_SRC = _source("flash_attention.cu")


def _pre_layout(d, size):
    """PreLayout<T, d> for sizeof(T) = size, evaluated from the source:
    {V, W, L, P, R, G, ROWS}."""
    body = FA_SRC[FA_SRC.index("struct PreLayout {"):]
    body = body[:body.index("};")]
    loads = _const("kPreLoads", FA_SRC)
    names = {"D": d, "kPreLoads": loads}
    for name, expr in re.findall(r"int (\w+) = ([^;]+);", body):
        expr = expr.replace("static_cast<int>(sizeof(T))", str(size))
        while "?" in expr:
            cond, rest = expr.split("?", 1)
            a, b = rest.split(":", 1)
            expr = a if eval(cond.replace("/", "//"), {}, names) else b
        names[name] = int(eval(expr.replace("/", "//"), {}, names))
    return names


@pytest.mark.parametrize("size", [4, 2])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_preprocess_layout_keeps_four_loads_in_flight(d, size):
    lay = _pre_layout(d, size)
    assert lay["V"] * lay["W"] == d and lay["L"] * lay["P"] == lay["W"]
    assert lay["L"] in (1, 2, 4) and 32 % lay["L"] == 0
    assert lay["R"] * lay["P"] >= _const("kPreLoads", FA_SRC) == 4
    assert lay["ROWS"] == 32 // lay["L"] * lay["R"]


def emulate_preprocess(o, do, size):
    """D by the kernel's lanes and order: (rows, d) float32 inputs (bf16
    values already rounded), fmaf as one rounding of the exact product
    plus the sum."""
    rows, d = o.shape
    lay = _pre_layout(d, size)
    V, LN, P = lay["V"], lay["L"], lay["P"]
    part = np.zeros((rows, LN), np.float32)
    for t in range(LN):
        acc = np.zeros(rows, np.float32)
        for p in range(P):
            for e in range(V):
                col = (t + LN * p) * V + e
                acc = (do[:, col].astype(np.float64) * o[:, col]
                       + acc).astype(np.float32)
        part[:, t] = acc
    off = LN // 2
    while off:
        part = (part + part[:, np.arange(LN) ^ off]).astype(np.float32)
        off //= 2
    assert (part == part[:, :1]).all()        # every lane the same bits
    return part[:, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_preprocess_order_matches_the_reference(d, dtype):
    rng = np.random.default_rng(d)
    h, sq, sk = 3, 37, 50
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((h, sq, d), (h, sk, d), (h, sk, d),
                             (h, sq, d)))
    o, _ = jax.vjp(lambda a, b, c: RK.flash_attention(a, b, c, causal=True),
                   q, k, v)
    o, do = np.asarray(o), do
    if dtype == "bfloat16":
        o, do = (x.astype(jnp.bfloat16).astype(np.float32) for x in (o, do))
    want = np.asarray(jnp.sum(jnp.asarray(do) * jnp.asarray(o), -1))
    got = emulate_preprocess(o.reshape(-1, d), do.reshape(-1, d),
                             4 if dtype == "float32" else 2)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.reshape(h, sq), want, rtol=0,
                               atol=1e-5 * scale)
