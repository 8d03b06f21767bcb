"""The port's frontend held against the reference's (``repro.frontend``).

  * every form the reference can trace here lowers to a DFG whose
    ``canonical_signature()`` equals that of the reference trace carried
    across by ``convert.dfg_from_reference``;
  * ``offload(backend="cuda", device="cpu")`` (the lane kernel's plain
    version) equals the reference ``offload(backend="pallas")`` (its Pallas
    kernels in interpret mode) bit for bit, with equal ``kernel.last.cycles``;
  * the compile cache behaves as the reference's: captured constants key,
    repeat calls hit, and two ``torch.cond`` kernels that differ only in a
    branch body get different digests.

Forms through ``jnp.where``, ``jnp.clip`` or ``//`` are left out: the
reference tracer cannot trace them under the installed JAX (its jaxpr call
primitive is ``jit``, the tracer handles ``pjit``); the port's versions of
those are held to the hand-built ``kernels_lib`` DFGs and to numpy in
``tests/test_torch_frontend.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from torch._higher_order_ops.scan import scan

from repro.core import kernels_lib as RK
from repro.frontend import offload as ref_offload
from repro.frontend import trace as ref_trace
from repro_torch.convert import dfg_from_reference
from repro_torch.core import kernels_lib as K
from repro_torch.engine import ArtifactCache, Engine
from repro_torch.engine import compile as port_compile
from repro_torch.frontend import offload, trace

WR, WI = 23170, -23170
LENGTH = 48


def _fft_j(ar, ai, br, bi):
    tr = br * WR - bi * WI
    ti = br * WI + bi * WR
    return ar + tr, ai + ti, ar - tr, ai - ti


def _dither_j(x):
    def f(err, xi):
        v = xi + err
        o = (v > 127).astype(jnp.int32) * 255
        return v - o, o
    _, ys = lax.scan(f, 0, x)
    return ys


def _dither_t(x):
    def f(err, xi):
        v = xi + err
        o = (v > 127).to(torch.int32) * 255
        return v - o, o
    _, ys = scan(f, torch.zeros((), dtype=torch.int32), x)
    return ys


def _diff_j(x):
    _, ys = lax.scan(lambda p, xi: (xi, xi - p), 0, x)
    return ys


def _diff_t(x):
    _, ys = scan(lambda p, xi: (xi.clone(), xi - p),
                 torch.zeros((), dtype=torch.int32), x)
    return ys


def _cond_j(x):
    return lax.cond(x > 0, lambda v: v + 1, lambda v: v * 2, x)


def _cond_t(x):
    return torch.cond(x > 0, lambda v: v + 1, lambda v: v * 2, (x,))


# (reference JAX form, port torch form) — one stream argument per name
FORMS = {
    "arith": (lambda x, y: (x + y, x - y, x * y),
              lambda x, y: (x + y, x - y, x * y)),
    "bitwise": (lambda x, y: (x & y, x | y, x ^ y),
                lambda x, y: (x & y, x | y, x ^ y)),
    "shl": (lambda x: x << 3, lambda x: x << 3),
    "shr": (lambda x: x >> 2, lambda x: x >> 2),
    "neg": (lambda x: -x, lambda x: -x),
    "pow3": (lambda x: x ** 3, lambda x: x ** 3),
    "rsub": (lambda x: 7 - x, lambda x: 7 - x),
    "min": (lambda x, y: jnp.minimum(x, y),
            lambda x, y: torch.minimum(x, y)),
    "max": (lambda x, y: jnp.maximum(x, y),
            lambda x, y: torch.maximum(x, y)),
    "relu_max": (lambda x: jnp.maximum(x, 0),
                 lambda x: torch.clamp(x, min=0)),
    "ge": (lambda x, y: (x >= y).astype(jnp.int32),
           lambda x, y: (x >= y).to(torch.int32)),
    "le": (lambda x, y: (x <= y).astype(jnp.int32),
           lambda x, y: (x <= y).to(torch.int32)),
    "ne": (lambda x, y: (x != y).astype(jnp.int32),
           lambda x, y: (x != y).to(torch.int32)),
    "eq": (lambda x, y: (x == y).astype(jnp.int32),
           lambda x, y: (x == y).to(torch.int32)),
    "lt": (lambda x, y: (x < y).astype(jnp.int32),
           lambda x, y: (x < y).to(torch.int32)),
    "fft": (_fft_j, _fft_j),
    "axpby": (lambda x, y: 3 * x + 5 * y, lambda x, y: 3 * x + 5 * y),
    "mac1_sum": (lambda a, b0: jnp.sum(a * b0),
                 lambda a, b0: torch.sum(a * b0)),
    "mac1_dot": (lambda a, b: jnp.dot(a, b), lambda a, b: torch.dot(a, b)),
    "cond": (_cond_j, _cond_t),
    "while_div": (RK.loop_div_fn(7), K.loop_div_fn(7)),
    "while_isqrt": (RK.loop_isqrt_fn(), K.loop_isqrt_fn()),
    "scan_dither": (_dither_j, _dither_t),
    "scan_diff": (_diff_j, _diff_t),
}


def _signature(g):
    return g.canonical_signature()


@pytest.mark.parametrize("name", sorted(FORMS))
def test_traced_signature_equals_reference_trace(name):
    jfn, tfn = FORMS[name]
    ref = dfg_from_reference(ref_trace(jfn, LENGTH, name=name))
    got = trace(tfn, LENGTH, name=name)
    assert _signature(got) == _signature(ref)
    assert len(got.inputs) == len(ref.inputs)
    assert got.outputs == ref.outputs


def test_engine_compile_of_a_callable_equals_reference_compile():
    """``compile(fn, length)`` and ``Engine.compile(fn, length=...)`` take
    torch callables and plan them as the reference plans its trace."""
    from repro.engine import ArtifactCache as RCache
    from repro.engine import compile as ref_compile
    jfn, tfn = FORMS["fft"]
    ra = ref_compile(jfn, 64, cache=RCache(memory_only=True), name="fft")
    pa = port_compile(tfn, 64, cache=ArtifactCache(memory_only=True),
                      name="fft")
    assert _signature(pa.dfg) == _signature(dfg_from_reference(ra.dfg))
    assert pa.out_shapes == ra.out_shapes == [(64,)] * 4
    eng = Engine(backend="cuda", device="cpu",
                 cache=ArtifactCache(memory_only=True))
    art = eng.compile(tfn, length=64, name="fft")
    rng = np.random.default_rng(5)
    ins = {n: rng.integers(-4096, 4096, 64).astype(np.int32)
           for n in art.dfg.inputs}
    outs = eng.run(art, ins)
    ref = [np.asarray(o) for o in jfn(*[jnp.asarray(ins[n])
                                        for n in art.dfg.inputs])]
    for i, r in enumerate(ref):
        np.testing.assert_array_equal(outs[f"out{i}"], r)


# ---------------------------------------------------------------------------
# offload: "cuda" on the CPU against the reference "pallas" (interpret mode)
# ---------------------------------------------------------------------------

def _big(x, y):
    t = x
    for i in range(1, 23):                 # 22 ALU pairs -> 66 PEs
        t = t * 3 + y + i
    return t


@pytest.mark.parametrize("name,n_in,length", [
    ("axpby", 2, 200), ("mac1_sum", 2, 64), ("cond", 1, 64),
    ("big", 2, 64)])
def test_offload_cuda_equals_reference_pallas(name, n_in, length):
    from repro.engine import ArtifactCache as RCache

    from repro_torch.kernels import fabric_reduce as fr
    jfn, tfn = FORMS[name] if name in FORMS else (_big, _big)
    rng = np.random.default_rng(11)
    ins = [rng.integers(-1000, 1000, length).astype(np.int32)
           for _ in range(n_in)]
    kr = ref_offload(jfn, backend="pallas", name=name,
                     cache=RCache(memory_only=True))
    kp = offload(tfn, backend="cuda", device="cpu", name=name, debug=True,
                 cache=ArtifactCache(memory_only=True))
    plain = fr.plain_calls
    want, got = kr(*ins), kp(*ins)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(g).shape == np.asarray(w).shape
    assert kp.last.n_shots == kr.last.n_shots
    assert kp.last.cycles == kr.last.cycles
    assert fr.plain_calls == plain + kp.last.n_shots
    if kp.last.n_shots > 1:
        assert vars(kp.last.tally) == vars(kr.last.tally)


# ---------------------------------------------------------------------------
# the compile cache
# ---------------------------------------------------------------------------

def test_offload_cache_keys_captured_constants_as_the_reference():
    def make_ref(c):
        cc = jnp.int32(c)
        return ref_offload(lambda x: x * cc, name=f"capt{c}")

    def make_port(c):
        cc = torch.tensor(c, dtype=torch.int32)
        return offload(lambda x: x * cc, name=f"capt{c}")

    x = np.arange(8, dtype=np.int32)
    for make in (make_ref, make_port):
        k3, k5 = make(3), make(5)
        np.testing.assert_array_equal(k3(x), 3 * x)
        np.testing.assert_array_equal(k5(x), 5 * x)
        assert not (set(k3._cache) & set(k5._cache))


def test_offload_cache_hits_as_the_reference():
    jfn, tfn = FORMS["axpby"]
    rng = np.random.default_rng(3)
    x = rng.integers(-10, 10, 40).astype(np.int32)
    y = rng.integers(-10, 10, 40).astype(np.int32)
    infos = []
    for k in (ref_offload(jfn, name="ax_hits"),
              offload(tfn, name="ax_hits")):
        seq = []
        for a, b in ((x, y), (x + 1, y - 1), (np.resize(x, 72),
                                               np.resize(y, 72)), (x, y)):
            k(a, b)
            seq.append(k.cache_info())
        infos.append(seq)
    assert infos[0] == infos[1] == [(0, 1, 1), (1, 1, 1), (1, 2, 2),
                                    (2, 2, 2)]


def test_cond_kernels_differing_in_a_branch_body_get_different_digests():
    """The digest covers every subgraph: ``gm.code`` of the top graph names
    ``true_graph_0`` without its body, so two cond kernels that differ only
    inside a branch must still key apart."""
    from repro_torch.engine.compiler import fn_cache_key

    def k_add(x):
        return torch.cond(x > 0, lambda v: v + 1, lambda v: v * 2, (x,))

    def k_sub(x):
        return torch.cond(x > 0, lambda v: v - 1, lambda v: v * 2, (x,))

    geo = (4, 4, 4, 4)
    d_add, tg_add, em_add = fn_cache_key(k_add, 16, "auto", "cuda", geo,
                                         ["x"])
    d_sub, tg_sub, em_sub = fn_cache_key(k_sub, 16, "auto", "cuda", geo,
                                         ["x"])
    assert em_add and em_sub
    assert tg_add.gm.code == tg_sub.gm.code          # the top graph agrees
    assert d_add != d_sub
    assert fn_cache_key(k_add, 16, "auto", "cuda", geo, ["x"])[0] == d_add
    x = np.arange(-8, 8, dtype=np.int32)
    ka = offload(k_add, backend="cuda", device="cpu")
    ks = offload(k_sub, backend="cuda", device="cpu")
    np.testing.assert_array_equal(ka(x), np.where(x > 0, x + 1, x * 2))
    np.testing.assert_array_equal(ks(x), np.where(x > 0, x - 1, x * 2))


def test_frontend_error_has_one_home():
    import repro_torch.frontend as F
    from repro_torch.frontend import partition, tracer
    assert partition.FrontendError is tracer.FrontendError
    assert F.FrontendError is tracer.FrontendError
    assert issubclass(tracer.UnsupportedPrimitiveError, tracer.FrontendError)


def test_traced_loops_raise_capability_error_on_cuda():
    """Loop kernels are outside the cuda capability set: they fail at
    compile time naming the feature, as on the reference's pallas, and
    never run on the CPU."""
    from repro_torch.engine import CapabilityError
    from repro_torch.kernels import fabric_reduce as fr
    feature = {"div_iter": "recirculation edge", "isqrt":
               "recirculation edge", "clip_scan": "loop-carried back edge",
               "gemv_early": "loop-carried back edge"}
    plain = fr.plain_calls
    for name, (make, n_in) in K.TRACED_LOOPS.items():
        k = offload(make(), backend="cuda", device="cpu", name=name)
        with pytest.raises(CapabilityError, match=feature[name]):
            k(*[np.arange(16, dtype=np.int32)] * n_in)
    assert fr.plain_calls == plain
