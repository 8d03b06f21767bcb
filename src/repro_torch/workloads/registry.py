"""WorkloadClass registry: real model-layer compute as serve request classes
(counterpart of ``repro.workloads.registry``).

Each entry bridges one per-layer op onto the fabric as a first-class config
class for ``repro_torch.serve`` / ``repro_torch.fleet``: a traced
fixed-point kernel (``workloads/kernels.py``), a seeded input generator
(ranges chosen so every intermediate stays inside int32 — the precondition
for the oracle equivalence), an independent oracle closure, an arrival-mix
weight, and the *expected* ``backend_skip_reason`` on the accelerator
backend (None means the class must run there). The field keeps the
reference's name, ``pallas_skip``: the port's ``"cuda"`` capability set
equals the reference ``"pallas"`` set, so the reason is the same on both.
Labels, ranges, weights, ``compile_kwargs`` and ``exactness`` strings are
the reference's, and :meth:`WorkloadClass.gen_inputs` draws from ``rng``
in the reference's order, so one seed gives one stream in both packages.

The registry is the single source of truth consumed by:

  * ``serve/load.py`` — ``model_recipes()`` / ``model_classes()`` and the
    per-class input generators (``workload_input_gen``);
  * ``fleet`` placement / DSE — model labels resolve through the same
    ``mix_recipes`` the paper classes use, so geometry cost tables and
    routing need no special cases;
  * ``bench_serve.soak(mix="model")`` — the soak re-verifies every served
    response against the oracle (``oracle_checked`` / ``oracle_mismatches``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.workloads import kernels as WK


@dataclasses.dataclass(frozen=True)
class WorkloadClass:
    """One model-layer op registered as a serve/fleet request class."""

    label: str                         # config-class label in the mix
    layer: str                         # transformer | attention | ssm | moe
    description: str
    build: Callable[[], Callable]      # -> python fn for the frontend
    compile_kwargs: Mapping[str, object]
    # seeded input generation: {stream name: (lo, hi)} half-open ranges,
    # in traced-argument order (names must match the traced fn's args)
    inputs: Mapping[str, Tuple[int, int]]
    oracle: Callable                   # (**streams) -> tuple of int32 arrays
    weight: float                      # relative arrival-mix weight
    pallas_skip: Optional[str]         # expected backend_skip_reason there
    exactness: str                     # the per-class oracle contract
    float_ref: Optional[Callable]      # (inputs, outputs)->(got, want, atol)

    def gen_inputs(self, length: int,
                   rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """Seeded input streams, consumed from ``rng`` in a fixed order —
        part of the serve/fleet replay contract."""
        return {name: rng.integers(lo, hi, length).astype(np.int32)
                for name, (lo, hi) in self.inputs.items()}


_BIT_EXACT = "bit-exact int32 vs jnp oracle on every eligible backend"

MODEL_CLASSES: Dict[str, WorkloadClass] = {}


def _register(wc: WorkloadClass) -> None:
    if wc.label in MODEL_CLASSES:
        raise ValueError(f"duplicate workload class {wc.label!r}")
    MODEL_CLASSES[wc.label] = wc


_register(WorkloadClass(
    label="ln_affine", layer="transformer",
    description="LayerNorm/RMSNorm scale-shift fused with the residual add",
    build=WK.ln_affine_fn, compile_kwargs={},
    inputs={"x": (-2048, 2048), "r": (-2048, 2048)},
    oracle=WK.ln_affine_oracle, weight=2.0, pallas_skip=None,
    exactness=_BIT_EXACT + "; float affine+residual within atol 0.02",
    float_ref=WK.ln_affine_float))

_register(WorkloadClass(
    label="silu_q", layer="transformer",
    description="MLP activation: hard-SiLU piecewise fixed-point pipeline",
    build=WK.silu_q_fn, compile_kwargs={},
    inputs={"x": (-2048, 2048)},
    oracle=WK.silu_q_oracle, weight=1.5, pallas_skip=None,
    exactness=_BIT_EXACT + "; float h-swish within atol 0.02",
    float_ref=WK.silu_q_float))

_register(WorkloadClass(
    label="swiglu_ms", layer="transformer",
    description="SwiGLU MLP gate under pe_limit -> multi-shot plan",
    build=WK.swiglu_fn, compile_kwargs={"pe_limit": 4},
    inputs={"g": (-2048, 2048), "u": (-2048, 2048)},
    oracle=WK.swiglu_oracle, weight=0.75, pallas_skip=None,
    exactness=_BIT_EXACT + "; float hswish(g)*u within atol 0.2",
    float_ref=WK.swiglu_float))

_register(WorkloadClass(
    label="attn_score", layer="attention",
    description="attention-score row dot tile (flash_attention q.k piece)",
    build=WK.attn_score_fn, compile_kwargs={},
    inputs={"q": (-1024, 1024), "k": (-1024, 1024)},
    oracle=WK.attn_score_oracle, weight=1.5, pallas_skip=None,
    exactness=_BIT_EXACT + "; float dot within atol length/128",
    float_ref=WK.attn_score_float))

_register(WorkloadClass(
    label="softmax_den", layer="attention",
    description="softmax denominator: exp2 exponent/mantissa + accumulator",
    build=WK.softmax_denom_fn, compile_kwargs={},
    inputs={"x": (-2048, 1)},          # max-shifted logits, <= 0
    oracle=WK.softmax_denom_oracle, weight=1.0, pallas_skip=None,
    exactness=_BIT_EXACT + "; float sum(exp2) within rel 0.08",
    float_ref=WK.softmax_denom_float))

_register(WorkloadClass(
    label="ssm_scan", layer="ssm",
    description="selective SSD recurrence h = a_t*h + u_t (lax.scan)",
    build=WK.ssm_scan_fn, compile_kwargs={},
    inputs={"u": (-2048, 2048), "a": (0, WK.SSM_DECAY_MAX + 1)},
    oracle=WK.ssm_scan_oracle, weight=0.75, pallas_skip="loop-state",
    exactness=_BIT_EXACT + " (sim); float recurrence within atol 0.05",
    float_ref=WK.ssm_scan_float))

_register(WorkloadClass(
    label="ssm_relax", layer="ssm",
    description="implicit SSM step by fixed-point iteration "
                "(demand-gated loop, data-dependent trip count)",
    build=WK.ssm_relax_fn, compile_kwargs={},
    inputs={"x": (1, 2048)},
    oracle=WK.ssm_relax_oracle, weight=0.5,
    pallas_skip="loop-state+recirculation",
    exactness=_BIT_EXACT + " (sim); float fixed point within atol 0.04",
    float_ref=WK.ssm_relax_float))

_register(WorkloadClass(
    label="moe_gate", layer="moe",
    description="MoE top-1-of-2 routing as Branch/Merge expert select",
    build=WK.moe_gate_fn, compile_kwargs={},
    inputs={"x": (-2048, 2048), "s": (-256, 256)},
    oracle=WK.moe_gate_oracle, weight=1.0, pallas_skip=None,
    exactness=_BIT_EXACT + "; float routed expert within atol 0.01",
    float_ref=WK.moe_gate_float))


# the served model mix, in a stable order (fleet configs carry tuples)
MODEL_MIX: Tuple[str, ...] = tuple(sorted(MODEL_CLASSES))


def model_recipes(length: int) -> Dict[str, tuple]:
    """The model-layer mix as uncompiled recipes in the serve/fleet recipe
    shape ``{label: (factory, compile_kwargs)}`` — factories return the
    *python function* to trace (``serve/load.py::compile_recipe`` passes
    the stream length), where the paper classes return ready DFGs."""
    return {label: (wc.build, dict(wc.compile_kwargs))
            for label, wc in MODEL_CLASSES.items()}


def model_weights() -> Dict[str, float]:
    """Arrival-mix weights of the model classes (transformer-block-heavy:
    two norms + activations per attention tile, sparse MoE/SSM traffic)."""
    return {label: wc.weight for label, wc in MODEL_CLASSES.items()}


def workload_input_gen(label: str) -> Optional[Callable]:
    """The per-class seeded input generator ``(length, rng) -> streams``,
    or None for labels outside the model registry (paper classes keep the
    generic ``request_inputs`` ranges)."""
    wc = MODEL_CLASSES.get(label)
    return wc.gen_inputs if wc is not None else None
