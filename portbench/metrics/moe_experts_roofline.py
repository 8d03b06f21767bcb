"""moe_experts_roofline: the forward expert products' share of their
bound, in %, over the profiled training steps: the work launched inside
the span ``moe.experts`` (``models/moe.py`` ``moe_apply``: gate, up and
down products and SiLU), timed as ``_phase.device_ms`` times it.

The bound of one layer at T tokens, k experts a token, E experts, width
D and expert width F, bf16: FLOPs = 3 products x 2 T k D F, over the
routed pairs alone, so that no padded slot counts and any
implementation of the same routing reads the same work; bytes = the
gathered rows (T k D) read twice, the experts' weights (3 E D F) read,
h_g, h_u and h (T k F each) written and read, and the output rows
(T k D) written, 2 bytes each. Time = the larger of FLOPs over the bf16
rate and bytes over the HBM rate. None where the program opens no such
span or the model has no experts."""
from portbench.metrics._phase import device_ms
from portbench.peaks import BF16_FLOPS, HBM_BYTES

SPAN, PHASE = "moe.experts", "train.forward"


def layer_flops(spec, tokens: int) -> int:
    return 3 * 2 * tokens * spec.moe.top_k * spec.d_model * spec.d_ff


def layer_bytes(spec, tokens: int) -> int:
    pairs, e = tokens * spec.moe.top_k, spec.moe.n_experts
    return 2 * (2 * pairs * spec.d_model + 3 * e * spec.d_model * spec.d_ff
                + 3 * 2 * pairs * spec.d_ff + pairs * spec.d_model)


def layer_bound_s(spec, tokens: int) -> float:
    return max(layer_flops(spec, tokens) / BF16_FLOPS,
               layer_bytes(spec, tokens) / HBM_BYTES)


def read(ctx):
    tr, s = ctx.trace, ctx.spec
    if tr is None or not tr.units or s is None or s.moe is None:
        return None
    ms = device_ms(ctx, SPAN, PHASE)
    if not ms:
        return None
    bound_s = sum(s.n_layers * layer_bound_s(s, u["batch"] * u["seq"])
                  for u in tr.units) / len(tr.units)
    return 100.0 * bound_s * 1e3 / ms
