"""flash_bwd_roofline (``.train``, ``.small_batch``): the attention backward kernels'
(``flash_bwd_preprocess``, ``flash_bwd_dkdv_kernel``,
``flash_bwd_dq_kernel``) share of their bound, in %, over the profiled
training steps.

The bound of one layer's backward at B rows, H heads, S positions and
head size d, causal, float32 as the kernels take it: FLOPs = 5 products
(the scores again, dV, dP, dQ, dK) x 2 S^2 d x B H, halved by the causal
mask; bytes = the inputs q, k, v, o, dO (B H S d each) and the row
log-sum-exp (B H S) read once, and dQ, dK, dV written once, 4 bytes
each. Time = the larger of FLOPs over the TF32 rate and bytes over the
HBM rate, so no implementation of the same float32 work can read over
100%."""
from portbench.peaks import HBM_BYTES, TF32_FLOPS

KERNELS = ("flash_bwd_preprocess", "flash_bwd_dkdv_kernel",
           "flash_bwd_dq_kernel")


def layer_bound_s(batch: int, heads: int, seq: int, d: int) -> float:
    bh = batch * heads
    flops = 5 * 2 * seq * seq * d * bh / 2
    nbytes = 4 * (8 * bh * seq * d + bh * seq)
    return max(flops / TF32_FLOPS, nbytes / HBM_BYTES)


def read(ctx):
    tr, s = ctx.trace, ctx.spec
    if tr is None:
        return None
    device = tr.device_us(KERNELS) / 1e6
    if device <= 0:
        return None
    bound = sum(s.n_layers * layer_bound_s(u["batch"], s.n_heads, u["seq"],
                                           s.head_dim) for u in tr.units)
    return 100.0 * bound / device
