"""flash_fwd_roofline (``.prefill``): the attention forward kernel's
(``flash_kernel``) share of its bound, in %, over the profiled prefill
batches.

The bound of one layer at B rows, H query heads (the kv heads repeated
to them), S positions and head size d, causal, float32 as the kernel
takes them: FLOPs = 2 products (scores, values) x 2 S^2 d x B H, halved
by the causal mask; bytes = q, k, v read once and o written once, B H S d
each, 4 bytes. Time = the larger of FLOPs over the TF32 rate and bytes
over the HBM rate."""
from portbench.peaks import HBM_BYTES, TF32_FLOPS

KERNELS = ("flash_kernel",)


def layer_bound_s(batch: int, heads: int, seq: int, d: int) -> float:
    bh = batch * heads
    flops = 2 * 2 * seq * seq * d * bh / 2
    nbytes = 4 * 4 * bh * seq * d
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
