"""mfu (``.train``, ``.small_batch``, ``.prefill``): the model FLOPs of the
measured window's work over its time, as a share of the H100's bf16 peak,
in %.

N_body counts the weights of every product in the layers: per layer the
q, k, v and output projections and the SwiGLU's three, or in a MoE layer
the top-k experts' three and the router. The attention products of one
row of S tokens are, per layer, 2 products x 2 S^2 d x H heads, halved
by the causal mask.

* A training step (mix kind ``train``) = 6 x N_matmul x tokens + 3 x the
  attention products, where N_matmul adds the LM head at the published
  vocabulary to N_body.
* A prefill batch of B prompts of S tokens (mix kind ``prefill``) = 2 x
  N_body x B S + 2 x d x vocab x B + the attention products: the LM head
  counts once a prompt, since a prefill hands out the last position's
  logits only."""
from portbench.peaks import BF16_FLOPS


def body_params(s) -> int:
    hq, hkv = s.n_heads * s.head_dim, s.n_kv_heads * s.head_dim
    attn = 2 * s.d_model * hq + 2 * s.d_model * hkv
    if s.moe is None:
        mlp = 3 * s.d_model * s.d_ff
    else:
        mlp = s.moe.top_k * 3 * s.d_model * s.d_ff \
            + s.d_model * s.moe.n_experts
    return s.n_layers * (attn + mlp)


def matmul_params(s) -> int:
    return body_params(s) + s.d_model * s.vocab


def attention_flops(s, batch: int, seq: int) -> int:
    return s.n_layers * batch * 2 * seq * seq * s.head_dim * s.n_heads


def step_flops(s, batch: int, seq: int) -> int:
    return 6 * matmul_params(s) * batch * seq \
        + 3 * attention_flops(s, batch, seq)


def batch_flops(s, batch: int, seq: int) -> int:
    return 2 * body_params(s) * batch * seq + 2 * s.d_model * s.vocab * batch \
        + attention_flops(s, batch, seq)


def read(ctx):
    w = ctx.window
    if not w["units"] or w["seconds"] <= 0:
        return None
    per = step_flops if ctx.mix["kind"] == "train" else batch_flops
    flops = sum(per(ctx.spec, u["batch"], u["seq"]) for u in w["units"])
    return 100.0 * flops / (w["seconds"] * BF16_FLOPS)
