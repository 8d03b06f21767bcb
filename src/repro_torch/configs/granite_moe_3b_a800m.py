"""granite-moe-3b-a800m: 32L d_model=1536 24H (GQA kv=8) d_ff=512,
vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]"""
from repro_torch.configs.base import ArchConfig, MoESpec, register

CFG = register(ArchConfig(
    arch_id="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155, head_dim=64, activation="swiglu",
    moe=MoESpec(n_experts=40, top_k=8),
    source="hf:ibm-granite/granite-3.0-3b-a800m-base; hf",
))
