"""llama4-scout-17b-a16e: 48L d_model=5120 40H (GQA kv=8) d_ff=8192,
vocab=202048, MoE 16 experts top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ArchConfig, MoESpec, register

CFG = register(ArchConfig(
    arch_id="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, head_dim=128, activation="swiglu", rope_theta=500000.0,
    moe=MoESpec(n_experts=16, top_k=1, shared_expert=True),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
))
