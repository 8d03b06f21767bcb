"""internvl2-76b: InternViT (stubbed patch embeddings) + 80L LLM backbone
d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
[arXiv:2404.16821; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    arch_id="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab=128256, head_dim=128, activation="swiglu", rope_theta=500000.0,
    n_patches=256,
    source="arXiv:2404.16821; unverified",
))
