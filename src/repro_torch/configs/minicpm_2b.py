"""minicpm-2b: 40L d_model=2304 36H (kv=36, MHA) d_ff=5760 vocab=122753;
WSD schedule, depth-scaled residuals, tied embeddings (llama-like arch).
[arXiv:2404.06395; hf]"""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    arch_id="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab=122753, head_dim=64, activation="swiglu", tie_embeddings=True,
    residual_scale=1.4 / (40 ** 0.5),      # scale_depth / sqrt(L)
    source="arXiv:2404.06395; hf",
))
