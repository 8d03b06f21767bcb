"""yi-9b: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000
(llama-arch GQA). [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    arch_id="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11008,
    vocab=64000, head_dim=128, activation="swiglu",
    source="arXiv:2403.04652; hf",
))
