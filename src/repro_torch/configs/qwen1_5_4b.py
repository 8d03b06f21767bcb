"""qwen1.5-4b: 40L d_model=2560 20H (kv=20, MHA) d_ff=6912 vocab=151936,
QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    arch_id="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, d_ff=6912,
    vocab=151936, head_dim=128, qkv_bias=True, activation="swiglu",
    source="hf:Qwen/Qwen1.5-0.5B; hf",
))
