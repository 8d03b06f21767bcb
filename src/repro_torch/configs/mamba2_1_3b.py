"""mamba2-1.3b: 48L d_model=2048 attention-free SSD (state-space duality),
ssm_state=128, vocab=50280. [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig, SSMSpec, register

CFG = register(ArchConfig(
    arch_id="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, tie_embeddings=True,
    ssm=SSMSpec(d_state=128, expand=2, d_conv=4, head_dim=64),
    source="arXiv:2405.21060; unverified",
))
