"""zamba2-2.7b: 54 Mamba2 layers d_model=2560 + shared attention block
(32H kv=32, d_ff=10240) applied periodically, ssm_state=64, vocab=32000.
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ArchConfig, SSMSpec, register

CFG = register(ArchConfig(
    arch_id="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, head_dim=80, activation="gelu", share_every=6,
    ssm=SSMSpec(d_state=64, expand=2, d_conv=4, head_dim=64),
    source="arXiv:2411.15242; hf",
))
