"""whisper-base: enc-dec, 6L encoder + 6L decoder, d_model=512 8H (MHA)
d_ff=2048 vocab=51865; conv frontend stubbed (precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig, EncDecSpec, register

CFG = register(ArchConfig(
    arch_id="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab=51865, head_dim=64, activation="gelu", norm="ln",
    tie_embeddings=True, encdec=EncDecSpec(n_enc_layers=6, enc_len=1500),
    source="arXiv:2212.04356; unverified",
))
