"""phi3-mini-3.8b — 32L d_model=3072 32H (GQA kv=32 == MHA) d_ff=8192
vocab=32064. RoPE SwiGLU. [arXiv:2404.14219; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    num_heads=32,
    num_kv_heads=32,
    d_model=3072,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    source="arXiv:2404.14219",
)
