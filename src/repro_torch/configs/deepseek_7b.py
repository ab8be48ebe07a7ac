"""deepseek-7b — 30L d_model=4096 32H (GQA kv=32 == MHA) d_ff=11008
vocab=102400. llama-arch. [arXiv:2401.02954; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
    source="arXiv:2401.02954",
)
