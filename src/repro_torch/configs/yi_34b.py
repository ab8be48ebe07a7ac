"""yi-34b — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
llama-arch GQA. [arXiv:2403.04652; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    pad_heads_to=64,       # 56 -> 64: zero-padded head TP (EXPERIMENTS §Perf it.4)
    source="arXiv:2403.04652",
)
