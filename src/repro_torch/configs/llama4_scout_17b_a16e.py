"""llama4-scout-17b-a16e — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + 1 shared expert; early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,                    # dense-layer / reference ff width
    vocab_size=202048,
    rope_theta=500_000.0,
    pad_heads_to=48,       # 40 -> 48: zero-padded head TP (EXPERIMENTS §Perf it.4)
    moe=MoEConfig(
        num_experts=16,
        top_k=1,
        d_expert=8192,
        num_shared_experts=1,
        d_shared=8192,
        capacity_factor=1.25,
        first_k_dense=0,
    ),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
