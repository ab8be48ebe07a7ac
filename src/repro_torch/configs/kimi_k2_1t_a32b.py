"""kimi-k2-1t-a32b — 61L d_model=7168 64H (GQA kv=8) d_ff=2048 (expert dim)
vocab=163840, MoE 384 experts top-8 + 1 shared; trillion-param MoE.
[arXiv:2501.kimi2; unverified]

Memory note: at ~1T params this arch *requires* bf16 optimizer state and
FSDP over (pod, data); see EXPERIMENTS.md §Dry-run for per-device bytes.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=18432,                   # dense first layer width (DeepSeek-V3 style)
    vocab_size=163840,
    rope_theta=50_000.0,
    moe=MoEConfig(
        num_experts=384,
        top_k=8,
        d_expert=2048,
        num_shared_experts=1,
        d_shared=2048,
        capacity_factor=1.25,
        first_k_dense=1,
    ),
    param_dtype="bfloat16",       # master-in-bf16: 1T fp32 masters cannot fit
    opt_state_dtype="bfloat16",
    source="arXiv:2501.kimi2",
)
