"""mamba2-1.3b — 48L d_model=2048 attn-free vocab=50280 ssm_state=128.
SSD (state-space duality). [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    use_rope=False,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, ngroups=1,
                  conv_width=4, chunk=256),
    source="arXiv:2405.21060",
)
