"""hymba-1.5b — 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001
ssm_state=16; parallel attention + mamba heads in every layer.
[arXiv:2411.13676; hf]

Adaptation notes (DESIGN.md §5): meta-tokens are skipped; attention uses a
sliding window (as in all but 3 Hymba layers) which, with the SSM path,
makes the arch sub-quadratic -> long_500k applies.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attn_type="sliding",
    window=1024,
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, ngroups=1,
                  conv_width=4, chunk=256),
    extra_dp=True,
    source="arXiv:2411.13676",
)
