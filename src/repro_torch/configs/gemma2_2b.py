"""gemma2-2b — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Local+global alternating attention, logit softcaps, tied embeddings,
post-block norms. [arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    attn_type="local_global",
    window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
    pad_heads_to=16,       # 8 -> 16: zero-padded head TP (EXPERIMENTS §Perf it.4)
    post_norm=True,
    source="arXiv:2408.00118",
)
