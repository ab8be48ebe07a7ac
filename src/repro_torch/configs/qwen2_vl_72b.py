"""qwen2-vl-72b — 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]. Vision frontend is a STUB:
input_specs() provides precomputed patch embeddings; backbone consumes them.
"""
from repro_torch.configs.base import ADCConfig, ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    rope_theta=1_000_000.0,
    mrope=True,
    mrope_sections=(16, 24, 24),
    frontend="vision",
    frontend_dim=1280,            # ViT patch embedding width (stub)
    adc=ADCConfig(enable=True, bits=4),   # paper technique on the analog frontend
    opt_state_dtype="float32",
    source="arXiv:2409.12191",
)
