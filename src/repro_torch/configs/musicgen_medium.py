"""musicgen-medium — 48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048.
Decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

The EnCodec frontend is a STUB: input_specs() provides precomputed frame
embeddings. This is the MOST paper-representative arch: the frame embeddings
pass through the PrunedADC quantizer (EnCodec's 2048-entry codebook is an
11-bit "ADC"); the paper's in-training level pruning applies per channel.
"""
from repro_torch.configs.base import ADCConfig, ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    use_rope=False,               # MusicGen uses (sinusoidal) positions, not RoPE
    frontend="audio",
    frontend_dim=128,             # EnCodec latent frame width (stub)
    adc=ADCConfig(enable=True, bits=4),
    extra_dp=True,
    source="arXiv:2306.05284",
)
