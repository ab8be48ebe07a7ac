"""Config system: frozen dataclasses describing architectures, shapes, meshes.

Every assigned architecture gets one file in this package defining
``CONFIG: ArchConfig``; the registry in ``__init__`` exposes ``get_config``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ADCConfig:
    """Paper technique knobs (binary-search ADC quantizer)."""
    enable: bool = False
    bits: int = 4                 # ADC resolution N -> 2^N levels
    per_channel: bool = True      # one mask/threshold-set per input channel
    vmin: float = 0.0             # analog input range (paper: [0, 1], Vref=1V)
    vmax: float = 1.0


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 1
    d_expert: int = 0             # expert hidden dim (d_ff of each expert)
    num_shared_experts: int = 0
    d_shared: int = 0             # shared-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    first_k_dense: int = 0        # leading dense layers (DeepSeek/Kimi style)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) hyperparameters."""
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    ngroups: int = 1
    conv_width: int = 4
    chunk: int = 256              # SSD chunk length


@dataclass(frozen=True)
class ArchConfig:
    name: str = "unnamed"
    family: str = "dense"         # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2            # 0 for attn-free
    num_kv_heads: int = 2
    d_ff: int = 256
    vocab_size: int = 256
    head_dim: int = 0             # 0 -> d_model // num_heads

    # attention flavour
    attn_type: str = "global"     # global | sliding | local_global
    window: int = 4096
    attn_logit_softcap: float = 0.0    # gemma2: softcap on attn logits
    final_logit_softcap: float = 0.0   # gemma2: softcap on LM logits
    rope_theta: float = 1e4
    use_rope: bool = True
    mrope: bool = False           # qwen2-vl multimodal RoPE (t,h,w sections)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # per half-dim, sums to hd/2

    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    post_norm: bool = False       # gemma2: extra post-block RMSNorm

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[str] = None  # None | 'audio' | 'vision'
    frontend_dim: int = 0           # raw embedding dim from the (stub) frontend
    adc: ADCConfig = field(default_factory=ADCConfig)

    # numerics / training
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "float32"    # stored params
    opt_state_dtype: str = "float32"  # adam m/v (bf16 for XXL models)
    remat: str = "full"             # none | full  (scan-level remat policy)
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    grad_compression: str = "none"  # none | int8  (error-feedback ring)

    # sharding strategy: archs whose attention/SSD heads cannot split over
    # 'model' (24/25/50 heads vs tp=16) use the model axis as EXTRA DATA
    # parallelism instead of leaving it idle (§Perf iteration 2)
    extra_dp: bool = False
    # zero-padded head TP (§Perf iteration 4): grow the q-head axis to a
    # multiple of tp with always-masked heads — mathematically identical
    # outputs (pad head outputs are zeroed before the o-projection, so pad
    # weights receive zero gradient), ~(pad/H) extra attention compute, but
    # restores full 16-way tensor parallelism. 0 = off.
    # Not identical unless num_kv_heads == 1: head i reads kv head
    # i // (H/KV), and padding raises H/KV, so real heads move to other kv
    # heads. The port's models refuse pad_heads_to > num_heads.
    pad_heads_to: int = 0

    @property
    def padded_heads(self) -> int:
        return max(self.pad_heads_to, self.num_heads) if self.num_heads else 0

    # notes for DESIGN/EXPERIMENTS (applicability etc.)
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run 500k-token decode (sub-quadratic / windowed)?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return False

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for roofline MODEL_FLOPS = 6*N*D) ----
    def param_counts(self) -> dict:
        """Returns dict with total and active parameter counts."""
        d, hd = self.d_model, self.resolved_head_dim
        nh, nkv, L, V = self.num_heads, self.num_kv_heads, self.num_layers, self.vocab_size
        embed = V * d
        head = 0 if self.tie_embeddings else V * d
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        dense_mlp = 3 * d * self.d_ff  # SwiGLU: wi, wg, wo
        ssm = 0
        if self.ssm is not None:
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            in_proj = d * (2 * d_in + 2 * s.ngroups * s.state_dim + nheads)
            conv = (d_in + 2 * s.ngroups * s.state_dim) * s.conv_width
            ssm = in_proj + conv + 2 * nheads + d_in + d_in * d
        per_layer_total = per_layer_active = 0
        n_moe_layers = 0
        if self.family == "moe" and self.moe is not None:
            m = self.moe
            n_moe_layers = L - m.first_k_dense
            expert = 3 * d * m.d_expert
            shared = 3 * d * m.d_shared * m.num_shared_experts
            router = d * m.num_experts
            moe_total = m.num_experts * expert + shared + router
            moe_active = m.top_k * expert + shared + router
            per_layer_total = attn + moe_total
            per_layer_active = attn + moe_active
            dense_layers = m.first_k_dense * (attn + dense_mlp)
            total = embed + head + dense_layers + n_moe_layers * per_layer_total + L * 2 * d
            active = embed + head + dense_layers + n_moe_layers * per_layer_active + L * 2 * d
            return {"total": total, "active": active}
        if self.family == "ssm":
            per_layer = ssm
        elif self.family == "hybrid":
            per_layer = attn + ssm + dense_mlp
        else:
            per_layer = attn + dense_mlp
        total = embed + head + L * (per_layer + 2 * d)
        return {"total": total, "active": total}


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # 'train' | 'prefill' | 'decode'


# The four assigned LM shapes (identical across archs).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list:
    """The assigned shape set for one arch, honouring the long_500k rule:
    sub-quadratic archs only (SSM/hybrid); pure full-attention archs skip it.
    """
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.subquadratic:
        out.append(SHAPES["long_500k"])
    return out
