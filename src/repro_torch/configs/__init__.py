"""Architecture registry: the port's own copy of ``repro/configs`` (data
only; the port imports nothing of the JAX package).

``get_config(name)`` returns the full published config; ``smoke_config(name)``
returns a reduced same-family config small enough for a CPU forward/train step.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (ADCConfig, ArchConfig, MoEConfig,
                                      ShapeConfig, SSMConfig, SHAPES,
                                      applicable_shapes)

_MODULES = {
    "qwen2-vl-72b": "qwen2_vl_72b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "mamba2-1.3b": "mamba2_1p3b",
    "hymba-1.5b": "hymba_1p5b",
    "yi-34b": "yi_34b",
    "deepseek-7b": "deepseek_7b",
    "gemma2-2b": "gemma2_2b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "musicgen-medium": "musicgen_medium",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def smoke_config(name: str) -> ArchConfig:
    """Reduced config of the same family: few layers, narrow width, tiny vocab.

    Keeps every structural feature (GQA ratio, MoE routing, SSD, softcaps,
    M-RoPE sections, frontend+ADC) so the smoke tests exercise the same code
    paths the full config lowers through.
    """
    c = get_config(name)
    kw = dict(
        name=c.name + "-smoke",
        num_layers=2,
        d_model=64,
        vocab_size=128,
        d_ff=128 if c.d_ff else 0,
        window=32,
        dtype="float32",
        param_dtype="float32",
        opt_state_dtype="float32",
        remat="none",
        pad_heads_to=0,           # padded-head TP is a full-mesh concern
    )
    if c.num_heads:
        kw.update(num_heads=4, num_kv_heads=max(1, 4 * c.num_kv_heads // c.num_heads),
                  head_dim=16)
    if c.mrope:
        kw.update(mrope_sections=(2, 3, 3))
    if c.moe is not None:
        kw["moe"] = dataclasses.replace(
            c.moe, num_experts=min(c.moe.num_experts, 8), d_expert=32,
            d_shared=32 if c.moe.num_shared_experts else 0,
            top_k=min(c.moe.top_k, 2))
        kw["d_ff"] = 128
    if c.ssm is not None:
        kw["ssm"] = dataclasses.replace(c.ssm, state_dim=16, head_dim=16,
                                        chunk=8, conv_width=4)
    if c.frontend:
        kw["frontend_dim"] = 24
    if c.adc.enable:
        kw["adc"] = dataclasses.replace(c.adc, bits=3)
    return c.replace(**kw)


__all__ = [
    "ADCConfig", "ArchConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
    "SHAPES", "applicable_shapes", "ARCH_NAMES", "get_config", "smoke_config",
]
