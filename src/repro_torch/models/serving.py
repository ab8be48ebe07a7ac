"""LM serving: prefill (builds the KV cache) and single-token decode, for
the dense, audio and moe families. Counterpart of those branches of
``repro/models/serving.py``.

Cache (leading L = stacked layers): ring buffers ``k``/``v``
(L, B, C, KV, hd) in cfg.dtype with C = min(S, window) for sliding
attention and S otherwise (S = prompt length + ``extra_slots``), ``kpos``
(C,) int32 absolute positions (-1 = empty slot) and ``pos`` () int32, the
next position. A moe config with ``first_k_dense`` adds ``k_pre``/
``v_pre`` (first_k_dense, B, S, KV, hd) for its dense prelayers, which
share ``kpos`` (moe attends globally, so C = S). The reference's ring
semantics are kept exactly: decode writes the new token at slot ``pos %
C`` and attends to that slot too, so with ``extra_slots=0`` it evicts
StreamingLLM-style.

``decode_step`` updates the cache's ``k``, ``v`` (``k_pre``, ``v_pre``)
and ``kpos`` in place and returns the same tensors under a new dict with
``pos + 1`` (the reference's launcher donates the cache too): clone a
cache that is still needed. Prefill attention runs the flash-attention
kernel on a CUDA tensor (models/layers.py); decode attention is plain
PyTorch, as it is plain jnp in the reference. The moe layers route with
the prefill capacity in prefill and the decode capacity in decode
(``models/moe.py``), the reference's semantics: so for moe, decode after
prefill is not teacher forcing.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Cache = Dict[str, torch.Tensor]


def attn_cache_len(cfg: ArchConfig, seq_len: int, *, local: bool) -> int:
    if local or cfg.attn_type == "sliding":
        return min(cfg.window, seq_len)
    return seq_len


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               device=None) -> Cache:
    """Empty decode cache sized for a context of ``seq_len``."""
    T.check_supported(cfg)
    dt = T.torch_dtype(cfg.dtype)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    w = attn_cache_len(cfg, seq_len, local=False)

    def kvbuf(n, length):
        return torch.zeros((n, batch, length, kv, hd), dtype=dt,
                           device=device)

    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device),
             "k": kvbuf(T.scan_len(cfg), w), "v": kvbuf(T.scan_len(cfg), w),
             "kpos": torch.full((w,), -1, dtype=torch.int32, device=device)}
    if T.first_k_dense(cfg):
        npre = T.first_k_dense(cfg)
        cache.update(k_pre=kvbuf(npre, seq_len), v_pre=kvbuf(npre, seq_len))
    return cache


# ----------------------------------------------------------------- decode
def _attend_decode(p, x, kc, vc, kpos, slot, cfg: ArchConfig, positions, *,
                   window):
    """x (B, 1, d); kc/vc (B, C, KV, hd), written at ``slot`` in place;
    kpos (C,) with the slot already holding the new position."""
    q, k, v = T.project_qkv(p, x, cfg, positions)
    kc.index_copy_(1, slot, k.to(kc.dtype))
    vc.index_copy_(1, slot, v.to(vc.dtype))
    out = L.decode_attention(
        q, kc, vc, q_position=positions[:, 0],
        k_positions=kpos[None].expand(x.shape[0], -1), window=window,
        attn_softcap=cfg.attn_logit_softcap)
    return torch.einsum("bshk,hkd->bsd", out, p["o"].to(x.dtype))


def decode_step(params, batch, cache: Cache, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, Cache]:
    """One token for the whole stack. batch: tokens (B, 1) or embeddings
    (B, 1, F), positions (B, 1). Returns (logits (B, V) float32, cache)."""
    T.check_supported(cfg)
    x = T.embed_input(params, batch, cfg)
    positions = batch["positions"]
    pos = cache["pos"]
    kpos = cache["kpos"]
    slot = (pos.long() % kpos.shape[0]).reshape(1)
    # the new token's own slot is attendable in every layer; the
    # reference writes the same value into the cache-level kpos after
    # the stack
    kpos.index_copy_(0, slot, positions[0, :1].to(kpos.dtype))
    pre_cfg = T.dense_config(cfg)
    for i in range(T.first_k_dense(cfg)):
        p = T.layer(params, i, "prelayers")
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        a = _attend_decode(p, h, cache["k_pre"][i], cache["v_pre"][i], kpos,
                           slot, pre_cfg, positions, window=None)
        x = T.finish_layer(p, x, a, pre_cfg)
    window = T.window_of(cfg)
    for i in range(T.scan_len(cfg)):
        p = T.layer(params, i)
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        a = _attend_decode(p, h, cache["k"][i], cache["v"][i], kpos, slot,
                           cfg, positions, window=window)
        if cfg.family == "moe":
            x, _ = T.finish_moe_layer(p, x, a, cfg, decode=True)
        else:
            x = T.finish_layer(p, x, a, cfg)
    new = dict(cache)
    new["pos"] = pos + 1
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return T.logits_of(params, x[:, 0], cfg), new


# ---------------------------------------------------------------- prefill
def _write_kv(kc, vc, k, v, s: int) -> None:
    """A layer's prompt keys and values into its cache (B, C, KV, hd):
    the last C when C <= S, else the first S slots (the tail stays zero:
    empty slots)."""
    wlen = kc.shape[1]
    if wlen <= s:
        kc.copy_(k[:, s - wlen:])
        vc.copy_(v[:, s - wlen:])
    else:
        kc[:, :s].copy_(k)
        vc[:, :s].copy_(v)


def prefill(params, batch, cfg: ArchConfig, extra_slots: int = 0
            ) -> Tuple[torch.Tensor, Cache]:
    """Full-context forward that also builds the decode cache.
    ``extra_slots`` reserves cache capacity for later decode tokens (with
    0, decode ring-evicts the oldest entries). Returns (last-position
    logits (B, V) float32, cache)."""
    T.check_supported(cfg)
    x = T.embed_input(params, batch, cfg)
    positions = batch["positions"]
    b, s = x.shape[:2]
    cache = init_cache(cfg, b, s + extra_slots, device=x.device)
    wlen = cache["k"].shape[2]
    pre_cfg = T.dense_config(cfg)
    for i in range(T.first_k_dense(cfg)):
        p = T.layer(params, i, "prelayers")
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = T.project_qkv(p, h, cfg, positions)
        _write_kv(cache["k_pre"][i], cache["v_pre"][i], k, v, s)
        a = T.attend_qkv(p, q, k, v, pre_cfg, positions[0], window=None)
        x = T.finish_layer(p, x, a, pre_cfg)
    window = T.window_of(cfg)
    for i in range(T.scan_len(cfg)):
        p = T.layer(params, i)
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = T.project_qkv(p, h, cfg, positions)
        _write_kv(cache["k"][i], cache["v"][i], k, v, s)
        a = T.attend_qkv(p, q, k, v, cfg, positions[0], window=window)
        if cfg.family == "moe":
            x, _ = T.finish_moe_layer(p, x, a, cfg)
        else:
            x = T.finish_layer(p, x, a, cfg)

    last = positions[0, -1].to(torch.int32)
    valid = min(s, wlen)
    slots = torch.arange(wlen, dtype=torch.int32, device=x.device)
    cache["kpos"] = torch.where(slots < valid, last - valid + 1 + slots,
                                torch.full_like(slots, -1))
    cache["pos"] = last + 1
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return T.logits_of(params, x[:, -1], cfg), cache
