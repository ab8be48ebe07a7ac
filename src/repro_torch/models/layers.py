"""Transformer building blocks of the LM substrate. Counterpart of
``repro/models/layers.py``: RMSNorm, softcap, RoPE and M-RoPE, GQA attention
(prefill, through the flash-attention kernel), decode attention against a
ring-buffer cache, SwiGLU.

Plain functions over tensors in the reference's layouts: activations
(B, S, ...), q (B, S, H, dh), k/v (B, Sk, KV, dh). The reference's
pure-jnp ``flash_attention`` is a second spelling of ``attention``'s
function; the kernel covers both.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm in float32 with a ``(1 + w)`` gain, cast back to x's type."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         sections: Optional[tuple] = None) -> torch.Tensor:
    """Rotary embedding. x (B, S, H, dh); positions (B, S) int or, for
    M-RoPE (qwen2-vl), (B, S, 3) with (t, h, w) components and
    ``sections`` summing to dh / 2: frequency band i of each section
    takes its angle from that section's component, in float32. (B, S, 3)
    positions without sections use component 0."""
    half = x.shape[-1] // 2
    freqs = torch.pow(
        torch.tensor(theta, dtype=torch.float32, device=x.device),
        -torch.arange(half, dtype=torch.float32, device=x.device) / half)
    if sections is not None and positions.ndim == 3:
        if sum(sections) != half:
            raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum "
                             f"to head_dim / 2 = {half}")
        comp = torch.cat([torch.full((n,), i, dtype=torch.long,
                                     device=x.device)
                          for i, n in enumerate(sections)])
        pos = positions.float()[..., comp]                      # (B,S,half)
    else:
        pos = (positions[..., 0] if positions.ndim == 3
               else positions).float()[..., None]
    angle = pos * freqs                                         # (B,S,half)
    cos = torch.cos(angle)[:, :, None, :]
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention(q, k, v, *, q_positions, k_positions, causal: bool = True,
              window: Optional[int] = None,
              attn_softcap: float = 0.0) -> torch.Tensor:
    """GQA attention of q (B, S, H, dh) over k/v (B, Sk, KV, dh) with
    positions (S,) / (Sk,) shared by the batch, differentiable. On a CUDA
    tensor it launches the flash-attention kernel, and its gradient the
    backward kernel; on a CPU tensor both are the plain versions. Returns
    (B, S, H, dh)."""
    return ops.attention(
        q.contiguous(), k.contiguous(), v.contiguous(),
        q_positions.to(torch.int32).contiguous(),
        k_positions.to(torch.int32).contiguous(), causal=causal,
        window=window or 0, attn_softcap=attn_softcap)


def decode_attention(q, k_cache, v_cache, *, q_position, k_positions,
                     window: Optional[int] = None,
                     attn_softcap: float = 0.0) -> torch.Tensor:
    """Single-token attention against a (ring-buffer) cache, plain
    PyTorch as in the reference (no kernel there either). q (B, 1, H, dh);
    caches (B, W, KV, dh); q_position (B,); k_positions (B, W) absolute
    positions with -1 marking empty slots. Returns (B, 1, H, dh)."""
    b, _, h, dh = q.shape
    kvh = k_cache.shape[2]
    rep = h // kvh
    scale = 1.0 / math.sqrt(dh)
    qr = q.reshape(b, kvh, rep, dh).float()
    scores = torch.einsum("bkrd,bskd->bkrs", qr, k_cache.float()) * scale
    scores = softcap(scores, attn_softcap)
    dpos = q_position[:, None] - k_positions                     # (B, W)
    valid = (k_positions >= 0) & (dpos >= 0)
    if window:
        valid = valid & (dpos < window)
    scores = torch.where(valid[:, None, None, :], scores, NEG)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", w.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, dh).to(q.dtype)


def swiglu(x, wi, wg, wo) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, wi.to(x.dtype))
    g = torch.einsum("bsd,df->bsf", x, wg.to(x.dtype))
    return torch.einsum("bsf,fd->bsd", F.silu(g) * h, wo.to(x.dtype))
