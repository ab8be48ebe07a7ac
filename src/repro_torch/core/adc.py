"""Binary-search ADC semantics on tensors. Counterpart of
``repro/core/adc.py``.

An N-bit binary-search ADC partitions [vmin, vmax] into 2^N levels.
Pruning keeps a subset of levels (a binary mask); the comparator tree then
routes an input falling in a pruned level to the kept leaf the surviving
comparator chain reaches (``tree`` mode), or to the nearest kept level
(``nearest`` mode). Both are precomputed here as code->level lookup tables
(LUTs), batched over any leading mask axes. ``adc_quantize`` is the
module form: gradients flow through a straight-through estimator (STE).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _is_scalar_range(v) -> bool:
    return not (isinstance(v, (list, tuple))
                or (hasattr(v, "ndim") and getattr(v, "ndim", 0) > 0))


def range_rows(bits: int, vmin, vmax, channels: int):
    """Canonical per-channel code-math constants: f32 numpy rows
    ``(vmin_row (1, C), scale_row (1, C))`` with ``scale = 2^bits /
    (vmax - vmin)`` computed in f64 then cast once. Scalar endpoints
    broadcast across channels. Codes everywhere in the port (plain
    versions and CUDA kernels) are
    ``clip(floor((x - vmin_row) * scale_row), 0, 2^N - 1)`` from these
    exact constants, as in the reference."""
    n = 2 ** bits
    lo = np.broadcast_to(np.asarray(vmin, np.float64), (channels,))
    hi = np.broadcast_to(np.asarray(vmax, np.float64), (channels,))
    if np.any(hi <= lo):
        raise ValueError(f"vmax must exceed vmin elementwise "
                         f"(vmin={vmin}, vmax={vmax})")
    scale = n / (hi - lo)
    return (lo.astype(np.float32)[None, :],
            scale.astype(np.float32)[None, :])


def range_rows_tensors(bits: int, vmin, vmax, channels: int,
                       device=None):
    """``range_rows`` as two (C,) float32 tensors on ``device``."""
    lo, scale = range_rows(bits, vmin, vmax, channels)
    return (torch.from_numpy(lo[0]).to(device),
            torch.from_numpy(scale[0]).to(device))


def level_values(bits: int, vmin=0.0, vmax=1.0) -> torch.Tensor:
    """Representative value of each of the 2^bits levels: the midpoint of
    level k's interval [k, k+1) / 2^bits of the range. Scalar ranges give
    a (2^bits,) ladder, per-channel ranges a (C, 2^bits) one. Every step
    runs in float32, with each python scalar rounded to float32 first, as
    the reference's weakly typed arithmetic does."""
    n = 2 ** bits
    mid = torch.arange(n, dtype=torch.float32) + 0.5
    if _is_scalar_range(vmin) and _is_scalar_range(vmax):
        lo = torch.tensor(float(vmin), dtype=torch.float32)
        span = torch.tensor(float(vmax) - float(vmin), dtype=torch.float32)
        return lo + mid * span / n
    lo = torch.from_numpy(np.asarray(vmin, np.float32).reshape(-1))
    hi = torch.from_numpy(np.asarray(vmax, np.float32).reshape(-1))
    lo, hi = torch.broadcast_tensors(lo, hi)
    return lo[:, None] + mid[None, :] * (hi - lo)[:, None] / n


def encode(x: torch.Tensor, bits: int, vmin=0.0, vmax=1.0) -> torch.Tensor:
    """Full (unpruned) ADC transfer function: analog -> int64 code.
    Per-channel ranges apply along the trailing (channel) axis of x. A NaN
    input has code 0, as in the reference, whose float-to-int conversion
    (XLA's) turns NaN into 0; torch's cast leaves it undefined, so it is
    made 0 before the cast. +-inf clamp to the end codes."""
    lo, scale = range_rows_tensors(bits, vmin, vmax, x.shape[-1], x.device)
    code = torch.floor((x - lo) * scale).clamp(0, 2 ** bits - 1)
    return torch.nan_to_num(code, nan=0.0).to(torch.int64)


def tree_lut(mask: torch.Tensor) -> torch.Tensor:
    """Map every original code k to the kept level the pruned comparator
    tree resolves to. ``mask``: (..., 2^bits) {0,1}; leading axes are
    carried through. Returns int32 of the same shape.

    Vectorised tree walk: keep a per-code [lo, hi) interval; at each depth
    branch on k < mid if both halves hold kept levels, else take the only
    live half (the bypassed comparator). An all-zero mask resolves to
    level 0."""
    n = mask.shape[-1]
    bits = n.bit_length() - 1
    m = mask.to(torch.int64)
    cs = torch.cat([torch.zeros(m.shape[:-1] + (1,), dtype=torch.int64,
                                device=m.device),
                    torch.cumsum(m, dim=-1)], dim=-1)
    take = lambda idx: torch.gather(cs, -1, idx)  # noqa: E731
    k = torch.arange(n, device=m.device).expand(m.shape)
    lo = torch.zeros(m.shape, dtype=torch.int64, device=m.device)
    hi = torch.full(m.shape, n, dtype=torch.int64, device=m.device)
    for _ in range(bits):
        mid = (lo + hi) // 2
        left_alive = (take(mid) - take(lo)) > 0
        right_alive = (take(hi) - take(mid)) > 0
        go_left = torch.where(left_alive & right_alive, k < mid, left_alive)
        lo = torch.where(go_left, lo, mid)
        hi = torch.where(go_left, mid, hi)
    return lo.to(torch.int32)


def _nearest_lut(mask: torch.Tensor) -> torch.Tensor:
    """LUT of the nearest kept level (ties to the lower index), batched
    over leading axes like ``tree_lut``."""
    n = mask.shape[-1]
    idx = torch.arange(n, device=mask.device)
    dist = (idx[:, None] - idx[None, :]).abs().to(torch.float32)
    dist = torch.where(mask[..., None, :] > 0, dist,
                       torch.tensor(float("inf"), device=mask.device))
    return torch.argmin(dist, dim=-1).to(torch.int32)


def _lut(mask: torch.Tensor, mode: str) -> torch.Tensor:
    return (tree_lut if mode == "tree" else _nearest_lut)(
        mask.to(torch.int32))


def adc_codes(x: torch.Tensor, mask: torch.Tensor, *, bits: int,
              mode: str = "tree", vmin=0.0, vmax=1.0) -> torch.Tensor:
    """Integer kept-level codes (the circuit's digital output), int32.
    ``mask`` is (n,), (C, n) or population-batched (P, C, n); with a
    population mask x is (P, ..., C)."""
    code = encode(x, bits, vmin, vmax)
    lut = _lut(mask, mode).to(torch.int64)
    if mask.ndim == 1:
        return lut[code].to(torch.int32)
    c = mask.shape[-2]
    if mask.ndim == 2:
        flat = code.reshape(-1, c)                               # (M, C)
        return torch.gather(lut.T, 0, flat).reshape(code.shape).to(
            torch.int32)
    flat = code.reshape(mask.shape[0], -1, c)                    # (P, M, C)
    return torch.gather(lut.transpose(1, 2), 1, flat).reshape(
        code.shape).to(torch.int32)


def _gather_values(values: torch.Tensor, level: torch.Tensor
                   ) -> torch.Tensor:
    """values (2^N,) shared or (C, 2^N) per-channel; level (..., C) int64
    codes -> reconstruction values of level's shape."""
    if values.ndim == 1:
        return values[level]
    c = values.shape[0]
    flat = level.reshape(-1, c)
    return torch.gather(values.T, 0, flat).reshape(level.shape)


def adc_quantize(x: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                 bits: int, vmin=0.0, vmax=1.0, mode: str = "tree",
                 ste: bool = True) -> torch.Tensor:
    """Quantize ``x`` through a (possibly pruned) binary-search ADC.

    mask: None (full ADC) | (2^bits,) shared | (C, 2^bits) per channel,
    C == x.shape[-1] | (P, C, 2^bits) population batch with x (P, ..., C).
    Per-channel ``vmin``/``vmax`` apply along the trailing axis. Returns
    x's shape and dtype; with ``ste`` the forward value is
    ``x + (xq - x)`` with the difference detached, so the gradient is the
    identity (the reference's ``x + stop_gradient(xq - x)``)."""
    values = level_values(bits, vmin, vmax).to(x.device)
    code = encode(x.float(), bits, vmin, vmax)
    if mask is None:
        level = code
    else:
        mask = torch.as_tensor(mask).to(x.device)
        if mask.ndim == 2 and mask.shape[0] != x.shape[-1]:
            raise ValueError(f"per-channel mask C={mask.shape[0]} != last "
                             f"dim {x.shape[-1]}")
        if mask.ndim == 3 and (x.shape[0] != mask.shape[0]
                               or x.shape[-1] != mask.shape[1]):
            raise ValueError(f"population mask (P={mask.shape[0]}, "
                             f"C={mask.shape[1]}) needs x (P, ..., C); got "
                             f"x {tuple(x.shape)}")
        if mask.ndim not in (1, 2, 3):
            raise ValueError(f"mask ndim must be 1, 2 or 3, got {mask.ndim}")
        level = adc_codes(x.float(), mask, bits=bits, mode=mode, vmin=vmin,
                          vmax=vmax).to(torch.int64)
    xq = _gather_values(values, level).to(x.dtype)
    if ste:
        xq = x + (xq - x).detach()
    return xq


def init_full_mask(bits: int, channels: Optional[int] = None
                   ) -> torch.Tensor:
    """The unpruned mask: every level kept, (2^bits,) or (C, 2^bits)
    int32."""
    n = 2 ** bits
    shape = (n,) if channels is None else (channels, n)
    return torch.ones(shape, dtype=torch.int32)


def add_levels(mask: torch.Tensor, extra) -> torch.Tensor:
    """Turn on ``extra`` more kept levels along the trailing axis, lowest
    pruned index first. ``extra`` broadcasts against ``mask.shape[:-1]``;
    where fewer pruned levels remain, all of them are enabled."""
    m = mask.to(torch.int32)
    order = torch.argsort(m, dim=-1, stable=True)                # zeros first
    rank_of = torch.argsort(order, dim=-1, stable=True)
    extra = torch.as_tensor(extra, dtype=torch.int64,
                            device=m.device)[..., None]
    return torch.where((m == 0) & (rank_of < extra),
                       torch.ones_like(m), m)


def repair_mask(mask: torch.Tensor, min_levels: int = 2) -> torch.Tensor:
    """Guarantee at least ``min_levels`` kept levels per channel by turning
    on the lowest-index pruned levels. Works on (n,) or (C, n)."""
    m = mask.to(torch.int32)
    kept = m.sum(dim=-1)
    return add_levels(m, torch.clamp(min_levels - kept, min=0))
