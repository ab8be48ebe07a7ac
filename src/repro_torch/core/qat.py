"""Quantization-aware training utilities (paper §3.2 / §4.1). Counterpart
of ``repro/core/qat.py``.

The paper's printed classifiers use 8-bit fixed-point *power-of-2*
weights; the GA genome carries the decimal-point position ``dp`` of the
coefficients.

* ``quantize_po2(w, dp)``: project to sign * 2^e with e in the fixed-point
  exponent window selected by ``dp`` (straight-through estimator).
* ``quantize_fixed(x, dp, bits)``: plain fixed-point fake-quant (biases).

``dp`` is a python number, a 0-d tensor, or a (P,) tensor with one
decimal position per population lane: it then broadcasts against the
leading (lane) axis of ``w``. Every step runs in float32, with the same
operations in the same order as the reference; ``round`` is
half-to-even in both frameworks.
"""
from __future__ import annotations

import torch


def _ste(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Forward value ``x + (xq - x)``, gradient the identity (``xq`` was
    computed from ``x.detach()``, so it carries no graph). The sum is
    computed, not folded to ``xq``: where ``xq - x`` rounds, the stored
    value differs from ``xq``, and the reference (and the exported
    weights) carry that same value."""
    return x + (xq - x.detach())


def _lane_dp(dp, like: torch.Tensor) -> torch.Tensor:
    """``dp`` as a float32 tensor that broadcasts against ``like``: a
    (P,) lane vector becomes (P, 1, ..., 1)."""
    dp = torch.as_tensor(dp, dtype=torch.float32, device=like.device)
    if dp.ndim == 1:
        dp = dp.reshape((-1,) + (1,) * (like.ndim - 1))
    return dp


def quantize_po2(w: torch.Tensor, dp, bits: int = 8) -> torch.Tensor:
    """Power-of-2 weight quantization with decimal-point position ``dp``.

    Representable magnitudes: 2^e for e in [dp - (bits - 1), dp], plus 0.
    dp is the integer exponent of the largest representable power."""
    dp = _lane_dp(dp, w)
    wd = w.detach()
    e_hi = dp
    e_lo = dp - (bits - 1)
    mag = torch.abs(wd).float()
    e = torch.round(torch.log2(torch.clamp(mag, min=1e-12)))
    e = torch.minimum(torch.maximum(e, e_lo), e_hi)
    q = torch.sign(wd) * torch.exp2(e)
    # underflow-to-zero: anything below half the smallest power is 0
    q = torch.where(mag < torch.exp2(e_lo) * 0.5, torch.zeros_like(q), q)
    return _ste(w, q.to(w.dtype))


def quantize_fixed(x: torch.Tensor, dp, bits: int = 8) -> torch.Tensor:
    """Symmetric fixed-point fake-quant: step 2^(dp - bits + 1), range
    +-2^dp."""
    dp = _lane_dp(dp, x)
    step = torch.exp2(dp - (bits - 1))
    hi = torch.exp2(dp) - step
    q = torch.round(x.detach() / step) * step
    q = torch.minimum(torch.maximum(q, -hi - step), hi)
    return _ste(x, q.to(x.dtype))


def quantize_tree(params, dp, bits: int = 8, mode: str = "po2"):
    """Apply weight fake-quant to every tensor of a (nested list/tuple)
    parameter structure."""
    fn = quantize_po2 if mode == "po2" else quantize_fixed
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_tree(p, dp, bits, mode) for p in params)
    return fn(params, dp, bits)
