"""Plain PyTorch versions of the ported kernels. Counterpart of
``repro/kernels/ref.py``; the reference's ``vmap``s are explicit batch
dimensions here.

Codes derive from the same f64-computed, f32-cast ``(vmin_row,
scale_row)`` constants the CUDA kernels receive (core/adc.range_rows), so
kernel-vs-plain code math is bitwise. The classifier products are float32
matmuls (no TF32, see device.py); their summation order differs from the
kernels', so logits agree bitwise only where every partial sum is exact
(dyadic tables, power-of-two weights, fixed-point biases, as exported
fronts have).
"""
from __future__ import annotations

import torch

from repro_torch.core import adc


def value_table(mask: torch.Tensor, bits: int, vmin=0.0, vmax=1.0,
                mode: str = "tree") -> torch.Tensor:
    """Per-channel code->reconstruction-value table:
    ``table[..., c, k]`` is the value the pruned ADC returns for raw code k
    on channel c. mask (C, 2^bits) or (P, C, 2^bits); a channel-shared
    (2^bits,) mask with per-channel ladders expands to (C, 2^bits).
    float32, on the mask's device."""
    mask = torch.as_tensor(mask)
    values = adc.level_values(bits, vmin, vmax).to(mask.device)
    lut = adc._lut(mask, mode).to(torch.int64)                  # (..., C, n)
    if values.ndim == 1:
        return values[lut]
    if lut.ndim == 1:
        return values[:, lut]
    if lut.shape[-2] != values.shape[0]:
        raise ValueError(f"mask has {lut.shape[-2]} channels but the "
                         f"per-channel range pins {values.shape[0]}")
    return torch.gather(values.expand(lut.shape), -1, lut)


def _codes(x: torch.Tensor, bits: int, vmin, vmax) -> torch.Tensor:
    """Raw (unpruned) int64 codes (M, C) via the canonical row constants,
    the shared front half of every plain version below."""
    return adc.encode(x, bits, vmin, vmax)


def adc_quantize_ref(x: torch.Tensor, table: torch.Tensor, bits: int,
                     vmin=0.0, vmax=1.0) -> torch.Tensor:
    """x (M, C); table (C, 2^bits) from value_table. Returns (M, C):
    ``out[m, c] = table[c, code(x[m, c])]``."""
    code = _codes(x, bits, vmin, vmax)                           # (M, C)
    return torch.gather(table.T, 0, code).to(x.dtype)


def adc_quantize_ref_population(x: torch.Tensor, tables: torch.Tensor,
                                bits: int, vmin=0.0, vmax=1.0
                                ) -> torch.Tensor:
    """One shared sample batch through P pruned ADC banks. x (M, C);
    tables (P, C, 2^bits). Returns (P, M, C):
    ``out[p, m, c] = tables[p, c, code(x[m, c])]``."""
    code = _codes(x, bits, vmin, vmax)                           # (M, C)
    p, c = tables.shape[0], tables.shape[1]
    idx = code.T.unsqueeze(0).expand(p, c, code.shape[0])        # (P, C, M)
    return torch.gather(tables, 2, idx).transpose(1, 2).to(x.dtype)


def bespoke_mlp_ref(x, table, bits: int, w1, b1, w2, b2,
                    vmin=0.0, vmax=1.0) -> torch.Tensor:
    """Fused analog front end + printed MLP:
    logits = relu(ADC(x) @ w1 + b1) @ w2 + b2."""
    xq = adc_quantize_ref(x, table, bits, vmin, vmax)
    h = torch.relu(xq @ w1 + b1)
    return h @ w2 + b2


def bespoke_svm_ref(x, table, bits: int, w, b,
                    vmin=0.0, vmax=1.0) -> torch.Tensor:
    """Fused analog front end + linear SVM: scores = ADC(x) @ w + b."""
    xq = adc_quantize_ref(x, table, bits, vmin, vmax)
    return xq @ w + b


def bespoke_mlp_bank_ref(x, tables, bits: int, w1, b1, w2, b2,
                         vmin=0.0, vmax=1.0) -> torch.Tensor:
    """One shared batch x (M, F) through D MLP designs: tables
    (D, F, 2^bits), w1 (D, F, H), b1 (D, H), w2 (D, H, O), b2 (D, O).
    Returns (D, M, O); row d == ``bespoke_mlp_ref`` on design d."""
    xq = adc_quantize_ref_population(x, tables, bits, vmin, vmax)
    h = torch.relu(torch.bmm(xq, w1) + b1[:, None, :])
    return torch.bmm(h, w2) + b2[:, None, :]


def bespoke_svm_bank_ref(x, tables, bits: int, w, b,
                         vmin=0.0, vmax=1.0) -> torch.Tensor:
    """One shared batch through D SVM designs: w (D, F, O), b (D, O).
    Returns (D, M, O)."""
    xq = adc_quantize_ref_population(x, tables, bits, vmin, vmax)
    return torch.bmm(xq, w) + b[:, None, :]
