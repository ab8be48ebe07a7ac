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

The Monte-Carlo versions (``mc_adc_eval*``) compute the code position
``u = (x - lo) * scale`` from per-instance rows and select through
interval tables (core/nonideal.py); their result is a copied table value,
so kernel and plain version agree bitwise.

``flash_attention_ref`` is the attention kernel's function (masks,
guards and casts of ``flash_attention_pallas``) with the scores of one q
block materialised at a time and a one-pass softmax; the kernel's online
softmax rounds in another order, so the two agree to rounding only.
"""
from __future__ import annotations

import math

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


def _mc_select(u: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    """The interval selection sum shared by the four MC plain versions.
    u (S, M, C) code positions; lb/ub (..., S, C, 2^N); values
    broadcastable to lb's shape. Returns (..., S, M, C):
    ``sum_k values[..., s, c, k]`` over the k with ``lb <= u < ub``,
    accumulated from 0.0 in k order, as the kernel does. The perturbed
    tree walk partitions the line, so at most one term is live and the
    sum is exact; where none is (NaN, +inf) it is 0.0."""
    values = values.expand(lb.shape)
    out = torch.zeros(lb.shape[:-3] + u.shape, dtype=torch.float32,
                      device=u.device)
    for k in range(lb.shape[-1]):
        lo_k = lb[..., k].unsqueeze(-2)                   # (..., S, 1, C)
        hi_k = ub[..., k].unsqueeze(-2)
        sel = (u >= lo_k) & (u < hi_k)
        out = out + torch.where(sel, values[..., k].unsqueeze(-2), 0.0)
    return out


def _mc_positions(x: torch.Tensor, lo: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """u (S, M, C) = (x - lo[s]) * scale[s], subtract then multiply, each
    rounded once, as the kernel's ``__fsub_rn`` / ``__fmul_rn``."""
    return (x[None, :, :] - lo[:, None, :]) * scale[:, None, :]


def mc_adc_eval_ref(x, lb, ub, values, lo, scale) -> torch.Tensor:
    """Monte-Carlo non-ideal ADC, one design: x (M, C) shared samples;
    lb/ub (S, C, 2^N) per-instance interval tables in code units; values
    (C, 2^N) nominal ladder; lo/scale (S, C) per-instance drifted range
    rows. Returns (S, M, C): ``values[c, k]`` for the kept leaf k with
    ``lb[s, c, k] <= (x[m, c] - lo[s, c]) * scale[s, c] < ub[s, c, k]``."""
    return _mc_select(_mc_positions(x, lo, scale), lb, ub, values)


def mc_adc_eval_ref_population(x, lb, ub, values, lo,
                               scale) -> torch.Tensor:
    """P designs at once: lb/ub (P, S, C, 2^N); values (C, 2^N) and
    lo/scale (S, C) shared across designs (common random numbers).
    Returns (P, S, M, C)."""
    return _mc_select(_mc_positions(x, lo, scale), lb, ub, values)


def mc_adc_eval_cal_ref(x, lb, ub, values, lo, scale) -> torch.Tensor:
    """Calibrated tables, one design: as ``mc_adc_eval_ref`` with values
    (S, C, 2^N), one re-baked ladder per instance. Returns (S, M, C)."""
    return _mc_select(_mc_positions(x, lo, scale), lb, ub, values)


def mc_adc_eval_cal_ref_population(x, lb, ub, values, lo,
                                   scale) -> torch.Tensor:
    """Calibrated tables, P designs: lb/ub/values (P, S, C, 2^N) (mixed
    populations carry the nominal ladder in their uncalibrated rows);
    lo/scale (S, C) shared. Returns (P, S, M, C)."""
    return _mc_select(_mc_positions(x, lo, scale), lb, ub, values)


FLASH_NEG = -1e30
FLASH_Q_BLOCK = 512          # query rows whose scores are materialised at once


def flash_attention_ref(q, k, v, q_positions, k_positions, *,
                        causal: bool = True, window: int = 0,
                        attn_softcap: float = 0.0) -> torch.Tensor:
    """q (B, S, H, dh); k/v (B, Sk, KV, dh); positions (S,) / (Sk,) int.
    Query head h reads kv head h // (H / KV). Scores accumulate in f32
    (bf16 inputs are widened exactly), then the optional softcap, then
    -1e30 where kpos < 0, (causal) qpos - kpos < 0 or (window > 0)
    qpos - kpos >= window. p = 0 on a fully masked row; p is cast to v's
    type before P.V (f32 accumulation); out = P.V / max(sum p, 1e-30) in
    q's type. Returns (B, S, H, dh)."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    if k.shape[1] == 0:                      # no keys: every row is masked
        return torch.zeros_like(q)
    rep = h // kvh
    scale = 1.0 / math.sqrt(dh)
    kf, vf = k.float(), v.float()
    qpos = q_positions.to(torch.int32)
    kpos = k_positions.to(torch.int32)
    out = torch.empty_like(q)
    for q0 in range(0, s, FLASH_Q_BLOCK):
        qi = q[:, q0:q0 + FLASH_Q_BLOCK].float()
        qb = qi.shape[1]
        qi = qi.reshape(b, qb, kvh, rep, dh)
        sc = torch.einsum("bqkrd,bskd->bkrqs", qi, kf) * scale
        if attn_softcap:
            sc = torch.tanh(sc / attn_softcap) * attn_softcap
        dpos = qpos[q0:q0 + qb, None] - kpos[None, :]           # (qb, Sk)
        ok = (kpos >= 0)[None, :].expand(qb, -1)
        if causal:
            ok = ok & (dpos >= 0)
        if window:
            ok = ok & (dpos < window)
        sc = torch.where(ok, sc, FLASH_NEG)
        m = sc.amax(-1, keepdim=True)
        p = torch.where(m <= FLASH_NEG, 0.0, torch.exp(sc - m))
        denom = torch.clamp(p.sum(-1), min=1e-30)               # (b,kv,r,qb)
        o = torch.einsum("bkrqs,bskd->bkrqd", p.to(v.dtype).float(), vf)
        o = o / denom[..., None]
        out[:, q0:q0 + qb] = o.permute(0, 3, 1, 2, 4).reshape(
            b, qb, h, dh).to(q.dtype)
    return out
