"""Per-instance calibration: re-bake value tables from measured
intervals. Counterpart of ``repro/faulttol/calibrate.py``.

A fabricated instance places its comparator thresholds away from the
nominal ones: the inputs reaching kept leaf ``k`` form the measured
interval ``[lb, ub)`` that ``nonideal.instance_bounds`` compiles.
Calibration stores, per instance, that interval's analog midpoint as the
leaf's reconstruction value, and serves through the calibrated-table
Monte-Carlo kernel entries (``ops.mc_eval_cal*``). Each step is its own
float32 PyTorch operation, as in the reference's eager path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import nonideal as nonideal_lib
from repro_torch.faulttol import redundancy


def calibrated_value_rows(lb, ub, lo, scale, bits: int) -> torch.Tensor:
    """Measured-interval midpoints as per-instance value tables.

    lb/ub: (..., S, C, 2^N) code-unit interval tables (unreachable leaves
    carry (+inf, -inf)); lo/scale: (S, C) measured range rows. Bounds
    clip to the code range [0, 2^N] first (the outer leaves are
    half-infinite), then map back to the analog domain via
    ``x = lo + u / scale``. Returns float32 of lb's shape; unreachable
    leaves get a finite value the kernel never selects."""
    n = float(2 ** bits)
    mid_u = 0.5 * (torch.clamp(lb, 0.0, n) + torch.clamp(ub, 0.0, n))
    return (lo[..., None] + mid_u / scale[..., None]).to(torch.float32)


def mc_operands_ft(spec, nonideal: nonideal_lib.NonIdealSpec, masks, tmr,
                   cal, rdraws, device=None):
    """The fault-tolerant counterpart of ``nonideal.mc_operands``:
    compile (spec, nonideal, spare-applied masks, TMR genes, calibrate
    genes, redundant draws) into the ``ops.mc_eval_cal*`` operand tuple
    ``(lb, ub, values, lo, scale)`` with per-instance value tables,
    contiguous float32 on ``device`` (default: the draws').

    masks: (C, 2^N) or (P, C, 2^N); tmr: (C,) or (P, C); cal: scalar or
    (P,) {0,1}. Designs with the calibrate gene off get the nominal
    ladder broadcast to the per-instance table shape, so one launch
    serves a mixed population."""
    rdraws = redundancy.as_redundant_draws(rdraws, device)
    dev = rdraws.eps.device
    channels = np.shape(masks)[-2]
    eff = redundancy.effective_draws(rdraws, tmr, nonideal)
    lb, ub = nonideal_lib.instance_bounds(masks, spec.bits, eff, nonideal)
    lo, scale = nonideal_lib.instance_rows(spec, channels, rdraws, nonideal)
    nominal = nonideal_lib.level_value_rows(spec, channels, dev)  # (C, 2^N)
    calv = calibrated_value_rows(lb, ub, lo, scale, spec.bits)
    cal = nonideal_lib.to_tensor(cal, dev, torch.bool)
    cond = cal.reshape(cal.shape + (1, 1, 1))
    values = torch.where(cond, calv, nominal)
    return tuple(t.contiguous() for t in (lb, ub, values, lo, scale))
