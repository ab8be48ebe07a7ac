"""Transistor-count area model for flash / baseline-binary / proposed-binary
/ pruned-binary ADCs, built from the paper's design rules (§3.1-3.2).
A verbatim numpy copy of ``repro/core/area.py`` (the full-ADC and
pruned-tree functions, the fault-tolerance pricing and the analog
feature front end's). It is copied, not imported:
``repro.core`` pulls in JAX on import.

Calibration anchors (all from the paper):
* proposed 3-bit full design = 5 comparators + 2 inverters + 9 transistors
  (T0,T1 stage-2 ref select; T2..T7 control block = 2^N - 2; TA amplifier).
* baseline binary 3-bit (Fig. 2a) = 3 comparators + 2 NOT + 4 AND + 6 T.
* comparator = 7 transistors (Fig. 3c); COM1-style enable comparators drop
  one output leg (6 T) — we keep 7 as a conservative uniform cost.
* control/select block of stage d uses 2^(d+1) - 2 transistors (stage 1: 2
  = T0/T1; stage 2: 6 = T2..T7).
* N-type-only logic: NOT = 1 T (+ load R), AND = NAND(2 T) + NOT = 3 T.

Design rules for pruning (§3.2, verbatim from the paper):
  r1. removing level `a` removes the transistor holding V_ref of `a`;
  r2. if a whole sub-tree of levels is pruned, its comparator goes too;
  r3. pruning across V_ref/2 (one half of the root empty) removes the
      first-stage comparator and half the tree;
  r4. in the (baseline) switching network an AND gate per pruned control
      term is removed.

The pruned-area model walks the comparator tree: an internal node is *needed*
iff both of its halves still contain kept levels; per-stage costs then follow
the full-design structure restricted to needed nodes. Pure numpy: the GA
evaluates populations of masks outside jit (areas are exact integers).
"""
from __future__ import annotations

import numpy as np

COMPARATOR_TC = 7
INVERTER_TC = 1
AND_TC = 3
SELECT_TC = 1     # one transistor per V_ref select line (rule r1 unit)


# ---------------------------------------------------------------- full ADCs
def ours_full_tc(bits: int) -> int:
    """Proposed binary-search ADC, full (no pruning)."""
    if bits < 2:
        raise ValueError("ADC needs >= 2 bits")
    comps = 1 + 3 * (bits - 2) + 1          # COM0 + (2 enables + 1 out)/mid + last out
    invs = 2 * (bits - 2)                   # double inversions per middle stage
    selects = sum(2 ** (d + 1) - 2 for d in range(1, bits))
    amps = bits - 2                         # TA per stage >= 2
    return COMPARATOR_TC * comps + INVERTER_TC * invs + selects + amps


def baseline_binary_tc(bits: int) -> int:
    """SoA binary design (Fig. 2a), adapted to N-type (paper §2.2)."""
    comps = bits
    nots = bits - 1
    ands = 2 ** (bits - 1)
    trans = 2 ** bits - 2
    return COMPARATOR_TC * comps + INVERTER_TC * nots + AND_TC * ands + trans


def flash_encoder_tc(bits: int) -> int:
    """Thermometer->binary encoder (the part the binary-search design
    eliminates). Calibrated against Table 3/5: ~10*2^N - 30."""
    return max(10 * 2 ** bits - 30, 0)


def flash_full_tc(bits: int) -> int:
    comps = 2 ** bits - 1
    return COMPARATOR_TC * comps + flash_encoder_tc(bits)


# ------------------------------------------------------------- pruned model
def stage_cost_coeffs(bits: int, d: int):
    """Per-depth transistor-cost coefficients of the pruned proposed
    design, shared between the exact integer walk (``pruned_binary_tc``)
    and the differentiable relaxation (core/grad_gates.relaxed_area —
    DESIGN.md §13). Depth ``d`` with ``cnt >= 1`` needed nodes costs

        any_tc * [cnt > 0]  +  sel_tc * (2 * cnt - 2 * [cnt > 0])

    where ``any_tc`` bundles everything paid once per live stage: the
    stage output comparator, the two enable comparators + double
    inversion of middle stages (the exact walk's ``min(cnt + 1, 2)``
    equals 2 whenever the stage is live), and the TA amplifier of stages
    >= 2; ``sel_tc`` prices the surviving V_ref select lines (rule r1).
    The root (d = 0) has no selects — its only cost is COM0 (rule r3).
    """
    if d == 0:
        return COMPARATOR_TC, 0
    any_tc = COMPARATOR_TC
    if d <= bits - 2:                                 # middle stages only
        any_tc += 2 * COMPARATOR_TC + 2 * INVERTER_TC
    if d >= 2:
        any_tc += 1                                   # TA amplifier
    return any_tc, SELECT_TC


def _needed_tree(mask: np.ndarray) -> list:
    """Per-depth list of needed-node counts for a kept-level mask (2^N,)."""
    mask = np.asarray(mask).astype(bool)
    n = mask.shape[0]
    bits = n.bit_length() - 1
    needed = []
    seg = mask.reshape(1, n)
    for _ in range(bits):
        half = seg.reshape(seg.shape[0] * 2, seg.shape[1] // 2)
        alive = half.any(axis=1)
        both = alive.reshape(-1, 2).all(axis=1)      # node needs a comparison
        needed.append(int(both.sum()))
        seg = half
    return needed  # needed[d] = #needed nodes at depth d (root = depth 0)


def pruned_binary_tc(mask: np.ndarray) -> int:
    """Transistor count of the bespoke pruned proposed-design ADC."""
    mask = np.asarray(mask).astype(bool)
    kept = int(mask.sum())
    if kept <= 1:
        return 0                                      # constant output: wire
    n = mask.shape[0]
    bits = n.bit_length() - 1
    needed = _needed_tree(mask)
    tc = 0
    for d, cnt in enumerate(needed):
        if cnt == 0:
            continue
        any_tc, sel_tc = stage_cost_coeffs(bits, d)
        tc += any_tc + sel_tc * (2 * cnt - 2)
    return tc


def pruned_flash_tc(mask: np.ndarray) -> int:
    """Pruned flash (prior work [4]): one comparator per surviving decision
    boundary + proportionally reduced encoder."""
    mask = np.asarray(mask).astype(bool)
    kept = int(mask.sum())
    if kept <= 1:
        return 0
    n = mask.shape[0]
    bits = n.bit_length() - 1
    full_bounds = n - 1
    bounds = kept - 1
    enc = int(round(flash_encoder_tc(bits) * bounds / full_bounds))
    return COMPARATOR_TC * bounds + enc


def pruned_baseline_tc(mask: np.ndarray) -> int:
    """Baseline binary design (Fig. 2a) pruned with rules r1/r2/r4,
    calibrated so the full mask reproduces ``baseline_binary_tc`` exactly
    (the full design has: one comparator + one NOT per stage, 2^(N-1) AND
    control terms, 2^N - 2 switching transistors):

    * a stage survives iff some comparison is still needed at its depth
      (r2/r3 — its comparator and NOT go with it);
    * an AND control term survives iff its deepest-stage node still
      compares (r4 — one term per needed leaf-pair node);
    * switching transistors follow the kept levels (r1 — the full
      network's 2^N - 2 prorated as kept - 2).

    Every term is monotone in the mask, so pruning more levels never
    increases the count and no pruned baseline exceeds the full design
    (tests/test_area.py property coverage)."""
    mask = np.asarray(mask).astype(bool)
    kept = int(mask.sum())
    if kept <= 1:
        return 0
    needed = _needed_tree(mask)
    bits = (mask.shape[0]).bit_length() - 1
    tc = 0
    for d, cnt in enumerate(needed):
        if cnt == 0:
            continue
        tc += COMPARATOR_TC                           # per live stage
        tc += INVERTER_TC * (1 if d < bits - 1 else 0)
    tc += AND_TC * needed[bits - 1]                   # r4: surviving ANDs
    tc += max(kept - 2, 0)                            # r1: switching trans
    return tc


def pruned_comparator_count(mask: np.ndarray) -> int:
    """Physical comparators of the bespoke pruned proposed design, the
    units TMR triplicates: the root stage has COM0 only, middle live
    stages two enable comparators and one output comparator, the last
    live stage one output comparator."""
    mask = np.asarray(mask).astype(bool)
    if int(mask.sum()) <= 1:
        return 0
    n = mask.shape[0]
    bits = n.bit_length() - 1
    count = 0
    for d, cnt in enumerate(_needed_tree(mask)):
        if cnt == 0:
            continue
        count += 1 if (d == 0 or d > bits - 2) else 3
    return count


# --------------------------------------- fault-tolerance pricing
# TMR triplicates every surviving comparator behind an N-type majority
# voter (2-of-3: three 2-input NANDs + output stage ~ 4 T); calibration
# adds a per-kept-level trim register cell plus a per-channel
# measurement/readout harness.
VOTER_TC = 4
CALIBRATION_TC_FIXED = 4         # per-channel measurement/readout harness
CALIBRATION_TC_PER_LEVEL = 2     # per kept level: value-trim register cell


def tmr_tc(mask: np.ndarray) -> int:
    """Extra transistors for triplicating one channel's surviving
    comparators with majority voters: two more comparators plus one
    voter per physical comparator."""
    comps = pruned_comparator_count(mask)
    return (2 * COMPARATOR_TC + VOTER_TC) * comps


def calibration_tc(mask: np.ndarray) -> int:
    """Extra transistors for per-instance value-table calibration of one
    channel (a trim cell per kept level + the measurement harness)."""
    mask = np.asarray(mask).astype(bool)
    kept = int(mask.sum())
    if kept <= 1:
        return 0
    return CALIBRATION_TC_FIXED + CALIBRATION_TC_PER_LEVEL * kept


def faulttol_tc(masks: np.ndarray, tmr, calibrate) -> int:
    """Total fault-tolerance surcharge of one design: per-channel masks
    (C, 2^N) (spare levels already applied), per-channel TMR genes (C,)
    {0,1}, and the global calibrate gene, in exact transistors on the
    same budget axis as ``system_tc``."""
    masks = np.asarray(masks)
    if masks.ndim == 1:
        masks = masks[None]
    tmr = np.broadcast_to(np.asarray(tmr), (masks.shape[0],))
    tc = sum(tmr_tc(m) for m, t in zip(masks, tmr) if t)
    if calibrate:
        tc += sum(calibration_tc(m) for m in masks)
    return int(tc)


def system_tc(masks: np.ndarray, design: str = "ours") -> int:
    """Total ADC transistor count of a classifier with per-channel masks
    (C, 2^N) — one bespoke ADC per sensor input (the paper's Fig. 1 system).
    """
    masks = np.asarray(masks)
    if masks.ndim == 1:
        masks = masks[None]
    fn = {"ours": pruned_binary_tc, "flash": pruned_flash_tc,
          "baseline": pruned_baseline_tc}[design]
    return int(sum(fn(m) for m in masks))


# ------------------------------------------- analog feature front end (§14)
# Switched-capacitor temporal-feature circuits of the streaming co-design
# (DESIGN.md §14): per raw channel an analog window buffer of W/s
# sample-hold cells feeds the feature circuits, so a larger subsample
# factor s shrinks the buffer. Exact integers on the same transistor-count
# axis as the ADC models above.
SAMPLE_HOLD_TC = 1               # per stored sample of the window buffer
FEATURE_TC = {"mean": 8,         # switched-cap integrator + scale
              "min": 10,         # peak detector (diode-connected follower)
              "max": 10,
              "slope": 12}       # first/last S&H pair + differencer


def frontend_tc(feature_kinds, channels: int, window: int,
                subsample: int, alloc=None) -> int:
    """Exact transistor count of one analog front-end design point.

    ``feature_kinds``: the per-kind circuit list (feature channel
    k * channels + r computes kind k of raw channel r); ``alloc``: the
    per-feature-channel allocation genes, where 0 means the feature
    channel is OFF (its circuit, and the raw channel's window buffer if
    no sibling survives, disappears). ``alloc=None`` prices the
    all-active reference design."""
    kinds = tuple(feature_kinds)
    if window % subsample:
        raise ValueError(f"window {window} not divisible by subsample "
                         f"{subsample}")
    n_feat = len(kinds) * channels
    active = ([True] * n_feat if alloc is None
              else [int(a) > 0 for a in alloc])
    if len(active) != n_feat:
        raise ValueError(f"alloc length {len(active)} != feature channels "
                         f"{n_feat}")
    tc = 0
    buf = SAMPLE_HOLD_TC * (window // subsample)
    for r in range(channels):
        live = [k for k in range(len(kinds)) if active[k * channels + r]]
        if not live:
            continue
        tc += buf                               # shared analog window buffer
        tc += sum(FEATURE_TC[kinds[k]] for k in live)
    return tc
