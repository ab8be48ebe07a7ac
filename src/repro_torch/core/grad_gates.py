"""Gradient-based in-training ADC optimization: the gradient engine's
gate train. Counterpart of ``repro/core/grad_gates.py``.

The NSGA-II engines (core/search.py) pay one QAT run per genome per
generation. Here the keep/prune decision of every comparator is itself
trained: per-level gate logits pass through a hard-sigmoid
straight-through estimator, the exact pruned comparator tree stays in
the forward pass, and gradients flow through two smooth relaxations:

* ``relaxed_area``: a smooth stand-in for ``area.pruned_binary_tc``
  built from the same per-depth coefficients
  (``area.stage_cost_coeffs``), with soft-OR subtree aliveness in place
  of the integer walk. Exact at binary corners and monotone in every
  gate, so the forward value is the snapped design's transistor count;
* ``soft_value_table``: a distance-weighted soft assignment of codes to
  kept levels, the backward stand-in for ``adc.tree_lut``'s routing.

A sweep of the area weight λ across lanes and an anneal of the gate
temperature τ make one train produce a family of pruned designs along
the accuracy/area front; a snapshot after each chunk adds intermediate
points. ``snap_to_genomes`` turns gate logits into ordinary search
genomes, and core/search re-scores them through the exact fitness path,
so the reported front keeps the fitness == re-train == export contract.

The lanes are explicit (L, ...) stacks (``Lanes``), trained side by side
as the QAT lanes are (``search._train_from_quantized``): the loss is the
sum of the lane losses, so each lane's gradient is its own, and one
AdamW updates {logits, dp, params} of every lane.

Two choices keep a chunk a pure function of its inputs on the card, so a
killed and resumed gate train gives the same snapshots bit for bit:

* the per-code table gather (the reference's ``take_along_axis(tab,
  xcodes.T)``) is a batched product of the fixed one-hot codes (C, M,
  2^N) with the lane tables (C, 2^N, L). Each output has exactly one
  nonzero term, so the forward is bitwise the gather; its backward is a
  product at a fixed shape, where a gather's backward would be a
  ``scatter_add_`` whose float atomics add in a different order from
  run to run;
* the τ schedule is computed once, in float32 tensors on the CPU, in the
  reference's order (``frac = step / denom``, ``tau = tau0 * (tau1 /
  tau0) ** frac``): a function of the global step only, so chunked and
  whole runs see the same τ, on any device.

The gate init draws from a ``torch.Generator`` seeded with ``cfg.seed``
(a documented stream; tests inject the reference's ``init_lanes``
through ``lanes_from_numpy``). The classifier init is the exact
engines' own (``search._init_model``).

Training checkpoints after every chunk (gate logits, dp, parameters,
optimizer state, the snapshots so far) in the reference's leaf order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import adc, area, qat
from repro_torch.device import resolve_device
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import svm as svm_lib
from repro_torch.optim import adamw

DP_BITS = 4   # mirrors search.DP_BITS (search imports this module)


# ----------------------------------------------------------- relaxations
def relaxed_area(g: torch.Tensor) -> torch.Tensor:
    """Differentiable transistor count of one pruned ADC: gates ``g``
    (..., 2^N) in [0, 1] -> (...,).

    Subtree aliveness is a soft OR (``1 - prod(1 - g)``, the products
    built pairwise from the leaves up), a node is needed by the product
    of its halves' aliveness, and each depth costs

        any_tc * any(both) + sel_tc * (2 * sum(both) - 2 * any(both))

    with ``area.stage_cost_coeffs``. At binary corners every product and
    sum is exact 0/1 arithmetic, so the value equals
    ``area.pruned_binary_tc``; every term is a monotone composition, so
    the proxy is monotone in every gate."""
    n = g.shape[-1]
    bits = n.bit_length() - 1
    tc = torch.zeros(g.shape[:-1], dtype=g.dtype, device=g.device)
    # dead[..., b]: prod(1 - g) over the b-th of 2^(d+1) equal blocks,
    # from depth bits - 1 (blocks of one level) up to depth 0
    dead = [None] * bits
    if bits:
        dead[bits - 1] = 1.0 - g
    for d in range(bits - 2, -1, -1):
        dead[d] = _pair_prod(dead[d + 1])
    for d in range(bits):
        alive = 1.0 - dead[d]                             # soft OR
        both = _pair_prod(alive)
        cnt = both.sum(-1)
        any_ = 1.0 - _prod_last(1.0 - both)
        any_tc, sel_tc = area.stage_cost_coeffs(bits, d)
        tc = tc + any_tc * any_ + sel_tc * (2.0 * cnt - 2.0 * any_)
    return tc


def _pair_prod(t: torch.Tensor) -> torch.Tensor:
    """Products of adjacent pairs along the last axis (even length). The
    pairs come apart by ``unbind``, whose backward is one stack (two
    strided slices would each take a zero fill and a copy)."""
    a, b = t.unflatten(-1, (-1, 2)).unbind(-1)
    return a * b


def _prod_last(t: torch.Tensor) -> torch.Tensor:
    """Product over the last axis (a power-of-two length) as a tree of
    pairwise products. ``torch.prod``'s backward counts the zeros of its
    input on the host (a device sync per call on the card); this one
    is elementwise products only."""
    while t.shape[-1] > 1:
        t = _pair_prod(t)
    return t.squeeze(-1)


def relaxed_area_norm(g: torch.Tensor, bits: int) -> torch.Tensor:
    """Whole-classifier normalized area, gates (..., C, 2^N) -> (...,):
    the smooth counterpart of the fitness's area column
    (``system_tc / (flash_full_tc * C)``)."""
    channels = g.shape[-2]
    flash_full = max(area.flash_full_tc(bits) * channels, 1)
    return relaxed_area(g).sum(-1) / flash_full


def soft_value_table(g: torch.Tensor, values: torch.Tensor,
                     beta: float) -> torch.Tensor:
    """Soft code -> value map: gates (..., C, n) and level values ((n,)
    or (C, n)) -> (..., C, n). Code k takes a gate-weighted average over
    levels j, weighted by exp(-beta |k - j|)."""
    n = g.shape[-1]
    idx = torch.arange(n, dtype=g.dtype, device=g.device)
    kern = torch.exp(-beta * torch.abs(idx[:, None] - idx[None, :]))
    w = g[..., None, :] * kern
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    return (w * values[..., None, :]).sum(-1)


def gate_soft(logits: torch.Tensor, tau) -> torch.Tensor:
    """Hard-sigmoid gate relaxation: clip(logits / (2 tau) + 1/2, 0, 1);
    tau -> 0 sharpens toward the binary mask ``logits > 0``."""
    return torch.clamp(logits / (2.0 * tau) + 0.5, 0.0, 1.0)


def hard_mask(logits: torch.Tensor, min_levels: int) -> torch.Tensor:
    """The binary, repaired mask the logits snap to: the repair the
    genome decode applies, so the forward sees the decoded design."""
    return adc.repair_mask((logits > 0).to(torch.int32), min_levels)


# ------------------------------------------------------------- lane state
@dataclass
class Lanes:
    """L gate-train lanes: logits (L, C, 2^N), continuous dp (L,), the
    classifier stacks (MLP [(W, b), ...], SVM (W, b), each (L, ...)) and
    one AdamW state over all of them (every lane steps together)."""
    logits: torch.Tensor
    dp: torch.Tensor
    params: object
    opt: adamw.OptState

    def leaves(self) -> List[torch.Tensor]:
        """The trained tensors in the reference's tree order: dp,
        logits, then the parameters (W1, b1, W2, b2 or W, b)."""
        return [self.dp, self.logits] + _param_leaves(self.params)


def _param_leaves(params) -> List[torch.Tensor]:
    if isinstance(params, tuple):                       # SVM (W, b)
        return list(params)
    return [t for layer in params for t in layer]


def _with_leaves(like, flat: List[torch.Tensor]):
    """The parameter structure of ``like`` holding ``flat``."""
    if isinstance(like, tuple):
        return tuple(flat)
    return list(zip(flat[0::2], flat[1::2]))


def _lanes_of(arrays: List[np.ndarray], like_params, device) -> Lanes:
    """Lanes from numpy leaves in ``_state_tree`` order: the trained
    tensors (``Lanes.leaves``), the (L,) int32 step, then m and v."""
    n = 2 + len(_param_leaves(like_params))
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a, np.float32)).to(device)
    steps = np.asarray(arrays[n]).reshape(-1)
    if steps.size and not (steps == steps[0]).all():
        raise ValueError(f"the lanes' AdamW steps differ: {steps}")
    opt = adamw.OptState(
        step=torch.tensor(float(steps[0]) if steps.size else 0.0,
                          dtype=torch.float32, device=device),
        m=[t(a) for a in arrays[n + 1:2 * n + 1]],
        v=[t(a) for a in arrays[2 * n + 1:3 * n + 1]])
    trained = [t(a) for a in arrays[:n]]
    return Lanes(logits=trained[1], dp=trained[0],
                 params=_with_leaves(like_params, trained[2:]), opt=opt)


def _bundle_leaves(bundle) -> list:
    """A reference bundle (dict of dp, logits, params) in tree order."""
    params = bundle["params"]
    if hasattr(params[0], "shape"):                      # SVM (W, b)
        flat = list(params)
    else:
        flat = [a for layer in params for a in layer]
    return [bundle["dp"], bundle["logits"]] + flat


def lanes_from_numpy(bundle_np, opt_np, device=None) -> Lanes:
    """The carry of a gate-train start from the reference: its
    ``init_lanes`` output as numpy (``bundle`` a dict of logits, dp and
    params; ``opt`` its (step, m, v) with m and v shaped like the
    bundle) -> the port's ``Lanes`` on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    step, m, v = opt_np
    params = bundle_np["params"]
    like = (tuple(params) if hasattr(params[0], "shape")
            else [tuple(layer) for layer in params])
    arrays = (_bundle_leaves(bundle_np) + [np.asarray(step)]
              + _bundle_leaves(m) + _bundle_leaves(v))
    return _lanes_of(arrays, like, dev)


# ------------------------------------------------------------ train step
def lane_losses(lanes: Lanes, lams: torch.Tensor, tau: torch.Tensor,
                onehot_codes: torch.Tensor, target: torch.Tensor,
                values: torch.Tensor, cfg) -> torch.Tensor:
    """(L,) lane losses: the cross-entropy (MLP) or squared hinge (SVM)
    of the QAT forward on hard-pruned inputs, plus lam * normalized area.
    Both terms are exact in the forward pass and relaxed in the backward
    pass (``qat._ste``). ``onehot_codes`` (C, M, 2^N) are the training
    split's full-ADC codes, ``target`` the one-hot labels (MLP) or the
    labels (SVM), ``values`` the (C, 2^N) level values."""
    g = gate_soft(lanes.logits, tau)
    with torch.no_grad():
        hard = hard_mask(lanes.logits, cfg.min_levels)
        hard_area = relaxed_area_norm(hard.to(g.dtype), cfg.bits)
        lut = adc.tree_lut(hard).to(torch.int64)
        hard_tab = torch.gather(values.expand(lut.shape), -1, lut)
    # area: exact integer count forward, smooth relaxation backward
    area_n = qat._ste(relaxed_area_norm(g, cfg.bits), hard_area)
    # values: exact pruned-tree table forward, soft table backward
    tab = qat._ste(soft_value_table(g, values, cfg.grad_beta), hard_tab)
    # xq[l, m, c] = tab[l, c, code[m, c]] as a product with the one-hot
    # codes (module docstring: a gather's backward is not deterministic)
    xq = torch.bmm(onehot_codes, tab.permute(1, 2, 0)).permute(2, 1, 0)
    # dp: continuous carrier, integer forward. The reference's weight
    # quantizers pass dp no gradient (all of q - w is under
    # stop_gradient); the port's carry q's graph, so dp enters detached
    # and its gradient is the reference's zero
    dp = qat._ste(lanes.dp, torch.round(torch.clamp(lanes.dp, -8.0, 7.0)))
    dp = dp.detach()
    if cfg.model == "svm":
        fit = svm_lib.svm_loss(lanes.params, xq, target, dp,
                               weight_bits=cfg.weight_bits)
    else:
        fit = mlp_lib.cross_entropy(lanes.params, xq, target, dp,
                                    cfg.weight_bits)
    return fit + lams * area_n


def tau_schedule(cfg, total_steps: int) -> torch.Tensor:
    """(total_steps,) float32 gate temperatures on the CPU, in the
    reference's float32 order: ``frac = step / denom``, ``tau = tau0 *
    (tau1 / tau0) ** frac`` (the ratio taken in float64, then rounded)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    denom = f32(float(max(total_steps - 1, 1)))
    frac = torch.arange(total_steps, dtype=torch.int64).to(
        torch.float32) / denom
    ratio = f32(cfg.grad_tau1 / cfg.grad_tau0)
    return f32(cfg.grad_tau0) * torch.pow(ratio, frac)


def run_chunk(lanes: Lanes, lo: int, hi: int, taus: torch.Tensor,
              lams: torch.Tensor, onehot_codes: torch.Tensor,
              target: torch.Tensor, values: torch.Tensor, cfg) -> Lanes:
    """Global steps ``lo .. hi - 1`` of the gate train, in place on
    ``lanes`` (also returned): each step one AdamW update of every
    lane's {dp, logits, params} on the sum of the lane losses. ``taus``
    is ``tau_schedule`` on the lanes' device."""
    trained = lanes.leaves()
    for t in trained[1:]:
        t.requires_grad_(True)
    zero_dp = torch.zeros_like(lanes.dp)
    for i in range(lo, hi):
        loss = lane_losses(lanes, lams, taus[i], onehot_codes, target,
                           values, cfg).sum()
        grads = torch.autograd.grad(loss, trained[1:])
        adamw.update_(trained, [zero_dp, *grads], lanes.opt, lr=cfg.lr)
    for t in trained[1:]:
        t.requires_grad_(False)
    return lanes


def lambda_sweep(cfg, lanes: int) -> np.ndarray:
    """Per-lane area weights, log-spaced over [grad_lambda_lo,
    grad_lambda_hi]: the knob that spreads the family along the
    accuracy/area front."""
    if lanes == 1:
        return np.array([cfg.grad_lambda_lo], np.float32)
    return np.logspace(np.log10(cfg.grad_lambda_lo),
                       np.log10(cfg.grad_lambda_hi), lanes).astype(np.float32)


DP_INIT_GRID = (-3.0, -1.0, 1.0, 3.0)
# lane keep-density strata (period 5, coprime with the dp grid's 4)
DENSITY_GRID = (1.0, 0.8, 0.6, 0.45, 0.3)


def init_lanes(sizes, cfg, lanes: int, device=None) -> Lanes:
    """Initial lanes: gate logits a seeded random subnetwork whose keep
    density cycles over ``DENSITY_GRID`` (±0.8 plus 0.3 of normal noise,
    the reference's recipe), dp cycling over ``DP_INIT_GRID``, and every
    lane the exact engines' classifier init (same ``cfg.seed``), on
    ``device`` (default ``cuda``). The
    gates draw a uniform (L, C, 2^N) block and then a normal one from a
    ``torch.Generator`` seeded with ``cfg.seed``."""
    from repro_torch.core import search as search_lib
    dev = resolve_device(device)
    c, n = sizes[0], 2 ** cfg.bits
    gen = torch.Generator().manual_seed(cfg.seed)
    u = torch.rand((lanes, c, n), generator=gen, dtype=torch.float32)
    noise = torch.randn((lanes, c, n), generator=gen, dtype=torch.float32)
    keep_p = torch.tensor([DENSITY_GRID[i % len(DENSITY_GRID)]
                           for i in range(lanes)],
                          dtype=torch.float32)[:, None, None]
    logits = (torch.where(u < keep_p, 0.8, -0.8).to(torch.float32)
              + 0.3 * noise)
    dp = torch.tensor([DP_INIT_GRID[i % len(DP_INIT_GRID)]
                       for i in range(lanes)], dtype=torch.float32)
    params = search_lib._stacked_init(lanes, sizes, cfg, dev)
    out = Lanes(logits=logits.to(dev), dp=dp.to(dev), params=params,
                opt=None)
    out.opt = adamw.init(out.leaves())
    return out


def snap_to_genomes(logits, dp, channels: int, bits: int) -> np.ndarray:
    """Gate logits (L, C, 2^N) and continuous dp (L,) -> ordinary search
    genomes (L, C * 2^N + 4) uint8. No repair here: the genome decode
    applies the same repair, so the decoded mask is ``hard_mask``."""
    masks = np.asarray(np.asarray(logits) > 0, np.uint8)
    masks = masks.reshape(masks.shape[0], channels * 2 ** bits)
    dp_i = (np.clip(np.round(np.asarray(dp)), -8, 7).astype(np.int64) + 8)
    dpb = ((dp_i[:, None] >> np.arange(DP_BITS)) & 1).astype(np.uint8)
    return np.concatenate([masks, dpb], axis=1)


# ---------------------------------------------------- chunked gate train
def _chunk_bounds(train_steps: int, chunks: int) -> np.ndarray:
    return np.linspace(0, train_steps, chunks + 1).round().astype(int)


def _state_tree(lanes: Lanes, chunk: int, snaps: np.ndarray) -> Dict:
    """The flat tree the checkpoint manager persists, in the
    reference's keys: ``leaf_{i}`` over the trained tensors, the (L,)
    int32 AdamW step, m and v; the completed-chunk counter; the
    snapshot genomes so far (restored with ``restore_flat``)."""
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    step = np.full(lanes.dp.shape, int(lanes.opt.step.item()), np.int32)
    leaves = ([host(t) for t in lanes.leaves()] + [step]
              + [host(t) for t in lanes.opt.m]
              + [host(t) for t in lanes.opt.v])
    tree = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    tree["chunk"] = np.asarray(chunk, np.int64)
    tree["snap_genomes"] = np.asarray(snaps, np.uint8)
    return tree


def _as_device_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.asarray(a)).to(device)


def train_inputs(data: Dict, sizes, cfg, device) -> Tuple:
    """(onehot_codes (C, M, 2^N), target, values (C, 2^N)) of the
    training split on ``device``: the fixed operands of every step."""
    n = 2 ** cfg.bits
    x = _as_device_tensor(data["x_train"], device).float()
    y = _as_device_tensor(data["y_train"], device).long()
    codes = adc.encode(x, cfg.bits, cfg.vmin, cfg.vmax)        # (M, C)
    onehot = torch.nn.functional.one_hot(codes.T, n).to(torch.float32)
    target = (y if cfg.model == "svm"
              else torch.nn.functional.one_hot(y, sizes[-1]).float())
    values = adc.level_values(cfg.bits, cfg.vmin, cfg.vmax).to(device)
    values = values.expand(sizes[0], n).contiguous()
    return onehot.contiguous(), target, values


def train_gate_family(data: Dict, sizes, cfg, *, lanes: int, ckpt=None,
                      resume: bool = False, progress=None,
                      device=None) -> Tuple[np.ndarray, Dict]:
    """Run the chunked multi-lane gate train on ``device`` (default
    ``cuda``; the data's own device when it already holds tensors).
    Returns ``(pool, diag)``: ``pool`` ((K, G) uint8) holds every lane's
    snapshot genome after every chunk, duplicates included (the caller
    dedups before the exact re-score); ``diag`` records the schedule.
    ``ckpt``/``resume`` restart from the last completed chunk, bit
    identically."""
    x = data["x_train"]
    dev = (x.device if isinstance(x, torch.Tensor)
           else resolve_device(device))
    c = sizes[0]
    chunks = max(int(cfg.grad_snapshots), 1)
    # the gate train learns masks and weights jointly, so it gets its
    # own, longer budget; the snapped designs re-score at cfg.train_steps
    total_steps = (cfg.grad_train_steps if cfg.grad_train_steps > 0
                   else 8 * cfg.train_steps)
    bounds = _chunk_bounds(total_steps, chunks)
    lams = torch.from_numpy(lambda_sweep(cfg, lanes)).to(dev)
    taus = tau_schedule(cfg, total_steps).to(dev)
    onehot, target, values = train_inputs(data, sizes, cfg, dev)

    state = init_lanes(sizes, cfg, lanes, dev)
    start_chunk = 0
    snaps = np.zeros((0, c * 2 ** cfg.bits + DP_BITS), np.uint8)
    if ckpt is not None and resume:
        step = ckpt.latest_step()
        if step is not None:
            flat = ckpt.restore_flat(step)
            count = len([k for k in flat if k.startswith("leaf_")])
            state = _lanes_of([flat[f"leaf_{i}"] for i in range(count)],
                              state.params, dev)
            start_chunk = int(flat["chunk"])
            snaps = np.asarray(flat["snap_genomes"], np.uint8)

    for ci in range(start_chunk, chunks):
        lo, hi = int(bounds[ci]), int(bounds[ci + 1])
        run_chunk(state, lo, hi, taus, lams, onehot, target, values, cfg)
        snap = snap_to_genomes(state.logits.detach().cpu().numpy(),
                               state.dp.detach().cpu().numpy(), c,
                               cfg.bits)
        snaps = np.concatenate([snaps, snap])
        if ckpt is not None:
            ckpt.save(ci + 1, _state_tree(state, ci + 1, snaps))
        if progress is not None:
            progress(f"gate-train chunk {ci + 1}/{chunks} "
                     f"(steps {lo}..{hi}): {len(snaps)} family snapshots")
    diag = {"lanes": lanes, "chunks": chunks, "steps": total_steps,
            "lambda": lams.cpu().numpy().tolist(),
            "snapshots": int(len(snaps))}
    return snaps, diag
