"""Redundancy genes and majority-voted Monte-Carlo draws. Counterpart of
``repro/faulttol/redundancy.py``.

A triplicated comparator behind a majority voter is still one threshold
test on the analog input, so TMR folds into the interval-table
compilation (``nonideal.instance_bounds``) as a transformation of the
draw stream. Per node, with replica thresholds ``t_i = mid + sigma *
eps_i`` and the comparator firing when ``u >= t_i``:

* all three replicas healthy -> the vote fires at the **median**
  threshold;
* one replica stuck-at-1 -> **min** of the two healthy thresholds;
* one replica stuck-at-0 -> **max** of the two healthy thresholds;
* one stuck high and one low -> the lone healthy replica decides;
* two or more stuck the same way -> the vote itself is stuck (encoded as
  ``fault_u = 0`` with the voted direction; healthy votes are encoded as
  ``fault_u = 1``, which no ``fault_rate <= 1`` marks faulty).

``draw_redundant`` draws the 3-replica stream from the port's documented
generator (core/nonideal.py, the draw stream) with node arrays
(S, C, 2^N - 1, 3): a pure function of the seed and the shapes. Channels
whose TMR gene is off consume replica 0 verbatim. Every function also
takes the reference's draws as numpy arrays.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import nonideal as nonideal_lib
from repro_torch.core.nonideal import Draws, NonIdealSpec
from repro_torch.faulttol.spec import FaultTolSpec

REPLICAS = 3


class RedundantDraws(NamedTuple):
    """3-replica comparator randomness for S instances (common random
    numbers across a population, like ``nonideal.Draws``). Node arrays
    are (S, C, 2^N - 1, REPLICAS); drift is shared per channel instance
    (the reference ladder is not replicated): (S, C, 2)."""
    eps: torch.Tensor
    fault_u: torch.Tensor
    stuck_hi: torch.Tensor
    drift: torch.Tensor

    @property
    def samples(self) -> int:
        return self.eps.shape[0]


def as_redundant_draws(rd, device=None) -> RedundantDraws:
    """``rd`` (tensors or numpy arrays in the field order) as a
    ``RedundantDraws`` of tensors on ``device``."""
    return nonideal_lib.as_draws(rd, device, cls=RedundantDraws)


def draw_redundant(bits: int, channels: int, samples: int,
                   nonideal: NonIdealSpec, device=None) -> RedundantDraws:
    """The 3-replica randomness block: a pure function of
    ``nonideal.seed`` and the shapes, on ``device`` (default the CPU)."""
    return RedundantDraws(*nonideal_lib.draw_stream(
        bits, channels, samples, nonideal, (REPLICAS,), device))


def effective_draws(rd, tmr, nonideal: NonIdealSpec) -> Draws:
    """Fold the replica axis into ordinary per-node ``Draws`` under
    per-channel TMR selection. ``tmr``: (C,) or population-batched
    (P, C) {0,1}; a leading P axis broadcasts straight through
    ``instance_bounds`` (bounds come back (P, S, C, 2^N)). The median is
    ``e.sum - e.max - e.min`` with the sum taken as ``(e0 + e1) + e2``,
    the reference's expression and order (``torch.median`` is another
    number)."""
    rd = as_redundant_draws(rd)
    dev = rd.eps.device
    frate = torch.tensor(float(nonideal.fault_rate), dtype=torch.float32,
                         device=dev)
    e = rd.eps                                       # (S, C, K, 3)
    f = rd.fault_u < frate
    hi = rd.stuck_hi
    n_hi = (f & hi).sum(-1)
    n_lo = (f & ~hi).sum(-1)
    n_f = n_hi + n_lo
    e_min_h = torch.where(f, torch.inf, e).amin(-1)
    e_max_h = torch.where(f, -torch.inf, e).amax(-1)
    median = ((e[..., 0] + e[..., 1]) + e[..., 2]) - e.amax(-1) - e.amin(-1)
    h = torch.where(f, 0.0, e)                       # the single healthy one
    lone = (h[..., 0] + h[..., 1]) + h[..., 2]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    eps_v = torch.where(
        n_f == 0, median,
        torch.where((n_f == 1) & (n_hi == 1), e_min_h,
                    torch.where((n_f == 1) & (n_lo == 1), e_max_h,
                                torch.where((n_f == 2) & (n_hi == 1), lone,
                                            zero))))
    voted_stuck = (n_hi >= 2) | (n_lo >= 2)
    fu_v = torch.where(voted_stuck, zero, zero + 1.0)
    sh_v = n_hi >= 2
    # channels without TMR consume replica 0 verbatim
    sel = nonideal_lib.to_tensor(tmr, dev, torch.bool)[..., None, :, None]
    return Draws(eps=torch.where(sel, eps_v, e[..., 0]),
                 fault_u=torch.where(sel, fu_v, rd.fault_u[..., 0]),
                 stuck_hi=torch.where(sel, sh_v, rd.stuck_hi[..., 0]),
                 drift=rd.drift)


def decode_genes(genes, channels: int, ft: FaultTolSpec
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode the appended fault-tolerance gene slice.

    genes: (..., ft.gene_bits(channels)) uint8. Returns ``(tmr, spares,
    cal)``: (..., C) int32 {0,1}, (..., C) int32 in [0, max_spares]
    (binary LSB-first, clipped), and (...) int32 {0,1}."""
    g = nonideal_lib.to_tensor(genes, dtype=torch.int32)
    if g.shape[-1] != ft.gene_bits(channels):
        raise ValueError(f"faulttol gene slice {g.shape[-1]} != "
                         f"{ft.gene_bits(channels)}")
    zeros = torch.zeros(g.shape[:-1] + (channels,), dtype=torch.int32)
    i = 0
    if ft.tmr:
        tmr = g[..., :channels]
        i = channels
    else:
        tmr = zeros
    sb = ft.spare_bits
    if sb:
        raw = g[..., i:i + channels * sb]
        raw = raw.reshape(raw.shape[:-1] + (channels, sb))
        weights = (2 ** torch.arange(sb)).to(torch.int32)
        spares = torch.clamp((raw * weights).sum(-1, dtype=torch.int32),
                             max=ft.max_spares)
        i += channels * sb
    else:
        spares = zeros
    cal = (g[..., i] if ft.calibrate
           else torch.zeros(g.shape[:-1], dtype=torch.int32))
    return tmr, spares, cal
