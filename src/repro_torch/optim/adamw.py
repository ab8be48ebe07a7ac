"""AdamW with float32 state, hand-rolled. Counterpart of
``repro/optim/adamw.py`` (b2 = 0.95 by default, so not
``torch.optim.AdamW``'s defaults), with the same operations in the same
order, bias correction included.

It updates in place: ``update_`` overwrites the parameter tensors and
the moment buffers, where the reference returns new arrays. The step
counter is a float32 tensor on the parameters' device, and the bias
corrections ``1 - b ** step`` are float32 ``torch.pow`` on it, as the
reference's ``b1 ** step.astype(float32)``; a Python ``0.9 ** step``
would be float64 and could round 1 ulp away.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch


@dataclass
class OptState:
    step: torch.Tensor               # () float32: steps taken
    m: List[torch.Tensor]
    v: List[torch.Tensor]


def init(leaves: Sequence[torch.Tensor]) -> OptState:
    """Zero moments for each parameter tensor, step 0."""
    dev = leaves[0].device
    return OptState(step=torch.zeros((), dtype=torch.float32, device=dev),
                    m=[torch.zeros_like(p, dtype=torch.float32)
                       for p in leaves],
                    v=[torch.zeros_like(p, dtype=torch.float32)
                       for p in leaves])


@torch.no_grad()
def update_(leaves: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
            state: OptState, *, lr: float, b1: float = 0.9,
            b2: float = 0.95, eps: float = 1e-8,
            weight_decay: float = 0.0) -> OptState:
    """One AdamW step, in place on ``leaves`` and ``state``."""
    state.step.add_(1.0)
    # a Python scalar base is cast to the exponent's float32, on the device
    c1 = 1.0 - torch.pow(b1, state.step)
    c2 = 1.0 - torch.pow(b2, state.step)
    for p, g, m, v in zip(leaves, grads, state.m, state.v):
        gf = g.float()
        m.mul_(b1).add_(gf * (1 - b1))
        v.mul_(b2).add_(gf * gf * (1 - b2))
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        p.sub_(lr * u)
    return state
