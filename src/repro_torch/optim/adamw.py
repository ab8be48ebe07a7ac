"""AdamW, hand-rolled. Counterpart of ``repro/optim/adamw.py`` (b2 = 0.95
by default, so not ``torch.optim.AdamW``'s defaults), with the same
operations in the same order, bias correction, global-norm clipping and
the state dtype (``opt_state_dtype``) included.

It updates in place: ``update_`` overwrites the parameter tensors and
the moment buffers, where the reference returns new arrays. The bias
corrections ``1 - b ** step`` are float32 ``torch.pow`` on the step
counter, as the reference's ``b1 ** step.astype(float32)``; a Python
``0.9 ** step`` would be float64 and could round 1 ulp away.

Two shapes of state. The printed classifiers' QAT loops keep lists
(``init``: a float32 step, float32 moments beside a list of leaves). The
LM keeps the reference's ``OptState`` tree (``init_tree``: an int32 step
and moments in the parameters' nested dicts), so a checkpoint's leaves are
named ``opt/step``, ``opt/m/...``, ``opt/v/...`` in both packages. Trees
flatten in the reference's leaf order (``tree_leaves``: dict keys sorted,
as ``jax.tree_util`` orders them).

Under tensor parallelism (``distributed/tensor_parallel.py``) a split
leaf is ``Shards``, one slice a rank on the rank's device: it flattens to
its slices in rank order, ``tree_map`` maps each slice and keeps the
split, and AdamW steps each slice elementwise on its device, so the
update is the whole leaf's. Under FSDP (``distributed/fsdp.py``) a leaf
split over the dp slices is ``Pieces``, each piece a tensor or
``Shards``: it flattens to its pieces in slice order (each piece's
slices in rank order), and AdamW steps each owner's piece elementwise.
The global norm sums the pieces' and slices' float32 square sums in a
fixed order, tree order then slice order then rank order, on the first
leaf's device; that order, not the whole leaf's, is the only difference
from one device (the clip scale may move by an ulp).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import torch

from repro_torch.distributed.fsdp import Pieces
from repro_torch.distributed.tensor_parallel import Shards


@dataclass
class OptState:
    step: torch.Tensor               # (): steps taken
    m: Any                           # a list of leaves, or the params' tree
    v: Any


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of nested dicts (or a list) in the reference's order:
    dict keys sorted at every level, None skipped."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [] if tree is None else [tree]


def tree_map(fn, tree):
    """``fn`` applied to every leaf of nested dicts (to each rank's slice
    of a ``Shards`` leaf, to each piece of a ``Pieces`` leaf), keeping the
    tree."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, Pieces):
        return tree.like([tree_map(fn, p) for p in tree])
    if isinstance(tree, Shards):
        return tree.like([fn(p) for p in tree])
    return fn(tree)


def init(leaves: Sequence[torch.Tensor]) -> OptState:
    """Zero moments for each parameter tensor, step 0."""
    dev = leaves[0].device
    return OptState(step=torch.zeros((), dtype=torch.float32, device=dev),
                    m=[torch.zeros_like(p, dtype=torch.float32)
                       for p in leaves],
                    v=[torch.zeros_like(p, dtype=torch.float32)
                       for p in leaves])


def init_tree(params, state_dtype: str = "float32") -> OptState:
    """The reference's ``init(params, state_dtype)``: an int32 step 0 and
    zero moments of ``state_dtype`` in the parameters' tree."""
    dt = getattr(torch, state_dtype)
    dev = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros_like(p, dtype=dt)  # noqa: E731
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the leaves' float32 square sums, leaf by leaf in
    the reference's order (a split leaf's pieces in slice order, each
    one's slices in rank order), on the first leaf's device."""
    leaves = tree_leaves(tree)
    dev = leaves[0].device
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())).to(dev)
                          for leaf in leaves))


@torch.no_grad()
def update_(leaves: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
            state: OptState, *, lr, b1: float = 0.9,
            b2: float = 0.95, eps: float = 1e-8,
            weight_decay: float = 0.0, grad_clip: float = 0.0,
            grad_norm: Optional[torch.Tensor] = None) -> OptState:
    """One AdamW step, in place on ``leaves`` and ``state`` (whose moments
    are lists beside ``leaves``, or trees flattened by ``tree_leaves``).
    ``lr`` is a float or a float32 scalar tensor (a schedule value). With
    ``grad_clip > 0`` the gradients are first scaled, in place, by
    ``min(1, grad_clip / max(norm, 1e-12))``, norm their ``global_norm``
    (``grad_norm`` when the caller has it already)."""
    copies = {}

    def on(t, dev):
        """A 0-d tensor on ``dev`` (copied once a device: split leaves'
        slices live on their ranks' devices)."""
        if not isinstance(t, torch.Tensor) or t.device == dev:
            return t
        key = (id(t), dev)
        if key not in copies:
            copies[key] = t.to(dev)
        return copies[key]

    if grad_clip and grad_clip > 0:
        gnorm = global_norm(grads) if grad_norm is None else grad_norm
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        for g in grads:
            g.mul_(on(scale, g.device))
    state.step.add_(1)
    # a Python scalar base is cast to the exponent's float32, on the device
    c1_, c2_ = (1.0 - torch.pow(b, state.step.float()) for b in (b1, b2))
    lr_ = lr
    for p, g, m, v in zip(leaves, grads, tree_leaves(state.m),
                          tree_leaves(state.v)):
        c1, c2, lr = (on(t, p.device) for t in (c1_, c2_, lr_))
        gf = g.float()
        if m.dtype == torch.float32:
            mf = m.mul_(b1).add_(gf * (1 - b1))
            vf = v.mul_(b2).add_(gf * gf * (1 - b2))
        else:                  # a narrower state: update in float32, store
            mf = m.float() * b1 + gf * (1 - b1)
            vf = v.float() * b2 + gf * gf * (1 - b2)
            m.copy_(mf)
            v.copy_(vf)
        u = (mf / c1) / (torch.sqrt(vf / c2) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        if p.dtype == torch.float32:
            p.sub_(lr * u)
        else:
            p.copy_(p.float() - lr * u)
    return state
