"""Online surrogate fitness predictor for surrogate-screened NSGA-II.
Counterpart of ``repro/core/surrogate.py``.

A tiny MLP maps a genome's bits straight to a predicted fitness row.
Every true (genome, fitness) pair an exact QAT evaluation produces goes
into a fixed-capacity ring buffer, and the predictor retrains on the
whole buffer (a fixed number of full-batch AdamW steps), so its state is
a pure function of the observation history and the seed. That is what
lets a checkpointed search resume screening bit-identically
(``core/search.search_state_tree`` stores its leaves).

``screen`` ranks candidates by predicted fitness with the ordering
NSGA-II survival uses (ascending Pareto rank, descending crowding
distance) and draws no randomness, so ``screen_factor=1`` leaves the
evolutionary stream untouched. The true fitness of every kept candidate
is still measured exactly, so screening decides who is evaluated, never
what an evaluation reports.

Initial weights come from a ``torch.Generator`` seeded with
``seed ^ _SEED_MIX``: a documented stream, not the reference's
``jax.random`` one. ``leaves`` / ``state_from_numpy`` carry a state in
the reference's leaf order, shapes and dtypes (params, the optimizer's
int32 step, m, v, then x, y, count, ptr), so a screened search
checkpoint written by either package restores in the other.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core import nsga2
from repro_torch.device import resolve_device
from repro_torch.models import mlp as mlp_lib
from repro_torch.optim import adamw

CAPACITY = 1024          # observation ring-buffer rows
_SEED_MIX = 0x5A17       # decorrelates from the QAT model init stream


@dataclass
class SurrogateState:
    """Predictor and its training history. ``observe`` returns a new
    state and leaves its argument as it was."""
    params: list             # MLP (glen -> hidden -> n_obj): [(W, b), ...]
    opt: adamw.OptState
    x: torch.Tensor          # (CAPACITY, glen) float32 observed genomes
    y: torch.Tensor          # (CAPACITY, n_obj) float32 observed fitness
    count: int               # observations held (saturates at CAPACITY)
    ptr: int                 # ring write head

    @property
    def device(self) -> torch.device:
        return self.x.device


def _param_leaves(params) -> List[torch.Tensor]:
    return [t for layer in params for t in layer]


def init(glen: int, n_obj: int, hidden: int = 32, seed: int = 0,
         device=None) -> SurrogateState:
    """Fresh predictor on ``device`` (default ``cuda``), deterministic
    in (glen, n_obj, hidden, seed)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed ^ _SEED_MIX)
    params = [(w.to(dev), b.to(dev))
              for w, b in mlp_lib.init_mlp(gen, (glen, hidden, n_obj))]
    return SurrogateState(
        params=params, opt=adamw.init(_param_leaves(params)),
        x=torch.zeros((CAPACITY, glen), dtype=torch.float32, device=dev),
        y=torch.zeros((CAPACITY, n_obj), dtype=torch.float32, device=dev),
        count=0, ptr=0)


def _as_rows(a, device) -> torch.Tensor:
    """Host genomes or fitness -> float32 rows on ``device`` (a float64
    fitness rounds to nearest, as the reference's cast does)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


def observe(state: SurrogateState, genomes: np.ndarray,
            fitness: np.ndarray, steps: int = 64,
            lr: float = 1e-2) -> SurrogateState:
    """Ring-insert a (B, glen) / (B, n_obj) batch of true observations,
    then retrain ``steps`` full-batch AdamW steps on the valid rows
    (masked MSE). A batch longer than the ring keeps its last CAPACITY
    rows, as writing it row by row would."""
    dev = state.device
    gx, gy = _as_rows(genomes, dev), _as_rows(fitness, dev)
    b = gx.shape[0]
    kept = min(b, CAPACITY)
    idx = (state.ptr + torch.arange(b - kept, b, device=dev)) % CAPACITY
    x, y = state.x.clone(), state.y.clone()
    x[idx] = gx[b - kept:]
    y[idx] = gy[b - kept:]
    count = min(state.count + b, CAPACITY)
    ptr = (state.ptr + b) % CAPACITY
    valid = (torch.arange(CAPACITY, device=dev) < count).float()[:, None]
    denom = torch.clamp(valid.sum() * y.shape[1], min=1.0)
    params = [(w.detach().clone().requires_grad_(True),
               bb.detach().clone().requires_grad_(True))
              for w, bb in state.params]
    leaves = _param_leaves(params)
    opt = adamw.OptState(step=state.opt.step.clone(),
                         m=[t.clone() for t in state.opt.m],
                         v=[t.clone() for t in state.opt.v])
    for _ in range(int(steps)):
        err = (mlp_lib.apply_mlp(params, x) - y) ** 2
        loss = (err * valid).sum() / denom
        grads = torch.autograd.grad(loss, leaves)
        adamw.update_(leaves, grads, opt, lr=lr)
    params = [(w.detach(), bb.detach()) for w, bb in params]
    return SurrogateState(params, opt, x, y, count, ptr)


def predict(state: SurrogateState, genomes: np.ndarray) -> np.ndarray:
    """(n, glen) genomes -> (n, n_obj) predicted fitness rows (float64
    of the float32 prediction)."""
    with torch.no_grad():
        out = mlp_lib.apply_mlp(state.params, _as_rows(genomes,
                                                        state.device))
    return out.cpu().numpy().astype(np.float64)


def screen(state: SurrogateState, candidates: np.ndarray, keep: int,
           override_cols=None) -> np.ndarray:
    """Candidate indices, best first, in NSGA-II survival order on the
    predicted fitness: ascending Pareto rank, descending crowding
    distance; the first ``keep`` (all of them when fewer).
    ``override_cols`` ({column: (n,) exact values}) replaces predicted
    columns the caller can compute exactly (the area objective is a
    deterministic function of the genome). Draws no randomness."""
    pred = predict(state, candidates)
    for j, col in (override_cols or {}).items():
        pred[:, j] = np.asarray(col, np.float64)
    rank = nsga2.fast_non_dominated_sort(pred)
    dist = nsga2.crowding_distance(pred, rank)
    order = np.lexsort((-dist, rank))
    return order[:keep]


# ----------------------------------------------------- checkpoint leaves
def leaves(state: SurrogateState) -> List[np.ndarray]:
    """The state as numpy leaves in the reference's flattening order:
    params (W, b per layer), opt step (int32), m, v, x, y, count (int32),
    ptr (int32)."""
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    step = np.asarray(int(state.opt.step.item()), np.int32)
    return ([host(t) for t in _param_leaves(state.params)] + [step]
            + [host(t) for t in state.opt.m]
            + [host(t) for t in state.opt.v]
            + [host(state.x), host(state.y),
               np.asarray(state.count, np.int32),
               np.asarray(state.ptr, np.int32)])


def state_from_numpy(arrays: Sequence[np.ndarray],
                     device=None) -> SurrogateState:
    """Inverse of ``leaves``: a state from its numpy leaves, such as a
    reference ``SurrogateState`` flattened to numpy (or a checkpoint's
    ``surrogate_{i}`` leaves), on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    arrays = [np.asarray(a) for a in arrays]
    n = (len(arrays) - 5) // 3                  # parameter leaves
    if n < 2 or len(arrays) != 3 * n + 5 or n % 2:
        raise ValueError(f"{len(arrays)} leaves do not form a surrogate "
                         f"state (params, step, m, v, x, y, count, ptr)")
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a, np.float32)).to(dev)
    p = [t(a) for a in arrays[:n]]
    step = torch.tensor(float(arrays[n]), dtype=torch.float32, device=dev)
    opt = adamw.OptState(step=step,
                         m=[t(a) for a in arrays[n + 1:2 * n + 1]],
                         v=[t(a) for a in arrays[2 * n + 1:3 * n + 1]])
    x, y, count, ptr = arrays[3 * n + 1:]
    return SurrogateState(params=list(zip(p[0::2], p[1::2])), opt=opt,
                          x=t(x), y=t(y), count=int(count), ptr=int(ptr))
