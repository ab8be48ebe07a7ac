"""NSGA-II (Deb et al. 2002) on binary genomes — the paper's search engine.
A verbatim numpy copy of ``repro/core/nsga2.py``, so a seeded run draws
the same genome stream in both packages (it is copied, not imported:
``repro.core`` pulls in JAX on import).

Same operator set the paper configures in pymoo: binary tournament on
(rank, crowding), uniform crossover with probability ``pc`` = 0.7, bit-flip
mutation with per-individual probability ``pm`` = 0.2 (applied per bit at
rate pm_bit = pm / sqrt(G) by default, see DESIGN.md §6.3), elitist
(mu + lambda) survival via fast non-dominated sort + crowding distance.

Vectorised numpy: populations are (P, G) uint8, fitnesses (P, M) float
(all objectives MINIMIZED). Deterministic under a seeded Generator.

The loop is factored into explicit state (``EvolveState``: population,
fitness, completed-generation counter, RNG) plus a pure-ish transition
(``evolve_step``), so a caller can checkpoint after every generation and
resume a killed run bit-identically: the restored Generator replays the
exact random stream the uninterrupted run would have drawn
(the reference's core/search.run_search wires this through its
checkpoint manager; the port's search checkpoint is a later slice).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np


def fast_non_dominated_sort(F: np.ndarray) -> np.ndarray:
    """Pareto rank (0 = front) for fitness matrix F (P, M), minimization."""
    P = F.shape[0]
    # dominated[i, j] = i dominates j
    le = (F[:, None, :] <= F[None, :, :]).all(-1)
    lt = (F[:, None, :] < F[None, :, :]).any(-1)
    dom = le & lt
    n_dom = dom.sum(0)                   # how many dominate j
    rank = np.full(P, -1, np.int32)
    front = np.where(n_dom == 0)[0]
    r = 0
    while front.size:
        rank[front] = r
        n_dom = n_dom - dom[front].sum(0)
        n_dom[rank >= 0] = np.iinfo(np.int32).max // 2
        front = np.where(n_dom == 0)[0]
        r += 1
    return rank


def crowding_distance(F: np.ndarray, rank: np.ndarray) -> np.ndarray:
    P, M = F.shape
    dist = np.zeros(P)
    for r in np.unique(rank):
        idx = np.where(rank == r)[0]
        if idx.size <= 2:
            dist[idx] = np.inf
            continue
        for m in range(M):
            order = idx[np.argsort(F[idx, m], kind="stable")]
            fmin, fmax = F[order[0], m], F[order[-1], m]
            dist[order[0]] = dist[order[-1]] = np.inf
            if fmax - fmin <= 0:
                continue
            gap = (F[order[2:], m] - F[order[:-2], m]) / (fmax - fmin)
            dist[order[1:-1]] += gap
    return dist


def _tournament(rng, rank, dist, k=2, n=None):
    """``n`` winners of binary tournaments (default: one per individual).
    ``n=None`` draws exactly the shapes the unscreened loop always drew,
    so a run with ``offspring_factor=1`` replays the historical RNG
    stream bit-for-bit."""
    P = rank.shape[0]
    n = P if n is None else n
    cand = rng.integers(0, P, size=(n, k))
    best = cand[:, 0]
    for j in range(1, k):
        c = cand[:, j]
        better = (rank[c] < rank[best]) | ((rank[c] == rank[best]) & (dist[c] > dist[best]))
        best = np.where(better, c, best)
    return best


@dataclass
class EvolveState:
    """Everything needed to continue (or bit-identically resume) a run:
    the current archive, how many generations are already done, and the
    numpy Generator whose stream drives selection/crossover/mutation."""
    pop: np.ndarray            # (P, G) uint8
    fit: np.ndarray            # (P, M) float64
    generation: int            # generations COMPLETED so far
    rng: np.random.Generator


def init_state(eval_fn: Callable[[np.ndarray], np.ndarray],
               genome_len: int,
               pop_size: int = 32,
               seed: int = 0,
               init: Optional[np.ndarray] = None) -> EvolveState:
    """Draw (or adopt) the initial population and evaluate it."""
    rng = np.random.default_rng(seed)
    if init is None:
        pop = (rng.random((pop_size, genome_len)) < 0.5).astype(np.uint8)
        pop[0] = 1                                   # seed the full (unpruned) design
    else:
        pop = init.astype(np.uint8).copy()
    fit = np.asarray(eval_fn(pop), np.float64)
    return EvolveState(pop, fit, 0, rng)


def evolve_step(state: EvolveState,
                eval_fn: Callable[[np.ndarray], np.ndarray],
                pc: float = 0.7,
                pm: float = 0.2,
                pm_bit: Optional[float] = None,
                offspring_factor: int = 1,
                screen_fn: Optional[Callable] = None,
                on_evaluated: Optional[Callable] = None) -> EvolveState:
    """One NSGA-II generation: selection -> variation -> evaluation ->
    (mu + lambda) elitist survival. Mutates ``state.rng``'s stream and
    returns the successor state.

    Surrogate screening (DESIGN.md §13): ``offspring_factor > 1``
    oversamples the offspring by that factor; ``screen_fn`` (candidates
    (n_off, G) -> index array, best first) then picks the ``pop_size``
    that enter the expensive evaluation. ``screen_fn`` must draw no
    randomness from ``state.rng`` — with ``offspring_factor=1`` every
    RNG draw has the historical shape, so the unscreened stream stays
    bit-identical. ``on_evaluated(genomes, fitness)`` fires after each
    evaluation with the true (genome, fitness) pairs — the surrogate's
    online-training feed."""
    pop, fit, rng = state.pop, state.fit, state.rng
    pop_size, glen = pop.shape
    n_off = pop_size * max(int(offspring_factor), 1)
    if pm_bit is None:
        pm_bit = pm / max(np.sqrt(glen), 1.0)
    rank = fast_non_dominated_sort(fit)
    dist = crowding_distance(fit, rank)
    parents_a = _tournament(rng, rank, dist, n=None if n_off == pop_size else n_off)
    parents_b = _tournament(rng, rank, dist, n=None if n_off == pop_size else n_off)
    xa, xb = pop[parents_a], pop[parents_b]
    do_x = (rng.random((n_off, 1)) < pc)
    mix = rng.random((n_off, glen)) < 0.5
    child = np.where(do_x & mix, xb, xa)
    flip = rng.random((n_off, glen)) < pm_bit
    child = np.where(flip, 1 - child, child).astype(np.uint8)
    if screen_fn is not None and n_off > pop_size:
        keep = np.asarray(screen_fn(child)).reshape(-1)[:pop_size]
        child = child[keep]
    cfit = np.asarray(eval_fn(child), np.float64)
    if on_evaluated is not None:
        on_evaluated(child, cfit)
    # (mu + lambda) elitist survival
    allpop = np.concatenate([pop, child])
    allfit = np.concatenate([fit, cfit])
    r = fast_non_dominated_sort(allfit)
    d = crowding_distance(allfit, r)
    order = np.lexsort((-d, r))
    keep = order[:pop_size]
    return EvolveState(allpop[keep], allfit[keep], state.generation + 1, rng)


def evolve(eval_fn: Callable[[np.ndarray], np.ndarray],
           genome_len: int,
           pop_size: int = 32,
           generations: int = 20,
           pc: float = 0.7,
           pm: float = 0.2,
           pm_bit: Optional[float] = None,
           seed: int = 0,
           init: Optional[np.ndarray] = None,
           log: Optional[Callable[[int, np.ndarray, np.ndarray], None]] = None,
           state: Optional[EvolveState] = None,
           on_generation: Optional[Callable[[EvolveState], None]] = None,
           offspring_factor: int = 1,
           screen_fn: Optional[Callable] = None,
           on_evaluated: Optional[Callable] = None,
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Run NSGA-II. ``eval_fn``: (P, G) uint8 -> (P, M) fitness (minimize).
    Returns (population, fitness) of the final archive (all evaluated, elitist).

    ``state``: resume from a prior ``EvolveState`` (e.g. restored from a
    checkpoint) instead of drawing a fresh initial population; generations
    already recorded in it are not re-run. ``on_generation`` fires after
    the initial evaluation and after every completed generation — the
    checkpoint hook. ``offspring_factor``/``screen_fn``/``on_evaluated``
    flow to ``evolve_step`` (surrogate screening, DESIGN.md §13);
    ``on_evaluated`` also fires on a fresh initial evaluation.
    """
    if state is None:
        state = init_state(eval_fn, genome_len, pop_size, seed, init)
        if on_evaluated is not None:
            on_evaluated(state.pop, state.fit)
        if on_generation is not None:
            on_generation(state)
    for g in range(state.generation, generations):
        state = evolve_step(state, eval_fn, pc, pm, pm_bit,
                            offspring_factor=offspring_factor,
                            screen_fn=screen_fn, on_evaluated=on_evaluated)
        if log is not None:
            log(g, state.pop, state.fit)
        if on_generation is not None:
            on_generation(state)
    return state.pop, state.fit


def pareto_front(pop: np.ndarray, fit: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    rank = fast_non_dominated_sort(fit)
    sel = rank == 0
    return pop[sel], fit[sel]
