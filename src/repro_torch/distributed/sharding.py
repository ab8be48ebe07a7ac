"""Axis rules of the sharded search and the sharded design bank.
Counterpart of the population half of ``repro/distributed/sharding.py``
(``RULES_POPULATION``, ``population_axes``, ``design_bank_axes``,
``dp_axes``), copied in behaviour: the rules read only ``mesh.axis_names``
and ``mesh.shape``, so they take the port's ``launch.mesh.Mesh`` and the
reference tests' ``SimpleNamespace`` meshes alike. Of the LM rules only
the batch candidates and ``batch_axes`` are here (the train step's
``default_microbatches`` reads them); the parameter and cache rules
belong to a later slice of ROADMAP A11.

``shard_plan`` says where each shard runs: shard k of a leading axis
split over ``axes`` runs on the first device of the k-th slice of the
mesh along ``axes``; mesh axes not in ``axes`` replicate, as under
``shard_map``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

# GA individuals are embarrassingly parallel, so the population axis of
# the in-training ADC search (core/search.py, engine='sharded') may take
# every mesh axis: candidates tried in preference order; all axes present
# and the dim divides evenly
RULES_POPULATION: Tuple[Tuple[str, ...], ...] = (
    ("pod", "data", "model"), ("data", "model"), ("pod", "data"),
    ("data",), ("model",))


# the LM's batch candidates, tried in order (the "batch" rule of the
# reference's RULES_FSDP / RULES_TP_ONLY, and of RULES_EXTRA_DP for archs
# whose heads do not split over 'model', where that axis becomes extra
# data parallelism)
RULES_BATCH = (("pod", "data"), ("data",))
RULES_BATCH_EXTRA_DP = (("pod", "data", "model"), ("data", "model"),
                        ("pod", "data"), ("data",))


def batch_rules(cfg) -> Tuple[Tuple[str, ...], ...]:
    """The batch candidates of the reference's ``rules_for(cfg)``."""
    if cfg.grad_compression == "none" and getattr(cfg, "extra_dp", False):
        return RULES_BATCH_EXTRA_DP
    return RULES_BATCH


def batch_axes(mesh, cfg, b: int) -> Optional[Tuple[str, ...]]:
    """Mesh axes the batch dim shards over: the first candidate whose axes
    are all in the mesh, whose size exceeds 1 and divides ``b``."""
    for cand in batch_rules(cfg):
        axes = tuple(a for a in cand if a in mesh.axis_names)
        if len(axes) != len(cand):
            continue
        size = math.prod(mesh.shape[a] for a in axes)
        if size > 1 and b % size == 0:
            return axes
    return None


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def population_axes(mesh, p: int) -> Optional[Tuple[str, ...]]:
    """Mesh axes the (P,)-leading population batch shards over: the
    divisible candidate from RULES_POPULATION covering the most devices
    (ties go to the earlier candidate). A size-1 winner is legal (a
    trivial shard). None means no candidate divides P: the caller falls
    back to the unsharded path."""
    best: Optional[Tuple[str, ...]] = None
    best_size = 0
    for cand in RULES_POPULATION:
        axes = tuple(a for a in cand if a in mesh.axis_names)
        if len(axes) != len(cand):
            continue
        size = math.prod(mesh.shape[a] for a in axes)
        if p % size == 0 and size > best_size:
            best, best_size = axes, size
    return best


def design_bank_axes(mesh, d: int) -> Optional[Tuple[str, ...]]:
    """Mesh axes the (D,)-leading deployed-design bank shards over: a
    Pareto front's designs are independent as GA individuals are (one
    shared sample batch, per-design tables and weights), so the rules
    are the population rules."""
    return population_axes(mesh, d)


def shard_plan(mesh, axes: Optional[Tuple[str, ...]], n: int
               ) -> List[Tuple]:
    """``[(device, slice), ...]`` in shard order for a leading axis of
    length ``n`` split over ``axes``: shard k takes rows
    ``[k * n / s, (k + 1) * n / s)`` (s the product of the ``axes``
    sizes, major to minor in ``axes`` order) on the first device of the
    k-th slice of ``mesh.devices`` along ``axes``. A device that repeats
    in the mesh takes several shards. ``axes=None`` (no rule divides
    ``n``) is one unsharded entry on the mesh's first device. Raises if
    ``axes`` are not mesh axes or their size does not divide ``n``."""
    if axes is None:
        first = np.asarray(mesh.devices, dtype=object).reshape(-1)[0]
        return [(first, slice(0, n))]
    names = tuple(mesh.axis_names)
    axes = tuple(axes)
    missing = [a for a in axes if a not in names]
    if missing or len(set(axes)) != len(axes):
        raise ValueError(f"axes {axes} are not distinct axes of the mesh "
                         f"{names}")
    shards = math.prod(mesh.shape[a] for a in axes)
    if n % shards:
        raise ValueError(f"a leading axis of {n} does not split over "
                         f"{axes} ({shards} shards)")
    order = [names.index(a) for a in axes]
    order += [i for i in range(len(names)) if i not in order]
    grid = np.transpose(np.asarray(mesh.devices, dtype=object), order)
    firsts = grid.reshape(shards, -1)[:, 0]
    step = n // shards
    return [(dev, slice(k * step, (k + 1) * step))
            for k, dev in enumerate(firsts)]
