"""Sensor-classification datasets (paper §4: Seeds, WhiteWine, Cardio,
Mammographic, ...).

This container is offline, so the UCI sets are replaced by *seeded synthetic
equivalents* with identical dimensionality, class count, sample count, [0,1]
normalization and 70/30 stratified split (DESIGN.md §6.2). Each class is a
2-component Gaussian mixture whose means/scales are drawn per-dataset from a
fixed seed; difficulty is tuned so full-precision MLP accuracy lands in the
70-95% band the paper reports, leaving real headroom for the pruning study.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class TabularSpec:
    name: str
    features: int
    classes: int
    samples: int
    hidden: int            # printed-MLP hidden width (Mubarik et al. style)
    difficulty: float      # Gaussian sigma scale (bigger = harder)


SPECS: Dict[str, TabularSpec] = {
    # name                feat cls  n    hid  sigma
    "seeds":        TabularSpec("seeds", 7, 3, 210, 3, 0.12),
    "whitewine":    TabularSpec("whitewine", 11, 7, 1500, 6, 0.14),
    "cardio":       TabularSpec("cardio", 21, 3, 2126, 5, 0.20),
    "mammographic": TabularSpec("mammographic", 5, 2, 961, 3, 0.18),
    "redwine":      TabularSpec("redwine", 11, 6, 1500, 5, 0.21),
    "vertebral":    TabularSpec("vertebral", 6, 3, 310, 3, 0.16),
}


def make_dataset(name: str, seed: int = 0) -> Dict[str, np.ndarray]:
    """Returns dict(x_train, y_train, x_test, y_test), features in [0, 1]."""
    import zlib
    spec = SPECS[name]
    # zlib.crc32: stable across processes (hash() is PYTHONHASHSEED-random)
    rng = np.random.default_rng(zlib.crc32(name.encode()) + seed)
    n_per = spec.samples // spec.classes
    xs, ys = [], []
    for c in range(spec.classes):
        # two mixture components per class
        for comp in range(2):
            mean = rng.uniform(0.2, 0.8, size=spec.features)
            sigma = rng.uniform(0.5, 1.5, size=spec.features) * spec.difficulty
            cnt = n_per // 2 + (n_per % 2 if comp == 0 else 0)
            pts = rng.normal(mean, sigma, size=(cnt, spec.features))
            xs.append(pts)
            ys.append(np.full(cnt, c, np.int32))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys)
    # normalize to [0, 1] exactly as the paper does (per-feature min/max)
    x = (x - x.min(0)) / np.maximum(x.max(0) - x.min(0), 1e-9)
    return stratified_split(x, y, test_frac=0.30, seed=seed)


def stratified_split(x: np.ndarray, y: np.ndarray, test_frac: float,
                     seed: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed + 17)
    tr_idx, te_idx = [], []
    for c in np.unique(y):
        idx = np.where(y == c)[0]
        rng.shuffle(idx)
        k = max(1, int(round(len(idx) * test_frac)))
        te_idx.append(idx[:k])
        tr_idx.append(idx[k:])
    tr = np.concatenate(tr_idx)
    te = np.concatenate(te_idx)
    rng.shuffle(tr)
    return {"x_train": x[tr], "y_train": y[tr],
            "x_test": x[te], "y_test": y[te]}


def dataset_names() -> Tuple[str, ...]:
    return tuple(SPECS)
