"""Synthetic multichannel vitals/stress streams (DESIGN.md §14). A
verbatim numpy copy of ``repro/timeseries/stream.py``: every
``(name, seed)`` gives the reference's arrays bit for bit. It is copied,
not imported: ``repro.timeseries`` pulls in JAX on import.

The co-design workload of arXiv:2508.19661: continuous multichannel
physiological monitoring where each channel lives in its own physical
range (heart rate in bpm, skin conductance in µS, temperature in °C,
acceleration in g) — the heterogeneous-range scenario the per-channel
``AdcSpec`` vmin/vmax serves. Episodes are class-conditioned
recordings (baseline level + oscillation + trend + noise per channel,
archetypes drawn once per (class, channel)); classification operates on
sliding windows, so the temporal features ``timeseries/feature.py``
extracts (windowed mean/min/max/slope) carry the class signal.

Determinism mirrors ``data/tabular.py``: everything — archetypes,
episode synthesis, the split — is a pure function of ``(name, seed)``
via ``default_rng(crc32(name) + seed)``. The train/test split is
stratified at the *episode* level, never the window level: windows of
one recording overlap (stride < window), so a window-level split would
leak near-duplicates across the boundary.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class StreamSpec:
    """One synthetic streaming workload: stream geometry + per-channel
    physical ranges (the heterogeneous analog front-end the ADC's
    per-channel vmin/vmax must cover)."""
    name: str
    channels: int
    classes: int
    episodes: int            # recordings; class = episode index % classes
    episode_len: int         # samples per recording
    window: int              # sliding-window length (samples)
    stride: int              # window hop (< window -> overlapping)
    vmin: Tuple[float, ...]  # per-channel physical minimum
    vmax: Tuple[float, ...]  # per-channel physical maximum
    noise: float             # per-sample noise sigma (fraction of range)

    def __post_init__(self):
        if len(self.vmin) != self.channels or len(self.vmax) != self.channels:
            raise ValueError(f"{self.name}: vmin/vmax must carry one entry "
                             f"per channel ({self.channels})")
        if self.window > self.episode_len or self.stride < 1:
            raise ValueError(f"{self.name}: window {self.window} must fit "
                             f"in episode_len {self.episode_len} and "
                             f"stride must be >= 1")


SPECS: Dict[str, StreamSpec] = {
    # wrist-wearable stress monitoring: HR (bpm), EDA (µS), skin temp
    # (°C), accelerometer magnitude (g)
    "stress": StreamSpec("stress", channels=4, classes=3, episodes=48,
                         episode_len=256, window=32, stride=16,
                         vmin=(40.0, 0.0, 30.0, -2.0),
                         vmax=(180.0, 20.0, 40.0, 2.0), noise=0.05),
    # bedside vitals: HR, SpO2 (%), resp rate, systolic/diastolic
    # pressure (mmHg), core temp — binary deterioration alarm
    "vitals": StreamSpec("vitals", channels=6, classes=2, episodes=40,
                         episode_len=192, window=24, stride=12,
                         vmin=(40.0, 80.0, 5.0, 80.0, 40.0, 34.0),
                         vmax=(180.0, 100.0, 40.0, 200.0, 120.0, 42.0),
                         noise=0.04),
}


def stream_names() -> Tuple[str, ...]:
    return tuple(sorted(SPECS))


def _windows(episode: np.ndarray, window: int, stride: int) -> np.ndarray:
    """(T, C) episode -> (num_windows, window, C) overlapping windows."""
    starts = np.arange(0, len(episode) - window + 1, stride)
    return np.stack([episode[s:s + window] for s in starts])


def _episode_split(classes_of: np.ndarray, test_frac: float,
                   seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Stratified episode-level split — the same shuffle-head idiom as
    ``tabular.stratified_split`` applied to episode ids, so overlapping
    windows of one recording never straddle the train/test boundary."""
    rng = np.random.default_rng(seed + 17)
    train_ids, test_ids = [], []
    for c in np.unique(classes_of):
        ids = np.where(classes_of == c)[0]
        rng.shuffle(ids)
        k = max(1, int(round(len(ids) * test_frac)))
        test_ids.append(ids[:k])
        train_ids.append(ids[k:])
    return np.concatenate(train_ids), np.concatenate(test_ids)


def make_stream(name: str, seed: int = 0) -> Dict[str, np.ndarray]:
    """Synthesize the named stream and return sliding-window splits:
    ``{'x_train': (M_tr, W, C) f32, 'y_train', 'x_test', 'y_test'}``.
    Window labels inherit the episode class. Pure function of
    ``(name, seed)`` — re-running reproduces every array bit-for-bit."""
    spec = SPECS[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()) + seed)
    C, K = spec.channels, spec.classes
    # per-(class, channel) archetypes, in fraction-of-range units
    level = rng.uniform(0.30, 0.70, (K, C))
    amp = rng.uniform(0.05, 0.20, (K, C))
    freq = rng.uniform(0.02, 0.12, (K, C))       # cycles per sample
    trend = rng.uniform(-0.15, 0.15, (K, C))
    lo = np.asarray(spec.vmin, np.float64)
    span = np.asarray(spec.vmax, np.float64) - lo
    t = np.arange(spec.episode_len, dtype=np.float64)[:, None]
    cls_of = np.arange(spec.episodes) % K
    episodes = []
    for e in range(spec.episodes):
        c = cls_of[e]
        phase = rng.uniform(0.0, 2.0 * np.pi, C)
        jitter = rng.normal(0.0, 0.03, C)
        frac = (level[c] + jitter
                + amp[c] * np.sin(2.0 * np.pi * freq[c] * t + phase)
                + trend[c] * (t / spec.episode_len)
                + rng.normal(0.0, spec.noise, (spec.episode_len, C)))
        episodes.append(lo + span * np.clip(frac, 0.0, 1.0))
    tr_ids, te_ids = _episode_split(cls_of, 0.30, seed)

    def gather(ids):
        xs = [_windows(episodes[i], spec.window, spec.stride) for i in ids]
        ys = [np.full(len(w), cls_of[i], np.int32)
              for i, w in zip(ids, xs)]
        return (np.concatenate(xs).astype(np.float32), np.concatenate(ys))

    x_tr, y_tr = gather(tr_ids)
    x_te, y_te = gather(te_ids)
    perm = rng.permutation(len(x_tr))
    return {"x_train": x_tr[perm], "y_train": y_tr[perm],
            "x_test": x_te, "y_test": y_te}
