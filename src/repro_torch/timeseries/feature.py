"""Analog feature front-end spec and the featurize path (DESIGN.md §14).
Counterpart of ``repro/timeseries/feature.py``.

``FeatureSpec`` names the analog front end the streaming co-search
explores: the subsample factor (the sample rate of the analog window
buffer), the temporal features computed per raw channel (windowed mean,
min, max and slope, each a switched-capacitor circuit) and the
per-feature-channel ADC allocation ladder. It is a frozen, hashable
dataclass with the reference's validation, messages and JSON
``to_meta``/``from_meta`` round trip, so either package reads the
other's fronts.

Genome encoding (core/search.py appends these after the dp bits):

  [ C_feat * 2^N mask | 4 dp | sub_bits subsample index
                             | C_feat * ALLOC_BITS alloc genes ]

where ``C_feat = channels * len(features)``, the subsample gene indexes
``sub_grid`` (LSB first), and each 2-bit alloc gene picks a rung of the
resolution ladder: 3 keeps every searched level, 2 every 2nd, 1 every
4th, 0 turns the feature channel off (one kept level, zero comparators:
the classifier sees a constant).

``featurize`` gives the reference's jitted featurize bit for bit. XLA
computes the mean as a left-to-right float32 sum times the float32
reciprocal of the count, and the slope as (last - first) times the
float32 reciprocal of its span: it rewrites a division by a constant
into that product. A true division, or ``torch.mean``, differs from it
in the last ulp for a large share of the windows, and one ulp moves a
quantization code at a level boundary. So every step here is its own
eager elementwise operation (no ``torch.mean``/``sum``/``cumsum``
reduction, no ``addcmul``, no ``torch.compile``): on the card each is
its own kernel, nothing contracts into an FMA, and the card and the CPU
give the same bits.

``featurize_fn`` returns one cached callable per ``(spec.base(), s)``;
the search-data build (``stack_variants``), the deployed single-design
path and the serving bank all go through it, so search fitness ==
export accuracy == served accuracy holds through the feature layer.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

FEATURE_KINDS = ("mean", "min", "max", "slope")
ALLOC_BITS = 2
FULL_ALLOC = 2 ** ALLOC_BITS - 1     # 3: keep every searched level


@dataclass(frozen=True)
class FeatureSpec:
    """The analog front-end design point. ``channels`` counts RAW sensor
    channels; the ADC and classifier see ``feature_channels`` =
    channels * len(features), ordered feature-kind-major (feature channel
    j carries kind ``features[j // channels]`` of raw ``j % channels``).
    ``subsample``/``alloc`` are None while searching (the genome supplies
    them) and baked into the deployed artifact by ``bake``."""
    channels: int
    window: int
    features: Tuple[str, ...] = FEATURE_KINDS
    sub_grid: Tuple[int, ...] = (1, 2, 4, 8)
    subsample: Optional[int] = None
    alloc: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "features", tuple(self.features))
        object.__setattr__(self, "sub_grid",
                           tuple(int(s) for s in self.sub_grid))
        if self.alloc is not None:
            object.__setattr__(self, "alloc",
                               tuple(int(a) for a in self.alloc))
        if self.channels < 1:
            raise ValueError(f"channels must be >= 1, got {self.channels}")
        if not self.features:
            raise ValueError("features must be non-empty")
        for f in self.features:
            if f not in FEATURE_KINDS:
                raise ValueError(f"unknown feature kind {f!r}; known: "
                                 f"{FEATURE_KINDS}")
        if len(set(self.features)) != len(self.features):
            raise ValueError(f"duplicate feature kinds: {self.features}")
        v = len(self.sub_grid)
        if v & (v - 1) or self.sub_grid[0] != 1:
            raise ValueError(f"sub_grid length must be a power of two and "
                             f"start at factor 1 (the full-rate reference "
                             f"design), got {self.sub_grid}")
        if tuple(sorted(set(self.sub_grid))) != self.sub_grid:
            raise ValueError(f"sub_grid must be strictly increasing, got "
                             f"{self.sub_grid}")
        for s in self.sub_grid:
            if s & (s - 1):
                raise ValueError(f"subsample factors must be powers of two "
                                 f"(clock dividers), got {s}")
            if self.window % s or self.window // s < 2:
                raise ValueError(f"window {self.window} must divide by "
                                 f"every sub_grid factor with >= 2 samples "
                                 f"left (slope needs two), got factor {s}")
        if self.subsample is not None and self.subsample not in self.sub_grid:
            raise ValueError(f"baked subsample {self.subsample} not in "
                             f"sub_grid {self.sub_grid}")
        if self.alloc is not None:
            if len(self.alloc) != self.feature_channels:
                raise ValueError(f"alloc must carry one gene per feature "
                                 f"channel ({self.feature_channels}), got "
                                 f"{len(self.alloc)}")
            for a in self.alloc:
                if not 0 <= a <= FULL_ALLOC:
                    raise ValueError(f"alloc genes live in "
                                     f"[0, {FULL_ALLOC}], got {a}")

    # ------------------------------------------------------------ geometry
    @property
    def feature_channels(self) -> int:
        return self.channels * len(self.features)

    @property
    def sub_bits(self) -> int:
        """Genome bits of the subsample gene: log2(len(sub_grid))."""
        return (len(self.sub_grid) - 1).bit_length()

    @property
    def gene_bits(self) -> int:
        """Feature genes appended to the base ADC genome."""
        return self.sub_bits + self.feature_channels * ALLOC_BITS

    # ------------------------------------------------------------- algebra
    def replace(self, **kw) -> "FeatureSpec":
        return dataclasses.replace(self, **kw)

    def base(self) -> "FeatureSpec":
        """The searchable spec: baked per-design fields stripped."""
        return self.replace(subsample=None, alloc=None)

    def bake(self, subsample: int, alloc) -> "FeatureSpec":
        """Freeze one searched design point into the spec (the deploy
        path: ``DeployedClassifier.feature`` carries the baked form)."""
        return self.replace(subsample=int(subsample),
                            alloc=tuple(int(a) for a in alloc))

    # ---------------------------------------------------------------- meta
    def to_meta(self) -> Dict:
        return {"channels": self.channels, "window": self.window,
                "features": list(self.features),
                "sub_grid": list(self.sub_grid),
                "subsample": self.subsample,
                "alloc": None if self.alloc is None else list(self.alloc)}

    @classmethod
    def from_meta(cls, meta: Dict) -> "FeatureSpec":
        return cls(channels=int(meta["channels"]),
                   window=int(meta["window"]),
                   features=tuple(meta["features"]),
                   sub_grid=tuple(meta["sub_grid"]),
                   subsample=(None if meta.get("subsample") is None
                              else int(meta["subsample"])),
                   alloc=(None if meta.get("alloc") is None
                          else tuple(meta["alloc"])))

    def describe(self) -> str:
        baked = (f" sub={self.subsample} alloc={self.alloc}"
                 if self.subsample is not None else "")
        return (f"feat[{'/'.join(self.features)}] W={self.window} "
                f"C={self.channels}->{self.feature_channels} "
                f"grid={self.sub_grid}{baked}")


# ------------------------------------------------------------ featurize
@functools.lru_cache(maxsize=None)
def _reciprocal(count: int, device: torch.device) -> torch.Tensor:
    """float32(1) / float32(count), a 0-d float32 tensor on ``device``:
    the constant XLA multiplies by in place of dividing by ``count``.
    Built once per (count, device); callers must not write to it."""
    one = torch.ones((), dtype=torch.float32)
    return (one / torch.tensor(float(count), dtype=torch.float32)).to(device)


def as_windows(windows, device: DeviceLike = None) -> torch.Tensor:
    """(M, W, C_raw) float32 windows as a tensor: on ``device`` when
    given, else a tensor's own device, and ``cuda`` for numpy input."""
    if isinstance(windows, torch.Tensor):
        dev = windows.device if device is None else resolve_device(device)
        return windows.to(dev, torch.float32)
    return torch.as_tensor(np.asarray(windows, np.float32)).to(
        resolve_device(device))


def featurize(windows, spec: FeatureSpec, subsample: int, *,
              device: DeviceLike = None) -> torch.Tensor:
    """(M, W, C_raw) windows -> (M, feature_channels) float32, feature-
    kind-major, on ``device`` (a tensor's own device by default, ``cuda``
    for numpy input). ``slope`` normalizes by the ORIGINAL-rate sample
    span, so its scale is comparable across subsample factors. Bit for
    bit the reference's jitted featurize (module docstring)."""
    s = int(subsample)
    x = as_windows(windows, device)
    xs = x[:, ::s, :]
    w_s = xs.shape[1]
    cols = []
    for kind in spec.features:
        if kind == "mean":
            acc = xs[:, 0]
            for i in range(1, w_s):
                acc = acc + xs[:, i]
            cols.append(acc * _reciprocal(w_s, x.device))
        elif kind == "min":
            cols.append(torch.amin(xs, dim=1))
        elif kind == "max":
            cols.append(torch.amax(xs, dim=1))
        else:                                     # slope
            diff = xs[:, -1] - xs[:, 0]
            cols.append(diff * _reciprocal(s * (w_s - 1), x.device))
    return torch.cat(cols, dim=1).contiguous()


@functools.lru_cache(maxsize=None)
def _featurize_cached(spec: FeatureSpec, subsample: int) -> Callable:
    def fn(windows, *, device: DeviceLike = None) -> torch.Tensor:
        return featurize(windows, spec, subsample, device=device)
    return fn


def featurize_fn(spec: FeatureSpec, subsample: Optional[int] = None
                 ) -> Callable:
    """The one featurize callable for (spec, subsample): search data
    build, deploy and serving all go through here, as in the reference.
    The callable takes ``(windows, *, device=None)``."""
    s = spec.subsample if subsample is None else subsample
    if s is None:
        raise ValueError("featurize_fn needs a subsample factor: pass one "
                         "or use a baked FeatureSpec")
    return _featurize_cached(spec.base(), int(s))


def stack_variants(windows, spec: FeatureSpec, *,
                   device: DeviceLike = None) -> np.ndarray:
    """(M, W, C_raw) -> (V, M, feature_channels) float32 numpy: one
    featurized variant per sub_grid factor, computed on ``device``
    (default ``cuda``): the co-search's data layout (the subsample gene
    picks a variant per individual)."""
    dev = resolve_device(device)
    return np.stack([featurize_fn(spec, s)(windows, device=dev).cpu().numpy()
                     for s in spec.sub_grid])


# ----------------------------------------------------------- gene codec
def encode_genes(spec: FeatureSpec, sub_index: int = 0,
                 alloc=None) -> np.ndarray:
    """(sub_index, alloc) -> the (gene_bits,) uint8 tail of a co-search
    genome (LSB first, matching core/search's decode). Defaults encode
    the full-rate, full-allocation front end: the embedding of an
    ADC-only design into the co-search space."""
    if not 0 <= sub_index < len(spec.sub_grid):
        raise ValueError(f"sub_index {sub_index} out of range for grid "
                         f"{spec.sub_grid}")
    alloc = ([FULL_ALLOC] * spec.feature_channels if alloc is None
             else list(alloc))
    sub = (sub_index >> np.arange(spec.sub_bits)) & 1
    al = (np.asarray(alloc)[:, None] >> np.arange(ALLOC_BITS)) & 1
    return np.concatenate([sub, al.reshape(-1)]).astype(np.uint8)


# ----------------------------------------------------------- area bridge
def frontend_tc(spec: FeatureSpec, subsample: int, alloc=None) -> int:
    """Exact transistor count of this front-end design point
    (``core.area.frontend_tc`` with the spec unpacked). The import is
    lazy, as in the reference: core/search imports this module."""
    from repro_torch.core import area
    return area.frontend_tc(spec.features, spec.channels, spec.window,
                            subsample, alloc)


def frontend_full_tc(spec: FeatureSpec) -> int:
    """The full-rate, all-features reference front end: the fixed cost a
    deployed ADC-only design pays, and the co-search area column's
    normalization partner of ``flash_full_tc * C_feat``."""
    return frontend_tc(spec, 1, None)
