"""AdcSpec: the one object that describes a binary-search ADC design
point. Counterpart of ``repro/core/spec.py``.

Ranges normalize to hashable python floats (shared across channels) or
tuples of floats (one per channel), so a spec is hashable and compares by
value. ``to_meta``/``from_meta`` give the same JSON form as the reference,
so a front saved by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np

from repro_torch.core import adc

Range = Union[float, Tuple[float, ...]]

_MODES = ("tree", "nearest")


def normalize_range(v) -> Range:
    """Coerce a range endpoint to its canonical hashable form: a python
    float or a tuple of python floats. Accepts scalars, lists/tuples and
    numpy arrays or tensors. A length-1 sequence stays a tuple."""
    if isinstance(v, (list, tuple)) or (
            hasattr(v, "ndim") and getattr(v, "ndim", 0) > 0):
        return tuple(float(x) for x in np.asarray(v).reshape(-1))
    return float(v)


@dataclasses.dataclass(frozen=True)
class AdcSpec:
    """Frozen description of one (possibly per-channel) binary-search ADC.

    bits: resolution (2^bits levels per channel).
    mode: pruned-tree semantics: 'tree' (circuit-faithful) | 'nearest'.
    vmin/vmax: analog range, scalar or per-channel tuple (len == C).
    """
    bits: int
    mode: str = "tree"
    vmin: Range = 0.0
    vmax: Range = 1.0

    def __post_init__(self):
        if self.bits < 1:
            raise ValueError(f"ADC needs >= 1 bit, got {self.bits}")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, "
                             f"got {self.mode!r}")
        lo = normalize_range(self.vmin)
        hi = normalize_range(self.vmax)
        object.__setattr__(self, "vmin", lo)
        object.__setattr__(self, "vmax", hi)
        if (isinstance(lo, tuple) and isinstance(hi, tuple)
                and len(lo) != len(hi)):
            raise ValueError(f"per-channel vmin has {len(lo)} channels but "
                             f"vmax has {len(hi)}")
        if np.any(np.asarray(hi, np.float64) <= np.asarray(lo, np.float64)):
            raise ValueError(f"vmax must exceed vmin elementwise: "
                             f"vmin={lo} vmax={hi}")

    @property
    def levels(self) -> int:
        """Quantization levels per channel (2^bits)."""
        return 2 ** self.bits

    @property
    def per_channel(self) -> bool:
        """True when either range endpoint varies across channels."""
        return isinstance(self.vmin, tuple) or isinstance(self.vmax, tuple)

    @property
    def channels(self) -> Optional[int]:
        """Channel count pinned by a per-channel range (None if scalar)."""
        for v in (self.vmin, self.vmax):
            if isinstance(v, tuple):
                return len(v)
        return None

    def validate_channels(self, channels: int) -> "AdcSpec":
        """Raise unless this spec can drive ``channels`` sensor channels."""
        pinned = self.channels
        if pinned is not None and pinned != channels:
            raise ValueError(
                f"AdcSpec pins {pinned} per-channel range(s) but the data "
                f"has {channels} channels")
        return self

    def range_rows(self, channels: int):
        """The code-math operands: f32 numpy rows ``(vmin_row (1, C),
        scale_row (1, C))``, computed in f64 and cast once
        (``adc.range_rows``). Every code-deriving path, plain or kernel,
        uses these exact constants."""
        self.validate_channels(channels)
        return adc.range_rows(self.bits, self.vmin, self.vmax, channels)

    def level_values(self, channels: Optional[int] = None):
        """Reconstruction value of every level: (2^bits,) for a scalar
        range, (C, 2^bits) per-channel."""
        if self.per_channel:
            self.validate_channels(channels if channels is not None
                                   else self.channels)
        return adc.level_values(self.bits, self.vmin, self.vmax)

    def value_table(self, mask):
        """Bake a pruned mask ((C, 2^bits) or (P, C, 2^bits)) into the
        code->value table the kernels consume (kernels/ref.value_table)."""
        from repro_torch.kernels import ref
        if len(mask.shape) >= 2:
            self.validate_channels(mask.shape[-2])
        return ref.value_table(mask, self.bits, self.vmin, self.vmax,
                               self.mode)

    def replace(self, **kw) -> "AdcSpec":
        return dataclasses.replace(self, **kw)

    def to_meta(self) -> dict:
        """JSON-safe dict (tuples become lists; ``from_meta`` restores)."""
        v = lambda r: list(r) if isinstance(r, tuple) else r  # noqa: E731
        return {"bits": self.bits, "mode": self.mode,
                "vmin": v(self.vmin), "vmax": v(self.vmax)}

    @classmethod
    def from_meta(cls, meta: dict) -> "AdcSpec":
        return cls(bits=int(meta["bits"]), mode=str(meta["mode"]),
                   vmin=normalize_range(meta["vmin"]),
                   vmax=normalize_range(meta["vmax"]))

    @classmethod
    def from_data(cls, x, bits: int, *, pct: float = 0.5,
                  mode: str = "tree") -> "AdcSpec":
        """Derive per-channel analog ranges from training data: vmin/vmax
        are the per-channel ``pct``/``100 - pct`` percentiles of ``x``
        (any leading shape, channels last), in float64: the auto-range
        path of the search CLI (``--auto-range``). A clipped tail
        (``pct > 0``) spends the code range on the bulk of the
        distribution instead of outliers. Constant channels widen by a
        relative epsilon so the spec stays valid (vmax > vmin)."""
        if not 0.0 <= pct < 50.0:
            raise ValueError(f"pct must lie in [0, 50), got {pct}")
        flat = np.asarray(x, np.float64).reshape(-1, np.shape(x)[-1])
        lo = np.percentile(flat, pct, axis=0)
        hi = np.percentile(flat, 100.0 - pct, axis=0)
        eps = np.maximum(np.abs(lo) * 1e-6, 1e-6)
        hi = np.where(hi <= lo, lo + eps, hi)
        return cls(bits=bits, mode=mode, vmin=tuple(lo.tolist()),
                   vmax=tuple(hi.tolist()))

    def describe(self) -> str:
        rng = (f"{self.channels}-channel ranges" if self.per_channel
               else f"[{self.vmin}, {self.vmax}]")
        return f"{self.bits}-bit {self.mode} ADC, {rng}"


def as_spec(spec: Optional[AdcSpec] = None, *, bits: Optional[int] = None,
            vmin: Range = 0.0, vmax: Range = 1.0, mode: str = "tree"
            ) -> AdcSpec:
    """Pass ``spec`` alone, or the loose ``bits/vmin/vmax/mode`` kwargs
    (mutually exclusive)."""
    if spec is not None:
        if (bits is not None or mode != "tree"
                or normalize_range(vmin) != 0.0
                or normalize_range(vmax) != 1.0):
            raise TypeError("pass either spec= or the loose "
                            "bits/vmin/vmax/mode kwargs, not both")
        return spec
    if bits is None:
        raise TypeError("an AdcSpec (or at least bits=) is required")
    return AdcSpec(bits=bits, mode=mode, vmin=normalize_range(vmin),
                   vmax=normalize_range(vmax))


def parse_range(s) -> Range:
    """The CLI form of a range endpoint: a scalar ('0.0') or a
    comma-separated per-channel list ('0.0,-1.0,0.2')."""
    parts = [float(p) for p in str(s).split(",")]
    return parts[0] if len(parts) == 1 else tuple(parts)
