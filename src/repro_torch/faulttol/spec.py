"""Frozen description of the fault-tolerance design space. Counterpart of
``repro/faulttol/spec.py``, with the same JSON.

Comparators can be triplicated behind a majority voter, pruned levels can
be re-enabled as spares, and a fabricated instance can be calibrated
against its measured non-idealities. ``FaultTolSpec`` freezes which of
those actions the search genome may take; ``to_meta``/``from_meta`` let
deployment artifacts record the genome layout they were searched under.

Genome extension (appended after the DP_BITS exponent genes):

* ``tmr``        -> 1 bit per channel: triplicate this channel's surviving
                    comparators behind majority voters (``area.tmr_tc``).
* ``max_spares`` -> ``spare_bits`` per channel (LSB-first): turn
                    ``min(value, max_spares)`` additional pruned levels
                    back on (``adc.add_levels``).
* ``calibrate``  -> 1 global bit: post-fabrication calibration re-bakes
                    the value table per measured instance
                    (``calibrate.calibrated_value_rows``;
                    ``area.calibration_tc``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FaultTolSpec:
    """Which redundancy/repair actions the search genome may take.

    tmr: allow per-channel comparator triplication + majority vote.
    max_spares: per-channel spare-level gene range 0..max_spares
        (0 disables the action).
    calibrate: allow the global post-fabrication-calibration gene.
    """
    tmr: bool = True
    max_spares: int = 2
    calibrate: bool = True

    def __post_init__(self):
        object.__setattr__(self, "tmr", bool(self.tmr))
        object.__setattr__(self, "max_spares", int(self.max_spares))
        object.__setattr__(self, "calibrate", bool(self.calibrate))
        if self.max_spares < 0:
            raise ValueError(f"max_spares must be >= 0, "
                             f"got {self.max_spares}")
        if not (self.tmr or self.max_spares or self.calibrate):
            raise ValueError("FaultTolSpec with every action disabled "
                             "adds no genes; omit faulttol instead")

    @property
    def spare_bits(self) -> int:
        """Bits per channel encoding the spare-level count."""
        return int(self.max_spares).bit_length() if self.max_spares else 0

    def gene_bits(self, channels: int) -> int:
        """Total genome bits this spec appends for ``channels`` channels."""
        return (channels * int(self.tmr)
                + channels * self.spare_bits
                + int(self.calibrate))

    def replace(self, **kw) -> "FaultTolSpec":
        return dataclasses.replace(self, **kw)

    def to_meta(self) -> dict:
        return {"tmr": self.tmr, "max_spares": self.max_spares,
                "calibrate": self.calibrate}

    @classmethod
    def from_meta(cls, meta: dict) -> "FaultTolSpec":
        return cls(tmr=bool(meta["tmr"]),
                   max_spares=int(meta["max_spares"]),
                   calibrate=bool(meta["calibrate"]))

    def describe(self) -> str:
        acts = []
        if self.tmr:
            acts.append("tmr")
        if self.max_spares:
            acts.append(f"spares<={self.max_spares}")
        if self.calibrate:
            acts.append("calibrate")
        return "+".join(acts)
