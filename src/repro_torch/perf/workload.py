"""Workload: the shape vocabulary shared by the dispatch layer and the
performance layer. Counterpart of ``repro/perf/workload.py``, copied.

A ``Workload`` names everything the cost model and the autotuner need to
reason about one kernel launch: which entry, and the (P, D, S, C, M,
bits, H, O) extents of its operands. The entry names are the ten
non-attention kernel entries of the port (rows 1-10 of PERF.md's kernel
table), under the reference's names: ``adc_quantize``,
``adc_quantize_population``, ``mc_eval{,_population}``,
``mc_eval_cal{,_population}``, ``bespoke_{mlp,svm}`` and
``classifier_bank_{mlp,svm}``. The dispatch layer builds one per CUDA
call, the cost model prices it, and the autotuner buckets it into a
**shape class**, the key a tuned tile is stored under. Batch-like axes
(M, P, S, D) bucket to the next power of two so neighbouring launch sizes
share one tuned choice; structural extents (C, bits, H, O) stay exact
because they change the kernel's resident footprint. The shape-class
strings are the reference's, byte for byte.

This module is import-light on purpose: kernels/dispatch.py pulls it in
at import, so it imports nothing of torch or of the rest of the perf
layer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

ENTRIES = ("adc_quantize", "adc_quantize_population", "mc_eval",
           "mc_eval_population", "mc_eval_cal", "mc_eval_cal_population",
           "bespoke_mlp", "bespoke_svm", "classifier_bank_mlp",
           "classifier_bank_svm")


@dataclasses.dataclass(frozen=True)
class Workload:
    """One kernel launch, shape-wise. Leading axes default to 1 so every
    entry family shares the same record: population entries set ``p``,
    bank entries ``d``, Monte-Carlo entries ``s``; classifier entries
    carry their hidden/output extents in ``h``/``o`` (0 where absent)."""
    entry: str
    m: int                  # samples in the shared batch
    c: int                  # channels / features
    bits: int               # ADC resolution (2^bits table columns)
    p: int = 1              # population size
    d: int = 1              # deployed bank designs
    s: int = 1              # Monte-Carlo instances
    h: int = 0              # hidden units (MLP entries)
    o: int = 0              # output classes (classifier entries)

    def __post_init__(self):
        for name in ("m", "c", "bits", "p", "d", "s"):
            if getattr(self, name) < 1:
                raise ValueError(f"Workload.{name} must be >= 1, got "
                                 f"{getattr(self, name)}")

    @property
    def levels(self) -> int:
        return 2 ** self.bits

    def replace(self, **kw) -> "Workload":
        return dataclasses.replace(self, **kw)

    def to_meta(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_meta(cls, meta: Dict) -> "Workload":
        return cls(**{k: (v if k == "entry" else int(v))
                      for k, v in meta.items()})


def _pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (the shape-class bucket for batch-like
    axes)."""
    b = 1
    while b < n:
        b <<= 1
    return b


def shape_class(w: Workload) -> str:
    """The stable string key a tuned table stores one tile choice under.
    Deterministic, order-fixed, JSON-safe."""
    return (f"m{_pow2_bucket(w.m)}-c{w.c}-b{w.bits}-p{_pow2_bucket(w.p)}"
            f"-d{_pow2_bucket(w.d)}-s{_pow2_bucket(w.s)}-h{w.h}-o{w.o}")


def workload_of(entry: str, x_shape: Tuple[int, ...],
                table_shape: Tuple[int, ...],
                weight_shapes: Tuple[Tuple[int, ...], ...],
                bits: int) -> Workload:
    """Read a ``Workload`` off the operand shapes of one entry's call.

    ``table_shape`` is the first post-x operand (the baked value table
    for the ideal entries, the lb interval table for the Monte-Carlo
    entries), whose leading axes carry P/S/D; ``weight_shapes`` are the
    rest, in entry order (kernels/dispatch.py)."""
    m, c = int(x_shape[0]), int(x_shape[1])
    w = dict(m=m, c=c, bits=bits)
    if entry == "adc_quantize":
        pass
    elif entry == "adc_quantize_population":
        w["p"] = int(table_shape[0])
    elif entry == "mc_eval":
        w["s"] = int(table_shape[0])
    elif entry == "mc_eval_population":
        w["p"], w["s"] = int(table_shape[0]), int(table_shape[1])
    elif entry == "mc_eval_cal":
        w["s"] = int(table_shape[0])
    elif entry == "mc_eval_cal_population":
        w["p"], w["s"] = int(table_shape[0]), int(table_shape[1])
    elif entry == "bespoke_mlp":
        w["h"], w["o"] = int(weight_shapes[0][1]), int(weight_shapes[2][1])
    elif entry == "bespoke_svm":
        w["o"] = int(weight_shapes[0][1])
    elif entry == "classifier_bank_mlp":
        w["d"] = int(table_shape[0])
        w["h"], w["o"] = int(weight_shapes[0][2]), int(weight_shapes[2][2])
    elif entry == "classifier_bank_svm":
        w["d"] = int(table_shape[0])
        w["o"] = int(weight_shapes[0][2])
    else:
        raise ValueError(f"no workload rule for kernel entry {entry!r}")
    return Workload(entry=entry, **w)
