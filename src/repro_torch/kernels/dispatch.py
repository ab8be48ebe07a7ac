"""The kernel-or-plain decision for every ported entry. Counterpart of
``repro/kernels/dispatch.py::resolve``, with the port's rules:

1. a tensor on the CPU -> the plain PyTorch version (kernels/ref.py);
2. a CUDA tensor inside the Hopper envelope -> the hand-written kernel;
3. a CUDA tensor outside the envelope -> ``ValueError`` naming the limit.

There is no third route: a CUDA tensor never falls back to the plain
version or to the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.kernels import envelope


@dataclasses.dataclass(frozen=True)
class Resolution:
    """The routing decision for one call, JSON-able."""
    entry: str
    path: str                       # 'kernel' | 'plain'
    device: str
    reason: str

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def resolve(entry: str, kind: str, x: torch.Tensor, tables: torch.Tensor,
            weights) -> Resolution:
    """Decide how ``entry`` runs on (x, tables, *weights): shapes are read
    from the bank operands (tables (D, F, 2^N); MLP weights
    (D, F, H)...(D, O), SVM weights (D, F, O), (D, O))."""
    dev = str(x.device)
    if x.device.type == "cpu":
        return Resolution(entry, "plain", dev, "CPU tensor: plain version")
    if x.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {x.device}")
    d, f, n = tables.shape
    h = weights[0].shape[2] if kind == "mlp" else 0
    o = weights[-1].shape[-1]
    why = envelope.outside_envelope(kind, f, n, h, o, d)
    if why is not None:
        raise ValueError(f"{entry}: outside the Hopper kernel envelope: "
                         f"{why}")
    return Resolution(entry, "kernel", dev,
                      "CUDA tensor inside the Hopper envelope")
