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
    route: str = ""                 # which kernel, where an entry has two

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _route(entry: str, x: torch.Tensor, why) -> Resolution:
    """The three rules, with ``why()`` naming the envelope limit a CUDA
    call breaks (None inside the envelope)."""
    dev = str(x.device)
    if x.device.type == "cpu":
        return Resolution(entry, "plain", dev, "CPU tensor: plain version")
    if x.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {x.device}")
    reason = why()
    if reason is not None:
        raise ValueError(f"{entry}: outside the Hopper kernel envelope: "
                         f"{reason}")
    return Resolution(entry, "kernel", dev,
                      "CUDA tensor inside the Hopper envelope")


def resolve(entry: str, kind: str, x: torch.Tensor, tables: torch.Tensor,
            weights) -> Resolution:
    """Decide how a bank entry runs on (x, tables, *weights): shapes are
    read from the bank operands (tables (D, F, 2^N); MLP weights
    (D, F, H)...(D, O), SVM weights (D, F, O), (D, O))."""
    def why():
        d, f, n = tables.shape
        h = weights[0].shape[2] if kind == "mlp" else 0
        o = weights[-1].shape[-1]
        return envelope.outside_envelope(kind, f, n, h, o, d)

    return _route(entry, x, why)


def resolve_quantize(entry: str, x: torch.Tensor,
                     tables: torch.Tensor) -> Resolution:
    """Decide how the population quantizer runs on x (M, C) and tables
    (P, C, 2^N)."""
    def why():
        p, c, n = tables.shape
        return envelope.outside_quantize_envelope(c, n, p)

    return _route(entry, x, why)


def resolve_mc(entry: str, x: torch.Tensor, lb: torch.Tensor) -> Resolution:
    """Decide how a Monte-Carlo entry runs on x (M, C) and interval
    tables lb (..., S, C, 2^N)."""
    def why():
        c, n = lb.shape[-2], lb.shape[-1]
        return envelope.outside_mc_envelope(c, n)

    return _route(entry, x, why)


def resolve_flash(entry: str, q: torch.Tensor) -> Resolution:
    """Decide how flash attention runs on q (B, S, H, dh). A CUDA call
    takes one of two kernels (``route``), by ``envelope.flash_route``:
    'tensor_core' (csrc/flash_attention_tc.cu) for bf16 at a head width
    of the repo's attention configs, 'cuda_core' (csrc/flash_attention.cu)
    for float32 and for bf16 at any other width; each is held to its own
    envelope. A CPU tensor takes the plain version (route 'plain')."""
    b, _, h, dh = q.shape
    route = envelope.flash_route(q.dtype == torch.bfloat16, dh)

    def why():
        if route == "tensor_core":
            return envelope.outside_flash_tc_envelope(b, h, dh)
        return envelope.outside_flash_envelope(b, h, dh)

    res = _route(entry, q, why)
    return dataclasses.replace(
        res, route=route if res.path == "kernel" else "plain")
