"""Device resolution for every port entry point.

The port's entry points serve on the card: ``device=None`` means ``cuda``.
The CPU is used only when the caller asks for it (``device="cpu"``, as the
tests do); a missing card is an error, never a silent move to the CPU.

Resolving a CUDA device also turns TF32 off for float32 matrix products
and for cuDNN: TF32 keeps about three decimal digits, which would break
the bitwise logit parity the plain versions are held to.
"""
from __future__ import annotations

import argparse
import re
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def tf32_state() -> dict:
    """The two TF32 switches, for run reports."""
    return {"matmul": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn": bool(torch.backends.cudnn.allow_tf32)}


def device_arg(text: str) -> str:
    """The LM launchers' ``--device``: ``cuda`` (the visible cards),
    ``cuda:N`` (that card alone, repeated over a mesh's ranks) or
    ``cpu``."""
    if text in ("cuda", "cpu") or re.fullmatch(r"cuda:\d+", text):
        return text
    raise argparse.ArgumentTypeError(f"unsupported device {text!r}; use "
                                     f"cuda, cuda:N or cpu")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for (explicitly or
    by default) and no card is present; accepts only cuda and cpu."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
