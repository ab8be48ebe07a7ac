"""Host arrays as tensors, bitwise, for the parameters and the states
the port reads from the JAX package or from a checkpoint file."""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a) -> torch.Tensor:
    """A host array as a CPU tensor, bitwise: bfloat16 (ml_dtypes', as
    jax hands it, or its raw 2-byte patterns, dtype V2, as a file holds
    it) as ``torch.bfloat16``; a read-only or strided array is copied."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = a.copy()
    return torch.from_numpy(a)
