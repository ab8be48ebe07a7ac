"""Linear SVM classifier (one-vs-rest, squared hinge), the paper's second
target model family. Counterpart of ``repro/models/svm.py``; same
functional interface as the MLP, population-stacked params included
(W (P, F, C), b (P, C), x (P, M, F), dp (P,)).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.core import qat
from repro_torch.models.mlp import affine_fixed_order, mean_accuracy

Params = Tuple[torch.Tensor, torch.Tensor]      # (W: (F, C), b: (C,))


def init_svm(generator: torch.Generator, features: int,
             classes: int) -> Params:
    w = torch.randn((features, classes), generator=generator,
                    dtype=torch.float32) * 0.1
    return (w, torch.zeros((classes,), dtype=torch.float32))


def apply_svm(params: Params, x: torch.Tensor, dp=None,
              weight_bits: int = 8) -> torch.Tensor:
    w, b = params
    if dp is not None:
        w = qat.quantize_po2(w, dp, weight_bits)
        b = qat.quantize_fixed(b, dp, weight_bits)
    return torch.matmul(x, w) + b.unsqueeze(-2)


def apply_svm_fixed_order(params: Params, x: torch.Tensor, dp=None,
                          weight_bits: int = 8) -> torch.Tensor:
    """``apply_svm`` through ``mlp.affine_fixed_order`` (the batch-shape
    independent product the accuracies use)."""
    w, b = params
    if dp is not None:
        w = qat.quantize_po2(w, dp, weight_bits)
        b = qat.quantize_fixed(b, dp, weight_bits)
    return affine_fixed_order(x, w, b)


def svm_loss(params: Params, x, y, dp=None, margin: float = 1.0,
             l2: float = 1e-3, weight_bits: int = 8) -> torch.Tensor:
    """Multiclass squared hinge (one-vs-rest) plus an L2 penalty on the
    raw weights: a scalar, or (P,) per lane for stacked params."""
    scores = apply_svm(params, x, dp, weight_bits)
    c = scores.shape[-1]
    tgt = torch.nn.functional.one_hot(y.long(), c).float() * 2.0 - 1.0
    hinge = torch.clamp(margin - tgt * scores, min=0.0)
    return ((hinge ** 2).mean(dim=(-2, -1))
            + l2 * (params[0] ** 2).sum(dim=(-2, -1)))


def accuracy(params: Params, x, y, dp=None,
             weight_bits: int = 8) -> torch.Tensor:
    return mean_accuracy(torch.argmax(
        apply_svm_fixed_order(params, x, dp, weight_bits), -1) == y)


class PopulationSVM(nn.Module):
    """P linear SVMs trained side by side: W (P, F, C), b (P, C)."""

    def __init__(self, params: Params):
        super().__init__()
        self.w = nn.Parameter(params[0])
        self.b = nn.Parameter(params[1])

    @property
    def params(self) -> Params:
        return (self.w, self.b)

    def leaves(self) -> List[torch.Tensor]:
        return [self.w, self.b]

    def forward(self, x, dp=None, weight_bits: int = 8) -> torch.Tensor:
        return apply_svm(self.params, x, dp, weight_bits)

    def loss(self, x, y, dp, weight_bits: int = 8) -> torch.Tensor:
        return svm_loss(self.params, x, y, dp, weight_bits=weight_bits)

    def accuracy(self, x, y, dp=None, weight_bits: int = 8) -> torch.Tensor:
        return accuracy(self.params, x, y, dp, weight_bits)
