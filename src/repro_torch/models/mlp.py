"""Printed-MLP classifier (the paper's target workload). Counterpart of
``repro/models/mlp.py``.

Functional, in the reference's layout: ``init_mlp(generator, sizes)`` ->
params list of (W (fan_in, fan_out), b (fan_out,)); ``apply_mlp(params,
x, dp=None)`` with optional power-of-2 weight fake-quant (QAT) at the
genome's decimal position ``dp``. Every function also takes
population-stacked params (W (P, fan_in, fan_out), b (P, fan_out)) with
x (P, M, F) and dp (P,): lane p is then the unstacked function of lane
p's operands. ``PopulationMLP`` holds such stacks as an ``nn.Module``.

``accuracy`` scores through ``apply_mlp_fixed_order``: every logit is the
same sequence of float32 multiplies and adds over the input features in
index order, whatever the batch shape, on the CPU and on the card. A
batched product's summation order may depend on its shape (the lane
count, the Monte-Carlo instance count), so an accuracy measured on P
lanes of M samples and one measured on P x S perturbed views of them
agree bit for bit only with a fixed order: the search's ideal column,
its robustness column and the deployed robustness report all score
through this one forward.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.core import qat

Params = List[Tuple[torch.Tensor, torch.Tensor]]


def init_mlp(generator: torch.Generator, sizes: Sequence[int]) -> Params:
    """He-scaled normal weights, zero-mean columns, biases 0.1, drawn from
    ``generator`` layer by layer (the reference's recipe; a torch
    Generator's stream, not jax.random's)."""
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        dtype=torch.float32)
        w = w * torch.sqrt(torch.tensor(2.0 / fan_in, dtype=torch.float32))
        # inputs live in [0,1]: zero-mean each column and bias slightly
        # positive so tiny printed-MLP hidden units start alive
        w = w - w.mean(dim=0, keepdim=True)
        b = torch.full((fan_out,), 0.1, dtype=torch.float32)
        params.append((w, b))
    return params


def apply_mlp(params: Params, x: torch.Tensor, dp=None,
              weight_bits: int = 8) -> torch.Tensor:
    h = x
    n = len(params)
    for i, (w, b) in enumerate(params):
        if dp is not None:
            w = qat.quantize_po2(w, dp, weight_bits)
            b = qat.quantize_fixed(b, dp, weight_bits)
        h = torch.matmul(h, w) + b.unsqueeze(-2)
        if i < n - 1:
            h = torch.relu(h)
    return h


def affine_fixed_order(x: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` as explicit elementwise steps: ``sum_f x[.., f] *
    w[.., f, :]`` accumulated in f order, then the bias. w (*L, F, H) and
    b (*L, H) carry the lane axes *L; x (*L, *B, M, F) may add batch axes
    *B after them (Monte-Carlo instances), which the weights broadcast
    over. Each output element's arithmetic is independent of every
    shape, so the result is the same on any batch and device."""
    lead = w.ndim - 2
    mid = x.ndim - 2 - lead
    w = w.reshape(w.shape[:lead] + (1,) * mid + w.shape[lead:])
    b = b.reshape(b.shape[:lead] + (1,) * (mid + 1) + b.shape[-1:])
    acc = x[..., 0:1] * w[..., 0:1, :]
    for f in range(1, x.shape[-1]):
        acc = acc + x[..., f:f + 1] * w[..., f:f + 1, :]
    return acc + b


def apply_mlp_fixed_order(params: Params, x: torch.Tensor, dp=None,
                          weight_bits: int = 8) -> torch.Tensor:
    """``apply_mlp`` with every product in ``affine_fixed_order``."""
    h = x
    n = len(params)
    for i, (w, b) in enumerate(params):
        if dp is not None:
            w = qat.quantize_po2(w, dp, weight_bits)
            b = qat.quantize_fixed(b, dp, weight_bits)
        h = affine_fixed_order(h, w, b)
        if i < n - 1:
            h = torch.relu(h)
    return h


def mean_accuracy(correct: torch.Tensor) -> torch.Tensor:
    """(..., M) correctness bools -> (...,) float32 accuracies, as the
    reference's ``jnp.mean`` computes them: the float32 count times the
    float32 reciprocal of M. A true division ``count / M`` differs in the
    last ulp for some counts."""
    m = correct.shape[-1]
    return correct.float().sum(-1) * torch.reciprocal(
        torch.tensor(m, dtype=torch.float32, device=correct.device))


def accuracy(params: Params, x, y, dp=None,
             weight_bits: int = 8) -> torch.Tensor:
    """Test accuracy over the last sample axis of x (..., M, F): (P,)
    for stacked params, (P, S) for x (P, S, M, F)."""
    logits = apply_mlp_fixed_order(params, x, dp, weight_bits)
    return mean_accuracy(torch.argmax(logits, -1) == y)


def cross_entropy(params: Params, x, onehot: torch.Tensor, dp=None,
                  weight_bits: int = 8) -> torch.Tensor:
    """Mean cross-entropy of the QAT forward against one-hot targets
    (M, O): a scalar, or (P,) per lane for stacked params."""
    logp = torch.log_softmax(apply_mlp(params, x, dp, weight_bits), dim=-1)
    return -(onehot * logp).sum(-1).mean(-1)


class PopulationMLP(nn.Module):
    """P printed MLPs trained side by side: layer l holds W (P, fan_in,
    fan_out) and b (P, fan_out)."""

    def __init__(self, params: Params):
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(w) for w, _ in params])
        self.b = nn.ParameterList([nn.Parameter(b) for _, b in params])

    @property
    def params(self) -> Params:
        return list(zip(self.w, self.b))

    def leaves(self) -> List[torch.Tensor]:
        """Parameters in the reference's tree order (W1, b1, W2, b2)."""
        return [t for layer in self.params for t in layer]

    def forward(self, x, dp=None, weight_bits: int = 8) -> torch.Tensor:
        return apply_mlp(self.params, x, dp, weight_bits)

    def loss(self, x, onehot, dp, weight_bits: int = 8) -> torch.Tensor:
        return cross_entropy(self.params, x, onehot, dp, weight_bits)

    def accuracy(self, x, y, dp=None, weight_bits: int = 8) -> torch.Tensor:
        return accuracy(self.params, x, y, dp, weight_bits)
