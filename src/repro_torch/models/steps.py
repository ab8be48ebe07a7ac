"""Train and serving steps of the LM. Counterpart of
``repro/models/steps.py``. PyTorch runs eagerly, so a step is the plain
function with the config bound (no jit).

``make_train_step(cfg, mesh, shape, microbatches, total_steps)`` returns
``train_step(state, batch, step) -> (state, metrics)``, the reference's
semantics:

* the batch's leaves lead with the microbatch axis (n_mb, b, ...), as
  ``data/lm.SyntheticLM`` makes them; ``adc_mask`` is a constant shared by
  every microbatch;
* each microbatch's loss (``transformer.loss_fn``) is differentiated by
  autograd, attention through the hand-written backward kernel on the
  card; the gradients are summed over the microbatches in
  ``promote_types(param, bf16)``, then scaled by ``1 / n_mb``;
* AdamW (``optim/adamw``) clips them to ``cfg.grad_clip`` by their global
  norm and steps at the ``warmup_cosine`` learning rate of ``step``;
* metrics: ``loss`` (the microbatches' mean), ``lr`` and ``grad_norm``
  (before clipping), float32 scalar tensors.

The step updates ``state.params`` and the AdamW moments in place and
returns the same ``TrainState``. Autograd's leaves are per-layer views of
the stacked parameters (the leaves of ``layers``, ``layers2`` and
``prelayers``, nested ``moe``/``shared``/``ssm`` subtrees included,
become lists, which
``transformer.layer`` indexes as it indexes the stacks), so a layer's
gradient is written into its slice of the stacked sum and no stack-sized
gradient is made per layer.

The step runs on the device of the state. A mesh of more than one device
is refused: the LM's parameter sharding (``make_production_mesh``,
``reshard_state``) and ``grad_compression="int8"``
(``optim/compression.py``) belong to later slices of ROADMAP A11.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.models import serving, transformer
from repro_torch.optim import adamw, schedule


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState
    # the reference's compression error-feedback field, kept so the state
    # and its checkpoint names match it; always None until compression
    # (optim/compression.py) is ported
    err: Optional[torch.Tensor] = None


def _refuse_compression(cfg: ArchConfig) -> None:
    if cfg.grad_compression != "none":
        raise NotImplementedError(
            f"{cfg.name}: grad_compression={cfg.grad_compression!r} (the "
            f"int8 error-feedback ring, optim/compression.py) is not ported "
            f"to repro_torch yet (ROADMAP A11, a later slice)")


def init_state(cfg: ArchConfig, *, seed: int = 0, device=None,
               mesh=None) -> TrainState:
    """Random parameters (``transformer.init_params``, the port's stream)
    and zero AdamW state in ``cfg.opt_state_dtype``, on ``mesh``'s first
    device when a mesh is given, else on ``device`` (default: the card)."""
    _refuse_compression(cfg)
    dev = mesh.first_device if mesh is not None else resolve_device(device)
    params = transformer.init_params(cfg, seed=seed, device=dev)
    return TrainState(params, adamw.init_tree(params, cfg.opt_state_dtype))


def default_microbatches(cfg: ArchConfig, shape: ShapeConfig, mesh) -> int:
    """A microbatch count that keeps the per-device microbatch small while
    each microbatch still fills the batch-sharding axes (the reference's
    rule; with no mesh, or one device, the largest count up to 8 that
    divides the batch)."""
    def axes(b):
        return None if mesh is None else sharding.batch_axes(mesh, cfg, b)

    baxes = axes(shape.global_batch)
    dp = math.prod(mesh.shape[a] for a in (baxes or ()))
    per_dev = max(shape.global_batch // max(dp, 1), 1)
    mb = min(per_dev, 8)
    while mb > 1 and (shape.global_batch % (mb * dp)
                      or axes(shape.global_batch // mb) != baxes):
        mb -= 1
    return mb


_STACKED = ("layers", "layers2", "prelayers")


def _autograd_leaves(params):
    """(tree, leaves): ``params`` with every top-level tensor and every
    layer of every stacked leaf (``layers``, ``layers2`` and
    ``prelayers``, nested subtrees such as ``moe``, ``shared`` and ``ssm``
    included) as a fresh autograd leaf sharing the parameter's storage;
    the flat leaf list in a fixed order, the trees' insertion order."""
    leaves = []

    def views(node):
        if isinstance(node, dict):
            return {k: views(v) for k, v in node.items()}
        out = [node[i].detach().requires_grad_(True)
               for i in range(node.shape[0])]
        leaves.extend(out)
        return out

    tree = {}
    for key, value in params.items():
        if key in _STACKED:
            tree[key] = views(value)
        else:
            tree[key] = value.detach().requires_grad_(True)
            leaves.append(tree[key])
    return tree, leaves


def _grad_slots(gsum):
    """The gradient sums' destinations in ``_autograd_leaves`` order."""
    slots = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        else:
            slots.extend(node[i] for i in range(node.shape[0]))

    for key, value in gsum.items():
        if key in _STACKED:
            walk(value)
        else:
            slots.append(value)
    return slots


def make_train_step(cfg: ArchConfig, mesh, shape: ShapeConfig,
                    microbatches: Optional[int] = None,
                    total_steps: int = 10_000):
    """The train step of ``cfg`` at ``shape`` (see the module docstring)."""
    transformer.check_supported(cfg)
    _refuse_compression(cfg)
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"LM training on a mesh of {mesh.size} devices is not ported to "
            f"repro_torch yet (ROADMAP A11: make_production_mesh, "
            f"reshard_state); use a one-device mesh")
    n_mb = microbatches or default_microbatches(cfg, shape, mesh)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   step: int):
        params = state.params
        dev = params["final_norm"].device
        lr = schedule.warmup_cosine(step, peak_lr=cfg.learning_rate,
                                    total=total_steps).to(dev)
        const = {k: v for k, v in batch.items() if k == "adc_mask"}
        if batch["labels"].shape[0] != n_mb:
            raise ValueError(f"the batch leads with {batch['labels'].shape[0]}"
                             f" microbatches; the step takes {n_mb}")
        gsum = adamw.tree_map(
            lambda p: torch.zeros_like(
                p, dtype=torch.promote_types(p.dtype, torch.bfloat16)),
            params)
        slots = _grad_slots(gsum)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for j in range(n_mb):
            mb = {k: v[j] for k, v in batch.items() if k != "adc_mask"}
            live, leaves = _autograd_leaves(params)
            with torch.enable_grad():
                loss, _ = transformer.loss_fn(live, {**mb, **const}, cfg)
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for slot, g in zip(slots, grads):
                    slot.add_(g)
            lsum = lsum + loss.detach()
            del live, leaves, grads, loss
        scale = 1.0 / n_mb
        with torch.no_grad():
            for g in adamw.tree_leaves(gsum):
                g.mul_(scale)
        gnorm = adamw.global_norm(gsum)
        adamw.update_(adamw.tree_leaves(params), adamw.tree_leaves(gsum),
                      state.opt, lr=lr, weight_decay=cfg.weight_decay,
                      grad_clip=cfg.grad_clip, grad_norm=gnorm)
        metrics = {"loss": lsum * scale, "lr": lr, "grad_norm": gnorm}
        return state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch):
        return serving.prefill(params, batch, cfg)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def decode_step(params, batch, cache):
        return serving.decode_step(params, batch, cache, cfg)
    return decode_step
