"""Train and serving steps of the LM. Counterpart of
``repro/models/steps.py``. PyTorch runs eagerly, so a step is the plain
function with the config bound (no jit).

``make_train_step(cfg, mesh, shape, microbatches, total_steps)`` returns
``train_step(state, batch, step) -> (state, metrics)``, the reference's
semantics:

* the batch's leaves lead with the microbatch axis (n_mb, b, ...), as
  ``data/lm.SyntheticLM`` makes them; ``adc_mask`` is a constant shared by
  every microbatch and every rank;
* each microbatch's loss (``transformer.loss_fn``) is differentiated by
  autograd, attention through the hand-written backward kernel on the
  card; the gradients are summed over the microbatches in
  ``promote_types(param, bf16)``, then scaled by ``1 / n_mb``;
* AdamW (``optim/adamw``) clips them to ``cfg.grad_clip`` by their global
  norm and steps at the ``warmup_cosine`` learning rate of ``step``;
* metrics: ``loss`` (the microbatches' mean), ``lr`` and ``grad_norm``
  (before clipping), float32 scalar tensors.

Data parallelism over a single-process mesh (``launch/mesh.py``; a
device may repeat, so ``[cuda:0, cuda:0]`` is two ranks on one card):

* ``grad_compression="int8"``: the ranks are the dp axes ('pod', 'data'),
  pod-major (``sharding.shard_plan``), and the step is the reference's
  ``shard_map`` body. Rank r takes the r-th contiguous block of every
  microbatch's batch rows on its device, the reference's ``P(None,
  dp)``, and runs the one-device microbatch loop on it; its gradients
  go through ``compression.sync_grads`` with its error row
  (``TrainState.err``, one bf16 row per rank on its device), and the
  loss is the ranks' mean. The moe family routes per rank, as there.
  The parameters and the AdamW state live on the mesh's first device;
  every other distinct device of the ranks gets a copy of the
  parameters at the start of each step, so AdamW runs once, on rank 0's
  synced gradients, and no replica can drift. The synced gradients are
  equal on every rank, but with two pods only inside each pod
  (``optim/compression.py``); the reference's ``shard_map`` declares
  them replicated, so its pods' copies would drift apart (ROADMAP C).
* uncompressed: the reference's step is one global (GSPMD) step over
  the whole microbatch, which is what the one-device loop computes, so
  the step runs that loop on the mesh's first device (its first 'data'
  slice's 'model' ranks under tensor parallelism). The port issues a
  rank's work from one host thread, so splitting it over the ranks
  would only serialise them (ROADMAP: concurrent per-device shard
  dispatch). One exception: the reference's moe FFN runs in a
  ``shard_map`` whose tokens enter ``P(('pod', 'data'))``, so its dp
  shards route apart; the step passes their number to ``loss_fn``
  (``moe.moe_ffn``'s ``dp``) and raises where a microbatch's rows do
  not divide it, as the ``shard_map`` does.

Tensor parallelism over 'model' (``distributed/tensor_parallel.py``):
where the parameter rules split weights over 'model' (the dense,
local_global, vlm and moe families), ``init_state`` places the
parameters and the AdamW moments as ``tp_plan(cfg, mesh)`` gives them,
each rank's slices on its device. Uncompressed, the step runs that group
on the whole microbatch. Under int8 (``RULES_TP_ONLY``) each dp rank runs
its own group (the state's slices copied to its group's devices at the
start of the step, as the replicas above); its gradients are gathered
whole on its first device and go through the ring unchanged; the synced
gradients are split again for AdamW, which steps each slice elementwise.

Refused, naming ROADMAP A11.9 (``tensor_parallel.check_mesh``,
``tp_plan``): the ssm family's 'model' split, a mesh mixing device
types and the abstract production mesh
(``launch/mesh.make_production_mesh``, meta entries).
``input_specs`` gives a cell's inputs on such a mesh as
``sharding.Sharded`` meta stand-ins, as the reference's does, for the
dry run (``launch/dryrun.py``).

The step updates ``state.params``, the AdamW moments and the error rows
in place and returns the state. Autograd's leaves are per-layer views of
the stacked parameters (the leaves of ``layers``, ``layers2`` and
``prelayers``, nested ``moe``/``shared``/``ssm`` subtrees included,
become lists, which ``transformer.layer`` indexes as it indexes the
stacks), so a layer's gradient is written into its slice of the stacked
sum and no stack-sized gradient is made per layer (a split leaf's
layer is ``Shards`` of its ranks' layer views).
``make_grad_step`` is the step before AdamW: the synced gradients, the
loss and the new error rows, the state untouched.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import serving, transformer
from repro_torch.optim import adamw, compression, schedule


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState
    # the int8 ring's error-feedback rows (the reference's (dp, n) bf16
    # buffer, one row per dp rank on its device); None uncompressed
    err: Optional[List[torch.Tensor]] = None


def dp_devices(mesh) -> list:
    """The devices of the dp ranks, pod-major (one: the mesh's first)."""
    axes = sharding.dp_axes(mesh)
    n = math.prod(mesh.shape[a] for a in axes)
    return [dev for dev, _ in sharding.shard_plan(mesh, axes, n)]


def init_state(cfg: ArchConfig, *, seed: int = 0, device=None,
               mesh=None) -> TrainState:
    """Random parameters (``transformer.init_params``, the port's stream)
    and zero AdamW state in ``cfg.opt_state_dtype``, on ``mesh``'s first
    device when a mesh is given, else on ``device`` (default: the card),
    split as ``tensor_parallel.tp_plan(cfg, mesh)`` places them; under
    ``grad_compression="int8"`` a zero error row per dp rank of the mesh
    (one without a mesh), on the rank's first device."""
    dev = mesh.first_device if mesh is not None else resolve_device(device)
    plan = TP.tp_plan(cfg, mesh)
    # each leaf placed as it is drawn: no card holds the whole tree
    params = transformer.init_params(cfg, seed=seed, device=dev, **(
        {} if plan is None else {"plan": plan}))
    err = None
    if cfg.grad_compression == "int8":
        devs = [dev] if mesh is None else dp_devices(mesh)
        err = compression.init_error_buffer(params, len(devs), devs)
    return TrainState(params, adamw.init_tree(params, cfg.opt_state_dtype),
                      err)


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

    def leaf(t):
        if isinstance(t, TP.Shards):
            out = t.like([p.detach().requires_grad_(True) for p in t])
            leaves.extend(out)
            return out
        out = t.detach().requires_grad_(True)
        leaves.append(out)
        return out

    def views(node):
        if isinstance(node, dict):
            return {k: views(v) for k, v in node.items()}
        if isinstance(node, TP.Shards):
            return [leaf(node.at(i)) for i in range(node[0].shape[0])]
        return [leaf(node[i]) for i in range(node.shape[0])]

    tree = {key: (views(value) if key in _STACKED else leaf(value))
            for key, value in params.items()}
    return tree, leaves


def _grad_slots(gsum):
    """The gradient sums' destinations in ``_autograd_leaves`` order."""
    slots = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, TP.Shards):
            for i in range(node[0].shape[0]):
                slots.extend(node.at(i))
        else:
            slots.extend(node[i] for i in range(node.shape[0]))

    for key, value in gsum.items():
        if key in _STACKED:
            walk(value)
        elif isinstance(value, TP.Shards):
            slots.extend(value)
        else:
            slots.append(value)
    return slots


def _rank_plan(cfg: ArchConfig, mesh, b: int) -> list:
    """``[(devices, rows), ...]``: each rank's 'model' group's devices
    (None: the state's device) and its block of a microbatch's ``b`` rows
    (see the module docstring); raises for what the step refuses."""
    if mesh is None or mesh.size == 1:
        return [(None, slice(0, b))]
    TP.check_mesh(cfg, mesh)
    TP.tp_plan(cfg, mesh)                  # raises for the ssm split
    groups = TP.tp_groups(mesh)
    if cfg.grad_compression != "int8":
        n = len(groups)
        if cfg.family == "moe" and b % n:
            raise ValueError(f"a microbatch of {b} rows does not split over "
                             f"the {n} dp shards of {mesh.shape} that the "
                             f"moe layers route apart")
        return [(groups[0], slice(0, b))]
    axes = sharding.dp_axes(mesh)
    n = math.prod(mesh.shape[a] for a in axes)
    if b % n:
        raise ValueError(f"a microbatch of {b} rows does not split over "
                         f"the {n} dp ranks of {mesh.shape}")
    return [(g, rows) for g, (_, rows) in zip(
        groups, sharding.shard_plan(mesh, axes, b))]


def _on_group(params, devices):
    """A copy of ``params`` on another 'model' group: each split leaf's
    slice j on ``devices[j]``, the replicated leaves on ``devices[0]``."""
    def move(leaf):
        if isinstance(leaf, TP.Shards):
            return leaf.like([p.to(d) for p, d in zip(leaf, devices)])
        return leaf.to(devices[0])

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return move(node)

    return walk(params)


def _local_grads(params, batch, const, cfg: ArchConfig, n_mb: int,
                 dp: int = 1):
    """One rank's microbatch loop: (the gradient sums over its n_mb
    microbatches scaled by 1 / n_mb, in ``promote_types(param, bf16)``;
    the microbatches' mean loss), on ``params``' devices. ``dp``: the dp
    shards a moe layer routes apart (``transformer.loss_fn``)."""
    dev = params["final_norm"].device
    gsum = adamw.tree_map(
        lambda p: torch.zeros_like(
            p, dtype=torch.promote_types(p.dtype, torch.bfloat16)),
        params)
    slots = _grad_slots(gsum)
    lsum = torch.zeros((), dtype=torch.float32, device=dev)
    for j in range(n_mb):
        mb = {k: v[j] for k, v in batch.items()}
        live, leaves = _autograd_leaves(params)
        with torch.enable_grad():
            loss, _ = transformer.loss_fn(live, {**mb, **const}, cfg, dp=dp)
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
    return gsum, lsum * scale


def make_grad_step(cfg: ArchConfig, mesh, shape: ShapeConfig,
                   microbatches: Optional[int] = None):
    """``grad_step(state, batch) -> (grads, loss, new_err)``: the train
    step before AdamW (see the module docstring). ``grads`` on the
    state's device; ``new_err`` the new error rows (None uncompressed);
    the state is not modified."""
    transformer.check_supported(cfg)
    n_mb = microbatches or default_microbatches(cfg, shape, mesh)
    plan = _rank_plan(cfg, mesh, shape.global_batch // n_mb)
    n = len(plan)
    int8 = cfg.grad_compression == "int8"
    dp = () if mesh is None else sharding.dp_axes(mesh)
    dp_sizes = tuple(mesh.shape[a] for a in dp)
    ndata = dict(zip(dp, dp_sizes)).get("data", 1)
    tp = TP.tp_plan(cfg, mesh)
    # the dp shards the moe layers route apart (uncompressed)
    n_shards = 1 if mesh is None else len(TP.tp_groups(mesh))

    def rank_batch(batch, rows, rdev):
        """(the rank's rows of every microbatch, the shared constants),
        on ``rdev``."""
        return ({k: v[:, rows].to(rdev) for k, v in batch.items()
                 if k != "adc_mask"},
                {k: v.to(rdev) for k, v in batch.items() if k == "adc_mask"})

    def grad_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        dev = params["final_norm"].device
        if batch["labels"].shape[0] != n_mb:
            raise ValueError(f"the batch leads with {batch['labels'].shape[0]}"
                             f" microbatches; the step takes {n_mb}")
        if plan[0][0] is not None and plan[0][0][0] != dev:
            raise ValueError(f"the state lives on {dev}, not on the mesh's "
                             f"first device {plan[0][0][0]}")
        TP.check_placed(params, tp)
        if not int8:                    # one rank (see _rank_plan)
            gsum, loss = _local_grads(params, *rank_batch(
                batch, plan[0][1], dev), cfg, n_mb, dp=n_shards)
            return gsum, loss, None
        if state.err is None or len(state.err) != n:
            raise ValueError(f"grad_compression='int8' over {n} dp ranks "
                             f"needs {n} error rows, the state has "
                             f"{None if state.err is None else len(state.err)}")
        first = (dev,) if plan[0][0] is None else tuple(plan[0][0])
        replicas = {first: params}
        for group, _ in plan:
            if group is not None and tuple(group) not in replicas:
                replicas[tuple(group)] = _on_group(params, group)
        total = sum(p.numel() for p in adamw.tree_leaves(params))
        length = ndata * -(-total // ndata)
        losses, flats, new_err = [], [], []
        for r, (group, rows) in enumerate(plan):
            group = first if group is None else tuple(group)
            rdev = group[0]
            gsum, loss = _local_grads(replicas[group], *rank_batch(
                batch, rows, rdev), cfg, n_mb)
            losses.append(loss.to(dev))
            # quantized as each rank finishes, so only one rank's
            # gradient sums are alive at a time; split sums gathered
            # whole on the rank's first device
            with torch.no_grad():
                flat, row = compression.local_quantize(
                    TP.gather_params(gsum, rdev), state.err[r],
                    length=length)
            flats.append(flat)
            new_err.append(row)
            del gsum
        with torch.no_grad():
            # padded to the ring's length, so the ring's results overwrite
            # the flat vectors (no second full-size buffer a rank)
            synced = compression.compressed_mean(flats, dp, dp_sizes)
        del flats
        like = adamw.tree_map(lambda p: torch.empty(
            p.shape, dtype=torch.promote_types(p.dtype, torch.bfloat16),
            device="meta"), TP.gather_params(_meta(params)))
        grads = TP.shard_params(compression.unflatten(synced[0], like),
                                TP.plan_of(params, cfg))
        return grads, sum(losses) / n, new_err

    return grad_step


def _meta(params):
    """``params`` as meta tensors (split leaves' slices too)."""
    return adamw.tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                                device="meta"), params)


def apply_grads(cfg: ArchConfig, state: TrainState, grads, lr
                ) -> torch.Tensor:
    """The step after the gradients: their global norm (returned), then
    AdamW in place on ``state``'s parameters and moments, clipped to
    ``cfg.grad_clip`` by that norm, at learning rate ``lr``."""
    gnorm = adamw.global_norm(grads)
    adamw.update_(adamw.tree_leaves(state.params), adamw.tree_leaves(grads),
                  state.opt, lr=lr, weight_decay=cfg.weight_decay,
                  grad_clip=cfg.grad_clip, grad_norm=gnorm)
    return gnorm


def make_train_step(cfg: ArchConfig, mesh, shape: ShapeConfig,
                    microbatches: Optional[int] = None,
                    total_steps: int = 10_000):
    """The train step of ``cfg`` at ``shape`` (see the module docstring)."""
    grad_step = make_grad_step(cfg, mesh, shape, microbatches)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   step: int):
        dev = state.params["final_norm"].device
        lr = schedule.warmup_cosine(step, peak_lr=cfg.learning_rate,
                                    total=total_steps).to(dev)
        grads, loss, new_err = grad_step(state, batch)
        gnorm = apply_grads(cfg, state, grads, lr)
        if new_err is not None:
            with torch.no_grad():
                for row, new in zip(state.err, new_err):
                    row.copy_(new)
        return state, {"loss": loss, "lr": lr, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ArchConfig, mesh=None):
    """``prefill_step(params, batch)``: ``serving.prefill`` over ``mesh``
    (the mesh the parameters are placed on, or None)."""
    serving.serving_plan(cfg, mesh)          # refuse before any work

    def prefill_step(params, batch):
        return serving.prefill(params, batch, cfg, mesh=mesh)
    return prefill_step


def make_decode_step(cfg: ArchConfig, mesh=None):
    """``decode_step(params, batch, cache)``: ``serving.decode_step`` over
    ``mesh``."""
    serving.serving_plan(cfg, mesh)

    def decode_step(params, batch, cache):
        return serving.decode_step(params, batch, cache, cfg, mesh=mesh)
    return decode_step


# ------------------------------------------------------------- input specs
def input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                microbatches: Optional[int] = None) -> Dict[str, Any]:
    """Meta stand-ins (``sharding.Sharded``: tensor and spec) for every
    model input of the (arch x shape) cell on ``mesh``, the reference's:
    kind 'train' gives ``{"batch", "n_microbatches"}``, the batch's
    leaves leading with the microbatch axis; 'prefill' ``{"batch"}``;
    'decode' ``{"batch", "cache"}``, one new token against a cache of
    ``shape.seq_len`` (``serving.init_cache`` on meta, which does not
    depend on ``pad_heads_to``, so a padded published config gets its
    cache too)."""
    dt = transformer.torch_dtype(cfg.dtype)

    def sds(shp, dtype, spec):
        return sharding.Sharded(torch.empty(shp, dtype=dtype, device="meta"),
                                tuple(spec))

    def batch_struct(b: int, s: int, lead: tuple = ()):
        baxes = sharding.batch_axes(mesh, cfg, b)

        def mk(shp, dtype, batch_axis):
            parts = [None] * len(shp)
            if baxes:
                parts[batch_axis] = baxes if len(baxes) > 1 else baxes[0]
            return sds(lead + shp, dtype, [None] * len(lead) + parts)

        out: Dict[str, Any] = {}
        if cfg.frontend:
            out["embeddings"] = mk((b, s, cfg.frontend_dim), dt, 0)
            if cfg.adc.enable:
                # a constant: never gets the microbatch axis
                out["adc_mask"] = sds((cfg.frontend_dim, 2 ** cfg.adc.bits),
                                      torch.int32, ())
        else:
            out["tokens"] = mk((b, s), torch.int32, 0)
        out["positions"] = mk((b, s, 3) if cfg.mrope else (b, s),
                              torch.int32, 0)
        if shape.kind == "train":
            out["labels"] = mk((b, s), torch.int32, 0)
        return out

    if shape.kind == "train":
        n_mb = microbatches or default_microbatches(cfg, shape, mesh)
        return {"batch": batch_struct(shape.global_batch // n_mb,
                                      shape.seq_len, lead=(n_mb,)),
                "n_microbatches": n_mb}
    if shape.kind == "prefill":
        return {"batch": batch_struct(shape.global_batch, shape.seq_len)}
    b = shape.global_batch
    cache = serving.init_cache(cfg.replace(pad_heads_to=0), b,
                               shape.seq_len, device="meta")
    specs = sharding.cache_specs(cache, mesh, cfg)
    return {"batch": batch_struct(b, 1),
            "cache": {k: sharding.Sharded(t, specs[k])
                      for k, t in cache.items()}}
