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
  A rank's microbatch loop and its ``local_quantize`` are its unit of
  ``tensor_parallel.map_ranks``; the ring runs after every rank's.
  The parameters and the AdamW state live on the mesh's first device;
  every other distinct device of the ranks gets a copy of the
  parameters at the start of each step, so AdamW runs once, on rank 0's
  synced gradients, and no replica can drift. The synced gradients are
  equal on every rank, but with two pods only inside each pod
  (``optim/compression.py``); the reference's ``shard_map`` declares
  them replicated, so its pods' copies would drift apart (ROADMAP C).
* uncompressed: FSDP over the dp axes (``distributed/fsdp.py``), the
  reference's default parameter rules (extra_dp: over 'data').
  ``init_state`` places each parameter and both AdamW moments as
  ``fsdp.plan(cfg, mesh)`` gives them: each dp slice holds its piece of
  every leaf whose spec puts a dimension over the dp axes, the rest as
  the 'model' plan places them on the first slice. The step's ranks are
  the slices of the batch's axes (``sharding.batch_axes``: the dp
  slices, each its 'model' group; under extra_dp each (data, model)
  device), or the first slice alone where no rule divides a
  microbatch's rows. Rank r takes the r-th contiguous block of every
  microbatch's rows and runs the microbatch loop on them, the state
  bound to its devices (``fsdp.bind``: each layer's pieces gathered as
  the layer runs, inside its remat frame); the ranks are issued through
  ``tensor_parallel.map_ranks`` in order on one thread (a thread a card
  was slower on the H100 host, PERF.md section 6). Each gradient lands
  on its piece's owner and is added onto the owner's sum in one fixed
  order, rank then microbatch (no atomics, no scatter-add: two runs are
  bitwise equal); sums and loss are scaled by 1 / (n_mb ranks), so the
  loss is the ranks' mean (the chunked cross-entropy's ``tot / (b s)``
  over equal blocks; moe's aux is the dp shards' mean as the
  reference's ``shard_map`` gives it, each rank routing its own rows
  with ``dp = 1``, and the step raises where a microbatch's rows do not
  divide the dp shards). AdamW steps each piece on its owner. One rank
  on whole leaves (no mesh, dp = 1) is the one-device loop itself.

Tensor parallelism over 'model' (``distributed/tensor_parallel.py``):
where the parameter rules split weights over 'model' (every family but
the extra_dp configs; the ssm family's SSD over its heads),
``init_state`` places the parameters and the AdamW moments as
``tp_plan(cfg, mesh)`` gives them, each rank's slices on its device
(over dp > 1, uncompressed, each slice's pieces of them on its group's
devices). Under int8 (``RULES_TP_ONLY``) each dp rank runs its own
group (the state's slices copied to its group's devices at the
start of the step, as the replicas above); its gradients are gathered
whole on its first device and go through the ring unchanged; the synced
gradients are split again for AdamW, which steps each slice elementwise.

Refused, naming ROADMAP A11.9 (``tensor_parallel.check_mesh``): a mesh
mixing device types and the abstract production mesh
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
layer is ``Shards`` of its ranks' layer views, an FSDP leaf's
``fsdp.Pieces`` of its slices' layer views, each an autograd leaf).
``make_grad_step`` is the step before AdamW: the synced gradients, the
loss and the new error rows, the state untouched.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import fsdp, sharding
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
    placed as ``fsdp.param_plan(cfg, mesh)`` places them (each leaf drawn
    whole on the first device, then its pieces and slices copied to
    their devices; the moments beside them); under
    ``grad_compression="int8"`` a zero error row per dp rank of the mesh
    (one without a mesh), on the rank's first device."""
    dev = mesh.first_device if mesh is not None else resolve_device(device)
    plan = fsdp.param_plan(cfg, mesh)
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


def _at(leaf, i: int):
    """Layer i of a stacked leaf: a view, or the ``Shards`` / ``Pieces``
    of its ranks' and slices' layer views."""
    return leaf.at(i) if isinstance(leaf, (TP.Shards, fsdp.Pieces)) \
        else leaf[i]


def _n_layers(leaf) -> int:
    while isinstance(leaf, list):
        leaf = leaf[0]
    return leaf.shape[0]


def _fresh(t, leaves: list):
    """``t`` (a tensor, ``Shards`` or ``Pieces``) as fresh autograd leaves
    sharing its storage, appended to ``leaves``."""
    out = adamw.tree_map(lambda p: p.detach().requires_grad_(True), t)
    leaves.extend(adamw.tree_leaves(out))
    return out


def _layer_views(node, leaves: list):
    """A stacked subtree with each leaf a list of fresh per-layer leaves
    (module-level recursion: a nested function calling itself is a
    reference cycle, which would keep ``leaves``, and with them the
    parameters, alive until a collection)."""
    if isinstance(node, dict):
        return {k: _layer_views(v, leaves) for k, v in node.items()}
    return [_fresh(_at(node, i), leaves) for i in range(_n_layers(node))]


def _autograd_leaves(params):
    """(tree, leaves): ``params`` with every top-level tensor and every
    layer of every stacked leaf (``layers``, ``layers2`` and
    ``prelayers``, nested subtrees such as ``moe``, ``shared`` and ``ssm``
    included) as a fresh autograd leaf sharing the parameter's storage (a
    split leaf's every slice, an FSDP leaf's every piece); the flat leaf
    list in a fixed order, the trees' insertion order."""
    leaves: list = []
    tree = {key: (_layer_views(value, leaves) if key in _STACKED
                  else _fresh(value, leaves))
            for key, value in params.items()}
    return tree, leaves


def _layer_slots(node, slots: list) -> None:
    if isinstance(node, dict):
        for v in node.values():
            _layer_slots(v, slots)
    else:
        for i in range(_n_layers(node)):
            slots.extend(adamw.tree_leaves(_at(node, i)))


def _grad_slots(gsum):
    """The gradient sums' destinations in ``_autograd_leaves`` order."""
    slots: list = []
    for key, value in gsum.items():
        if key in _STACKED:
            _layer_slots(value, slots)
        else:
            slots.extend(adamw.tree_leaves(value))
    return slots


class _Unit(NamedTuple):
    """One rank of the step: its devices (a 'model' group; None: the
    state's device) and its block of each microbatch's rows."""
    devices: Optional[tuple]
    rows: slice


def _rank_plan(cfg: ArchConfig, mesh, b: int) -> List[_Unit]:
    """The step's ranks for a microbatch of ``b`` rows (see the module
    docstring); raises for what the step refuses. Uncompressed: one a
    slice of the batch's axes (``sharding.batch_axes``: the dp slices,
    each with its 'model' group; the (data, model) batch ranks under
    extra_dp), or the first slice alone where no rule divides ``b``.
    int8: one a dp rank."""
    if mesh is None or mesh.size == 1:
        return [_Unit(None, slice(0, b))]
    TP.check_mesh(cfg, mesh)
    axes = sharding.dp_axes(mesh)
    n = math.prod(mesh.shape[a] for a in axes)
    if cfg.grad_compression != "int8":
        if cfg.family == "moe" and b % n:
            raise ValueError(f"a microbatch of {b} rows does not split over "
                             f"the {n} dp shards of {mesh.shape} that the "
                             f"moe layers route apart")
        axes = sharding.batch_axes(mesh, cfg, b)
    elif b % n:
        raise ValueError(f"a microbatch of {b} rows does not split over "
                         f"the {n} dp ranks of {mesh.shape}")
    if not axes:
        return [_Unit(tuple(fsdp.slice_groups(mesh, None)[0]),
                      slice(0, b))]
    return [_Unit(tuple(g), rows) for g, (_, rows) in zip(
        fsdp.slice_groups(mesh, axes), sharding.shard_plan(mesh, axes, b))]


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


def _zero_sums(params):
    """Zero gradient sums beside ``params``' leaves (their pieces and
    slices), in ``promote_types(param, bf16)``."""
    return adamw.tree_map(
        lambda p: torch.zeros_like(
            p, dtype=torch.promote_types(p.dtype, torch.bfloat16)),
        params)


def _microbatches(params, batch, const, cfg: ArchConfig, n_mb: int, slots,
                  lsum, dp: int = 1, unit=None):
    """The microbatch loop of one rank on its rows: each microbatch's
    gradients added onto ``slots`` (``_grad_slots`` of the sums) in
    microbatch order, its loss onto ``lsum``; returns ``lsum``. ``unit``:
    the devices an FSDP step's rank gathers the state onto
    (``fsdp.bind``), None where ``params`` are already the rank's.
    ``dp``: the dp shards a moe layer routes apart
    (``transformer.loss_fn``)."""
    for j in range(n_mb):
        mb = {k: v[j] for k, v in batch.items()}
        live, leaves = _autograd_leaves(params)
        if unit is not None:
            live = fsdp.bind(live, unit)
        with torch.enable_grad():
            loss, _ = transformer.loss_fn(live, {**mb, **const}, cfg, dp=dp)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for slot, g in zip(slots, grads):
                slot.add_(g)
        lsum = lsum + loss.detach().to(lsum.device)
        del live, leaves, grads, loss
    return lsum


def _scaled(gsum, lsum, n: int):
    """The sums and the loss scaled by ``1 / n``."""
    scale = 1.0 / n
    with torch.no_grad():
        for g in adamw.tree_leaves(gsum):
            g.mul_(scale)
    return gsum, lsum * scale


def _local_grads(params, batch, const, cfg: ArchConfig, n_mb: int,
                 dp: int = 1):
    """One rank's microbatch loop: (the gradient sums over its n_mb
    microbatches scaled by 1 / n_mb, in ``promote_types(param, bf16)``;
    the microbatches' mean loss), on ``params``' devices. ``dp``: the dp
    shards a moe layer routes apart (``transformer.loss_fn``)."""
    dev = params["final_norm"].device
    gsum = _zero_sums(params)
    lsum = _microbatches(params, batch, const, cfg, n_mb, _grad_slots(gsum),
                         torch.zeros((), dtype=torch.float32, device=dev),
                         dp=dp)
    return _scaled(gsum, lsum, n_mb)


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
    placed_by = None if int8 else fsdp.plan(cfg, mesh)
    # uncompressed with more than one rank, or an FSDP state: each rank
    # gathers the state onto its devices (fsdp.bind)
    gathers = not int8 and (placed_by is not None or n > 1)

    def rank_batch(batch, rows, rdev):
        """(the rank's rows of every microbatch, the shared constants),
        on ``rdev``."""
        return ({k: v[:, rows].to(rdev) for k, v in batch.items()
                 if k != "adc_mask"},
                {k: v.to(rdev) for k, v in batch.items() if k == "adc_mask"})

    def fsdp_grads(params, batch, dev):
        """Each rank's microbatch loop on its rows, in rank order, every
        gradient added onto its owner's sum (rank, then microbatch); the
        sums and the loss scaled by 1 / (n_mb n): the ranks' mean."""
        gsum = _zero_sums(params)
        slots = _grad_slots(gsum)
        lsum = [torch.zeros((), dtype=torch.float32, device=dev)]

        def rank(r, unit):
            lsum[0] = _microbatches(params, *rank_batch(
                batch, unit.rows, unit.devices[0]), cfg, n_mb, slots,
                lsum[0], unit=unit.devices)
        TP.map_ranks(rank, plan)
        return _scaled(gsum, lsum[0], n_mb * n)

    def grad_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        dev = params["final_norm"].device
        if batch["labels"].shape[0] != n_mb:
            raise ValueError(f"the batch leads with {batch['labels'].shape[0]}"
                             f" microbatches; the step takes {n_mb}")
        if plan[0].devices is not None and plan[0].devices[0] != dev:
            raise ValueError(f"the state lives on {dev}, not on the mesh's "
                             f"first device {plan[0].devices[0]}")
        if placed_by is not None:
            fsdp.check_placed(params, placed_by)
        else:
            TP.check_placed(params, tp)
        if gathers:
            gsum, loss = fsdp_grads(params, batch, dev)
            return gsum, loss, None
        if not int8:                    # one rank (see _rank_plan)
            gsum, loss = _local_grads(params, *rank_batch(
                batch, plan[0].rows, dev), cfg, n_mb)
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

        def rank(r, group_rows, err):
            group, rows = group_rows
            group = first if group is None else tuple(group)
            rdev = group[0]
            gsum, loss = _local_grads(replicas[group], *rank_batch(
                batch, rows, rdev), cfg, n_mb)
            loss = loss.to(dev)
            # quantized as each rank finishes, so only one rank's
            # gradient sums are alive at a time; split sums gathered
            # whole on the rank's first device
            with torch.no_grad():
                flat, row = compression.local_quantize(
                    TP.gather_params(gsum, rdev), err, length=length)
            return flat, row, loss
        flats, new_err, losses = map(list, zip(*TP.map_ranks(
            rank, plan, state.err)))
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
