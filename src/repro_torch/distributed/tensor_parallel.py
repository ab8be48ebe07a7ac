"""Tensor parallelism over the mesh's 'model' axis: the port's counterpart
of GSPMD's placement of the LM's weights under ``sharding.param_specs``
and of the reference's ``shard_map`` over 'model' (moe's ``_local_moe``
and ``_gathered_moe``).

Like the rest of the port's mesh (``launch/mesh.py``) it is
single-process and runs on one host thread: no ``torch.distributed`` and
no NCCL. A hop is a ``.to()``, which autograd differentiates, and a
device may repeat, so ``[cuda:0, cuda:0]`` and ``[cpu, cpu]`` are
two-rank meshes.

* ``tp_plan(cfg, mesh)``: the 'model' ranks of the mesh's first 'data'
  slice and their devices (``sharding.shard_plan(mesh, ("model",),
  tp)``), and, for each parameter, the dimension its spec splits over
  'model' (None: replicated). The rules' divisibility fallbacks hold:
  heads that do not divide tp run replicated; k and v whose kv heads do
  not divide tp are replicated, and each rank reads the kv heads its q
  heads read (``rank_kv_heads``). ``None`` where the mesh splits no
  weight (tp = 1, or the extra_dp configs).
* ``shard_params``: a split leaf becomes ``Shards``, one slice a rank on
  the rank's device; a replicated leaf stays whole on the first device.
  ``gather_params`` is the inverse.
* ``reduce_sum``: partial outputs copied to one device and added in rank
  order, rank 0 first: the fixed order, and the whole all-reduce.
  ``gather_cat``: the vocab-split head's logits concatenated in rank
  order. ``run_ranks``: a column-then-row-parallel block (the SwiGLU
  MLPs), each rank on its own shards, the partials reduced.

Replicated work (norms, residual adds, the moe router, the loss on the
gathered logits) runs once, on the first device; only the work on split
weights runs per rank. A tensor that every rank reads reaches them
through ``broadcast``, whose backward adds the copies' gradients in rank
order: the backward all-reduce, in a fixed order on distinct cards too.

Refused, naming ROADMAP A11.9: the ssm family's 'model' split (mamba2's
``ssm_inner`` / ``ssm_heads``: its gated norm needs a cross-rank
reduction), a mesh mixing device types and the abstract production
mesh, which has no device to run on (the dry run counts rank 0 on meta
tensors through ``counting_plan``).

``metering()`` records, while it is open, the bytes a device of a real
TP group would move for each collective: an all-reduce of each
``reduce_sum`` output forward and of each broadcast input's gradient
backward (2 (tp - 1) / tp of the tensor, a ring), an all-gather of each
``gather_cat`` output ((tp - 1) / tp). The dry run reads it.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed import sharding

Path = Tuple[str, ...]


class Shards(list):
    """One tensor split over 'model': entry j is rank ``ranks[j]``'s
    slice (of ``tp`` ranks) along ``dim``, on that rank's device. A
    parameter, an activation split over heads, or a cache buffer.
    ``ranks`` is every rank but in the dry run's count (rank 0 alone)."""

    def __init__(self, parts, dim: int, ranks: Sequence[int] = None,
                 tp: Optional[int] = None) -> None:
        super().__init__(parts)
        self.dim = dim
        self.ranks = tuple(range(len(self)) if ranks is None else ranks)
        self.tp = len(self.ranks) if tp is None else int(tp)

    def like(self, parts, dim: Optional[int] = None) -> "Shards":
        """Other per-rank tensors of the same ranks."""
        return Shards(parts, self.dim if dim is None else dim, self.ranks,
                      self.tp)

    def at(self, i: int) -> "Shards":
        """Layer i of a stacked leaf split on a later dimension."""
        if self.dim == 0:
            raise ValueError("a leaf split on its leading axis has no "
                             "layer slices")
        return self.like([p[i] for p in self], self.dim - 1)

    @property
    def devices(self) -> List[torch.device]:
        return [p.device for p in self]


class TPPlan(NamedTuple):
    """Where a config's parameters live over the 'model' ranks: ``tp``
    ranks of which ``ranks`` are held, on ``devices``; ``dims`` maps each
    parameter path to the dimension split over 'model' (None:
    replicated, whole on the first device); ``num_heads`` /
    ``num_kv_heads`` give each rank's kv heads."""
    tp: int
    ranks: Tuple[int, ...]
    devices: Tuple[torch.device, ...]
    dims: Dict[Path, Optional[int]]
    num_heads: int
    num_kv_heads: int

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def split(self, path: Path) -> bool:
        return self.dims.get(tuple(path)) is not None

    def kv_heads(self, r: int) -> List[int]:
        """Rank r's kv heads, in its cache's order (``rank_kv_heads``)."""
        return rank_kv_heads(self.num_heads, self.num_kv_heads, self.tp, r)


def _flat(tree, prefix: Path = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _model_dim(spec) -> Optional[int]:
    for i, part in enumerate(spec):
        axes = part if isinstance(part, tuple) else (part,)
        if "model" in axes:
            return i
    return None


def split_dims(cfg, mesh, inference: bool = False
               ) -> Dict[Path, Optional[int]]:
    """{parameter path: the dimension its spec splits over 'model', or
    None}: ``sharding.param_specs`` of ``transformer.param_shapes``, the
    'model' entries only (the port holds each 'data' slice's weights
    whole: no FSDP)."""
    from repro_torch.models import transformer
    specs = sharding.param_specs(transformer.param_shapes(cfg), mesh, cfg,
                                 inference)
    return {path: _model_dim(spec) for path, spec in _flat(specs)}


def _refuse_split(cfg, dims) -> None:
    ssm = sorted("/".join(p) for p, d in dims.items()
                 if d is not None and "ssm" in p)
    if ssm:
        raise NotImplementedError(
            f"{cfg.name}: the 'model' axis would split the SSD's "
            f"{len(ssm)} weights ({ssm[0]}, ...): the ssm family over "
            f"'model' is not ported (ROADMAP A11.9)")


def check_mesh(cfg, mesh) -> None:
    """Raise NotImplementedError, naming ROADMAP A11.9, for a mesh the
    port's LM steps do not run on: one mixing device types, or the
    abstract production mesh."""
    types = {d.type for d in np.asarray(mesh.devices,
                                        dtype=object).reshape(-1)}
    if len(types) > 1:
        raise NotImplementedError(
            f"LM work on a mesh mixing device types {sorted(types)} is "
            f"not ported to repro_torch (ROADMAP A11.9)")
    if "meta" in types:
        raise NotImplementedError(
            f"{cfg.name}: a step over the abstract mesh {mesh.shape} is not "
            f"ported to repro_torch (ROADMAP A11.9); the dry run counts "
            f"rank 0 of a device's step on meta tensors "
            f"(launch/dryrun.py)")


def tp_groups(mesh) -> List[List[torch.device]]:
    """The 'model' ranks' devices of each dp rank (pod-major, as
    ``sharding.shard_plan`` orders the dp ranks), in 'model' order."""
    names = tuple(mesh.axis_names)
    devs = np.asarray(mesh.devices, dtype=object)
    if "model" not in names:
        return [[d] for d in devs.reshape(-1)]
    dp = [names.index(a) for a in sharding.dp_axes(mesh)]
    rest = [i for i in range(len(names)) if i not in dp
            and names[i] != "model"]
    n_dp = math.prod(mesh.shape[a] for a in sharding.dp_axes(mesh))
    grid = np.transpose(devs, dp + rest + [names.index("model")]).reshape(
        n_dp, -1, mesh.shape["model"])
    # axes other than the dp axes and 'model' replicate: their first entry
    return [list(g[0]) for g in grid]


def _plan(cfg, dims, tp, ranks, devices) -> Optional[TPPlan]:
    if tp == 1 or all(d is None for d in dims.values()):
        return None
    _refuse_split(cfg, dims)
    return TPPlan(tp, tuple(ranks), tuple(torch.device(d) for d in devices),
                  dims, cfg.num_heads, cfg.num_kv_heads)


def tp_plan(cfg, mesh, *, inference: bool = False) -> Optional[TPPlan]:
    """The plan of ``cfg`` over ``mesh``'s 'model' axis (see the module
    docstring): the first 'data' slice's ranks. None without a mesh or
    where the mesh splits no weight. Raises for what is refused."""
    if mesh is None:
        return None
    check_mesh(cfg, mesh)
    tp = mesh.shape.get("model", 1)
    devices = [dev for dev, _ in sharding.shard_plan(mesh, ("model",), tp)]
    return _plan(cfg, split_dims(cfg, mesh, inference), tp, range(tp),
                 devices)


def counting_plan(cfg, mesh, *, inference: bool = False
                  ) -> Optional[TPPlan]:
    """Rank 0 alone of ``mesh``'s 'model' ranks, on meta: what the dry
    run counts of a device's step (``launch/dryrun.py``)."""
    return _plan(cfg, split_dims(cfg, mesh, inference),
                 mesh.shape.get("model", 1), (0,), [torch.device("meta")])


def rank_kv_heads(num_heads: int, num_kv_heads: int, tp: int, r: int
                  ) -> List[int]:
    """The kv heads rank r's q heads (``[r H / tp, (r + 1) H / tp)``)
    read under GQA (q head h reads ``h // (H / KV)``), in the rank's
    order: each needed head once where the rank's heads group evenly
    over them (its q head j reads its kv head ``j // (H_r / KV_r)``, as
    attention's GQA does), else one a q head."""
    hl = num_heads // tp
    g = num_heads // num_kv_heads
    reads = [h // g for h in range(r * hl, (r + 1) * hl)]
    need = sorted(set(reads))
    if hl % len(need) == 0 and all(
            kv - need[0] == j // (hl // len(need))
            for j, kv in enumerate(reads)):
        return need
    return reads


# ------------------------------------------------------------ placement
def place(leaf: torch.Tensor, dim: Optional[int], plan: TPPlan):
    """One leaf placed by ``plan``: split along ``dim`` into ``Shards``
    (copies), or whole on the first device (``dim`` None)."""
    if dim is None:
        return leaf.to(plan.first)
    if leaf.shape[dim] % plan.tp:
        raise ValueError(f"a dimension of {leaf.shape[dim]} does not split "
                         f"over {plan.tp} ranks")
    n = leaf.shape[dim] // plan.tp
    return Shards([leaf.narrow(dim, r * n, n).to(
        dev, copy=True, memory_format=torch.contiguous_format)
        for r, dev in zip(plan.ranks, plan.devices)], dim, plan.ranks,
        plan.tp)


def shard_params(params, plan: Optional[TPPlan]):
    """``params`` (the parameter tree, or one of the same shape such as
    the AdamW moments or the gradients) placed by ``plan``: each split
    leaf as ``Shards`` (copies, never views of the input), each
    replicated leaf on the first device. ``plan`` None: the tree as it
    is. (Parameters too large to hold whole beside their split are drawn
    already placed: ``transformer.init_params(cfg, plan=plan)``.)"""
    if plan is None:
        return params

    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            else:
                if isinstance(v, Shards):
                    raise ValueError(f"{'/'.join(path + (k,))} is already "
                                     f"split")
                out[k] = place(v, plan.dims.get(path + (k,)), plan)
        return out

    return walk(params, ())


def gather_params(params, device=None):
    """The inverse of ``shard_params``: every ``Shards`` leaf
    concatenated whole in rank order on ``device`` (default: its first
    rank's device); replicated leaves moved to ``device`` when given. On
    meta, a leaf of which fewer ranks are held (the dry run's count) is
    a whole meta tensor."""
    def one(leaf):
        if isinstance(leaf, Shards):
            dev = leaf[0].device if device is None else torch.device(device)
            if len(leaf) != leaf.tp:
                if dev.type != "meta":
                    raise ValueError(f"{len(leaf)} of {leaf.tp} ranks held: "
                                     f"no whole leaf to gather")
                shape = list(leaf[0].shape)
                shape[leaf.dim] *= leaf.tp
                return torch.empty(shape, dtype=leaf[0].dtype, device=dev)
            return torch.cat([p.to(dev) for p in leaf], leaf.dim)
        return leaf if device is None else leaf.to(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return one(node)

    return walk(params)


def is_split(tree) -> bool:
    """Whether any leaf of ``tree`` is ``Shards``."""
    if isinstance(tree, Shards):
        return True
    if isinstance(tree, dict):
        return any(is_split(v) for v in tree.values())
    return False


def plan_of(params, cfg) -> Optional[TPPlan]:
    """The plan ``params`` are placed by, read off their ``Shards`` (None
    where every leaf is whole): what a call without a mesh runs on, such
    as the dry run's rank-0 count."""
    dims = {path: (leaf.dim if isinstance(leaf, Shards) else None)
            for path, leaf in _flat(params)}
    split = next((leaf for _, leaf in _flat(params)
                  if isinstance(leaf, Shards)), None)
    if split is None:
        return None
    return TPPlan(split.tp, split.ranks, tuple(split.devices), dims,
                  cfg.num_heads, cfg.num_kv_heads)


def check_placed(params, plan: Optional[TPPlan]) -> None:
    """Raise ValueError where ``params``' split leaves are not the ones
    ``plan`` splits, or are held by other ranks (``plan`` None: a call
    without a mesh, which runs on whatever placement it is given)."""
    if plan is None:
        return
    for path, leaf in _flat(params):
        want = plan.split(path)
        if isinstance(leaf, Shards) != want or (
                want and leaf.ranks != plan.ranks):
            raise ValueError(
                f"params/{'/'.join(path)} is "
                f"{'split' if isinstance(leaf, Shards) else 'whole'}; the "
                f"mesh's plan {'splits' if want else 'keeps whole'} it "
                f"(transformer.shard_params with the mesh's plan)")


# ------------------------------------------------------------ collectives
_METER: List[Dict[str, float]] = []


@contextlib.contextmanager
def metering():
    """Record the collective bytes a device of a real TP group moves (see
    the module docstring) while open: yields {"all-reduce": bytes,
    "all-gather": bytes, "calls": n}."""
    rec = {"all-reduce": 0.0, "all-gather": 0.0, "calls": 0}
    _METER.append(rec)
    try:
        yield rec
    finally:
        _METER.pop()


def _record(kind: str, t: torch.Tensor, tp: int, whole: float = 1.0
            ) -> None:
    """Meter a collective over ``tp`` ranks of ``t`` (``whole`` times
    ``t``'s bytes: an all-gather's output of fewer ranks than tp)."""
    if not _METER or tp < 2:
        return
    share = (2.0 if kind == "all-reduce" else 1.0) * (tp - 1) / tp
    _METER[-1][kind] += t.numel() * t.element_size() * share * whole
    _METER[-1]["calls"] += 1


class _Broadcast(torch.autograd.Function):
    """x copied to each of ``devices`` (the same tensor where the device
    is x's). Backward, the copies' gradients are copied to x's device and
    added in rank order, rank 0 first: the backward all-reduce, in one
    order whatever the devices. (Left to autograd, copies arriving from
    distinct cards are added in the order their device threads finish,
    so a split step on distinct cards would differ from run to run and
    from the same mesh on one card repeated.)"""

    @staticmethod
    def forward(ctx, x, devices, tp):
        ctx.dev, ctx.tp = x.device, tp
        ctx.set_materialize_grads(False)
        return tuple(x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        out = None
        for g in grads:
            if g is not None:
                g = g.to(ctx.dev)
                out = g if out is None else out + g
        if out is not None:
            _record("all-reduce", out, ctx.tp)
        return out, None, None


def broadcast(x: torch.Tensor, like: Shards) -> List[torch.Tensor]:
    """``x`` on each of ``like``'s ranks' devices (a ``.to()`` a rank;
    the same tensor where the device is x's); where x needs a gradient,
    the copies' gradients are summed in rank order (``_Broadcast``)."""
    devices = [p.device for p in like]
    if not (x.requires_grad and torch.is_grad_enabled()):
        return [x.to(d) for d in devices]
    return list(_Broadcast.apply(x, devices, like.tp))


def _first_split(tree) -> Optional[Shards]:
    if isinstance(tree, Shards):
        return tree
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for v in items:
        found = _first_split(v)
        if found is not None:
            return found
    return None


class _RecomputeHere(torch.autograd.Function):
    """The identity, saving its input: the last op of a rematerialised
    layer (``remat_fn``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.saved_tensors                   # the layer's first unpack
        return grad


def remat_fn(fn, params):
    """``fn`` as ``torch.utils.checkpoint`` should rematerialise it over
    ``params``. Where their slices span distinct devices, fn's tensor
    outputs pass through ``_RecomputeHere``, whose backward (the layer's
    first, on the output's device) unpacks a saved tensor and so
    recomputes the whole layer there before any rank's device thread
    reaches it: the checkpoint's unpack hook takes no lock, and two
    device threads unpacking first would recompute one layer at once
    and fail. Otherwise ``fn`` itself."""
    split = _first_split(params)
    if split is None or len({p.device for p in split}) < 2:
        return fn

    def gate(o):
        return (_RecomputeHere.apply(o)
                if torch.is_tensor(o) and o.requires_grad else o)

    def gated(*args, **kw):
        out = fn(*args, **kw)
        return tuple(map(gate, out)) if isinstance(out, tuple) else gate(out)
    return gated


def reduce_sum(parts: Sequence[torch.Tensor], dev, tp: int
               ) -> torch.Tensor:
    """The ranks' partial outputs copied to ``dev`` and added in rank
    order, rank 0 first (``tp``: the group's size, for ``metering``)."""
    dev = torch.device(dev)
    out = parts[0].to(dev)
    for p in parts[1:]:
        out = out + p.to(dev)
    _record("all-reduce", out, tp)
    return out


def gather_cat(parts: Sequence[torch.Tensor], dim: int, dev, tp: int
               ) -> torch.Tensor:
    """The ranks' slices copied to ``dev`` and concatenated along ``dim``
    in rank order (``tp`` as ``reduce_sum``'s)."""
    dev = torch.device(dev)
    out = torch.cat([p.to(dev) for p in parts], dim)
    _record("all-gather", out, tp, tp / len(parts))
    return out


def run_ranks(fn, x: torch.Tensor, *weights: Shards) -> torch.Tensor:
    """``fn(x, *w)`` for each rank on its device with its shards ``w`` of
    ``weights`` (a column-split product then a row-split one), the
    partial outputs ``reduce_sum``'d onto x's device."""
    like = weights[0]
    parts = [fn(xr, *ws) for xr, *ws in zip(broadcast(x, like), *weights)]
    return reduce_sum(parts, x.device, like.tp)


def weight_bytes(params) -> List[int]:
    """Bytes of the parameters each held rank keeps: its shard of every
    split leaf, plus every replicated leaf for rank 0 (whose device holds
    them)."""
    out = None
    rep = 0
    for _, leaf in _flat(params):
        if isinstance(leaf, Shards):
            sizes = [p.numel() * p.element_size() for p in leaf]
            out = sizes if out is None else [a + b for a, b in zip(out,
                                                                   sizes)]
        else:
            rep += leaf.numel() * leaf.element_size()
    out = out or [0]
    out[0] += rep
    return out
