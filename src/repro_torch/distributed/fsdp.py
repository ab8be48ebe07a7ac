"""FSDP over the mesh's dp axes ('pod', 'data'): the port's counterpart of
GSPMD's placement of the LM's parameters and AdamW moments under the
reference's default parameter rules (``sharding.RULES_FSDP``: every
'embed' dimension over ('pod', 'data'), ZeRO-3 style; under
``RULES_EXTRA_DP`` over 'data'), and of the gathers and the gradient
reduce-scatter its compiled step runs.

Single-process, as ``tensor_parallel.py`` is: a hop is a ``.to()``, a
device may repeat (``[cpu, cpu]`` is two slices), and one host thread
issues every slice's work in slice order (``tensor_parallel.map_ranks``).

* ``plan(cfg, mesh)``: for each parameter path, the dimension its spec
  puts over the dp axes and those axes (``sharding.dp_dims``), the dp
  slices of each axes pod-major as ``sharding.shard_plan`` orders them,
  each with its 'model' group (``slice_groups``, ``tensor_parallel
  .tp_groups``'s rule), and the first slice's ``tensor_parallel.tp_plan``.
  None where no leaf is split over dp (dp = 1, int8's
  ``RULES_TP_ONLY``). ``param_plan`` is the plan a train state is placed
  by: this one, else the 'model' plan.
* ``Pieces``: one leaf split over the dp slices. Piece k lives on slice
  k's devices: on its first device, or, where the leaf is also split over
  'model', as ``tensor_parallel.Shards`` with rank r's piece of rank r's
  slice on the slice's rank-r device. A leaf the spec keeps whole over dp
  stays as ``tensor_parallel`` places it, on the first slice (a
  replicated leaf held once, as replicated leaves are over 'model'). So
  under extra_dp at (2, 2), four batch ranks read two owners' pieces,
  each held once on its slice's first device. ``Plan.place`` places a
  leaf (copies, never views of it); ``shard_params`` a tree;
  ``Pieces.gather`` gives a whole leaf back (and
  ``tensor_parallel.gather_params`` a whole tree: checkpoints, tests);
  ``place_like`` puts a whole leaf into another
  placement (checkpoint restore, ``elastic.reshard_state``).
* ``bind(tree, devices)``: a step's view of the state for one compute
  unit (a dp slice's 'model' group, or one extra_dp batch rank): every
  leaf wrapped as ``Bound``, which ``gather`` turns into what the layer
  functions take, a whole tensor on the unit's first device or
  ``Shards`` on its ranks, by copies and one concatenation in slice
  order (``_Gather``), whose backward hands each owner a copy of its
  piece's gradient. The layer
  functions never see ``Pieces`` or ``Bound``: ``transformer.forward_aux``
  gathers a layer's leaves inside its remat frame (the recomputation
  gathers again, so no layer's whole weights outlive its forward) and
  ``loss_fn`` the leaves outside the stacks (embedding, ``final_norm``,
  the head) once a microbatch.

The gradient sums live on the owners: ``models/steps.py`` adds each
unit's microbatch gradients of every piece onto the piece's sum in one
fixed order, unit then microbatch, so two runs are bitwise equal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as TP

Path = Tuple[str, ...]
Axes = Tuple[str, ...]


class Pieces(list):
    """One leaf split along ``dim`` over the slices of the dp ``axes``:
    entry k is slice k's piece, a tensor on the slice's first device or
    ``Shards`` of its 'model' ranks (see the module docstring)."""

    def __init__(self, parts, dim: int, axes: Axes) -> None:
        super().__init__(parts)
        self.dim = dim
        self.axes = tuple(axes)

    def like(self, parts, dim: Optional[int] = None) -> "Pieces":
        """Other pieces of the same slices."""
        return Pieces(parts, self.dim if dim is None else dim, self.axes)

    def at(self, i: int) -> "Pieces":
        """Layer i of a stacked leaf (split on a later dimension)."""
        if self.dim == 0:
            raise ValueError("a leaf split on its leading axis has no "
                             "layer slices")
        return self.like([p.at(i) if isinstance(p, TP.Shards) else p[i]
                          for p in self], self.dim - 1)

    def gather(self, device=None) -> torch.Tensor:
        """The whole leaf on ``device`` (default: the first piece's)."""
        parts = [TP.gather_params(p, device) for p in self]
        dev = parts[0].device if device is None else torch.device(device)
        return torch.cat([p.to(dev) for p in parts], self.dim)


def slice_groups(mesh, axes: Optional[Axes]) -> List[List[torch.device]]:
    """The devices of each slice of ``mesh`` along ``axes`` (major to
    minor in ``axes`` order, pod-major for ('pod', 'data')), each a list
    in 'model' order: its 'model' ranks where 'model' is not in
    ``axes``, else its one device. Mesh axes in neither take their first
    entry. ``axes`` None: the first slice alone."""
    names = tuple(mesh.axis_names)
    axes = tuple(axes or ())
    devs = np.asarray(mesh.devices, dtype=object)
    model = (names.index("model")
             if "model" in names and "model" not in axes else None)
    order = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in order and i != model]
    n = math.prod(mesh.shape[a] for a in axes)
    tp = 1 if model is None else mesh.shape["model"]
    grid = np.transpose(devs, order + rest + ([] if model is None
                                              else [model]))
    return [list(g[0]) for g in grid.reshape(n, -1, tp)]


class Plan(NamedTuple):
    """Where a config's parameters live over the dp slices: ``dp`` maps
    each path to (its dp dimension, the axes) or None; ``slices`` each
    axes' slices' 'model' groups; ``tp`` the first slice's
    'model' plan (None: no weight split over 'model'); ``first`` the
    mesh's first device."""
    dp: Dict[Path, Optional[Tuple[int, Axes]]]
    slices: Dict[Axes, List[Tuple[torch.device, ...]]]
    tp: Optional[TP.TPPlan]
    first: torch.device

    def split(self, path: Path) -> bool:
        return self.dp.get(tuple(path)) is not None

    def _model(self, path: Path, devices) -> Tuple[Optional[int], object]:
        if self.tp is None or self.tp.dims.get(path) is None:
            return None, None
        return self.tp.dims[path], self.tp._replace(
            devices=tuple(devices))

    def place(self, path: Path, leaf: torch.Tensor):
        """``leaf`` (the whole parameter at ``path``, or a tensor of its
        shape) placed by the plan: ``Pieces`` over its slices, or as the
        'model' plan places it on the first slice (copies, never views
        of ``leaf``)."""
        path = tuple(path)
        entry = self.dp.get(path)
        groups = ([self.tp.devices if self.tp else (self.first,)]
                  if entry is None else self.slices[entry[1]])
        dim = None if entry is None else entry[0]
        n = None if dim is None else leaf.shape[dim] // len(groups)
        if dim is not None and leaf.shape[dim] % len(groups):
            raise ValueError(f"{'/'.join(path)}: a dimension of "
                             f"{leaf.shape[dim]} does not split over "
                             f"{len(groups)} dp slices")
        parts = []
        for k, group in enumerate(groups):
            piece = leaf if dim is None else leaf.narrow(dim, k * n, n)
            mdim, tp = self._model(path, group)
            parts.append(
                TP.place(piece, mdim, tp) if mdim is not None else
                piece.to(group[0], copy=True,
                         memory_format=torch.contiguous_format))
        return parts[0] if dim is None else Pieces(parts, dim, entry[1])

    def stand_in(self, path: Path, dtype: torch.dtype):
        """Where ``place`` puts the leaf at ``path``, as empty tensors of
        ``dtype``: the ``like`` of a checkpoint's restore."""
        path = tuple(path)
        entry = self.dp.get(path)

        def one(group):
            mdim, tp = self._model(path, group)
            if mdim is None:
                return torch.empty(0, dtype=dtype, device=group[0])
            return TP.Shards([torch.empty(0, dtype=dtype, device=d)
                              for d in group], mdim, tp.ranks, tp.tp)
        if entry is None:
            return one(self.tp.devices if self.tp else (self.first,))
        return Pieces([one(g) for g in self.slices[entry[1]]], *entry)


def plan(cfg, mesh) -> Optional[Plan]:
    """The FSDP plan of ``cfg`` over ``mesh`` (module docstring): None
    without a mesh or where no leaf is split over the dp axes. Raises
    for a mesh the LM steps refuse (``tensor_parallel.check_mesh``)."""
    if mesh is None:
        return None
    from repro_torch.models import transformer
    dims = sharding.dp_dims(transformer.param_shapes(cfg), mesh, cfg)
    if all(v is None for v in dims.values()):
        return None
    TP.check_mesh(cfg, mesh)
    axes = sorted({v[1] for v in dims.values() if v is not None})
    return Plan(dims, {a: [tuple(g) for g in slice_groups(mesh, a)]
                       for a in axes},
                TP.tp_plan(cfg, mesh), mesh.first_device)


def param_plan(cfg, mesh):
    """The plan a train state of ``cfg`` over ``mesh`` is placed by: the
    FSDP plan, else ``tensor_parallel.tp_plan`` (None: whole leaves)."""
    return plan(cfg, mesh) or TP.tp_plan(cfg, mesh)


def shard_params(params, plan_):
    """``params`` (whole leaves: the parameter tree, or one of its shape
    such as a moment) placed by ``plan_`` (a ``Plan``, a 'model' plan or
    None), leaf by leaf."""
    if not isinstance(plan_, Plan):
        return TP.shard_params(params, plan_)

    def walk(node, path):
        return {k: (walk(v, path + (k,)) if isinstance(v, dict)
                    else plan_.place(path + (k,), v))
                for k, v in node.items()}
    return walk(params, ())


def place_like(whole: torch.Tensor, like, device=None):
    """``whole`` placed as ``like`` is (a tensor, ``Shards`` or
    ``Pieces``; its tensors read only for their devices), copies on
    ``device`` when given."""
    def to(t, ref):
        return t.to(ref.device if device is None else device, copy=True,
                    memory_format=torch.contiguous_format)

    def one(t, ref):
        if isinstance(ref, TP.Shards):
            n = t.shape[ref.dim] // ref.tp
            return ref.like([to(t.narrow(ref.dim, r * n, n), p)
                             for r, p in zip(ref.ranks, ref)])
        return to(t, ref)
    if not isinstance(like, Pieces):
        return one(whole, like)
    n = whole.shape[like.dim] // len(like)
    return like.like([one(whole.narrow(like.dim, k * n, n), p)
                      for k, p in enumerate(like)])


def check_placed(params, plan_: Plan) -> None:
    """Raise ValueError where ``params`` are not placed by ``plan_``: a
    leaf it splits over dp that is not ``Pieces`` of its slices, one it
    keeps whole that is, or a leaf split over 'model' where the 'model'
    plan does not split it (or the reverse)."""
    for path, leaf in TP._flat(params):
        entry = plan_.dp.get(path)
        pieces = isinstance(leaf, Pieces)
        model = plan_.tp is not None and plan_.tp.split(path)
        parts = leaf if pieces else [leaf]
        if pieces != (entry is not None) or (pieces and (
                leaf.dim != entry[0]
                or len(leaf) != len(plan_.slices[entry[1]]))) or any(
                isinstance(p, TP.Shards) != model for p in parts):
            raise ValueError(
                f"params/{'/'.join(path)} is not placed as the mesh's "
                f"plan places it (steps.init_state with the mesh, or "
                f"fsdp.shard_params with fsdp.param_plan)")


def held_bytes(trees, mesh) -> np.ndarray:
    """The bytes of ``trees``' tensors (nested dicts, NamedTuples and
    lists: a ``TrainState``'s parameters, moments and step) that each
    position of ``mesh`` holds, in ``mesh.devices``' shape: a piece on
    its slice's position, a 'model' slice on its rank's position of the
    first dp slice, anything else on the first position. Positions, not
    devices, so a device repeated in the mesh counts apart a slice."""
    ids = np.arange(mesh.size).reshape(np.asarray(mesh.devices).shape)
    at = _Grid(tuple(mesh.axis_names), dict(mesh.shape), ids)
    first = slice_groups(at, sharding.dp_axes(mesh))[0]
    out = np.zeros(mesh.size, dtype=np.int64)

    def add(pos, t):
        out[pos] += t.numel() * t.element_size()

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, Pieces):
            for g, piece in zip(slice_groups(at, x.axes), x):
                for pos, t in zip(g, piece if isinstance(piece, TP.Shards)
                                  else [piece]):
                    add(pos, t)
        elif isinstance(x, TP.Shards):
            for pos, t in zip(first, x):
                add(pos, t)
        elif isinstance(x, torch.Tensor):
            add(first[0], x)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
    walk(trees)
    return out.reshape(ids.shape)


class _Grid(NamedTuple):
    """A mesh's axes over position numbers (``held_bytes``)."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    devices: np.ndarray


# ------------------------------------------------------------- the step
class Bound(NamedTuple):
    """A stored leaf (or a layer's view of one: a tensor, ``Shards`` or
    ``Pieces``) and the compute unit's devices it is gathered onto."""
    leaf: object
    devices: Tuple[torch.device, ...]


def bind(tree, devices):
    """``tree`` (nested dicts whose leaves are tensors, ``Shards``,
    ``Pieces`` or plain lists of per-layer leaves) with every leaf
    wrapped as ``Bound`` to ``devices``."""
    devices = tuple(devices)
    if isinstance(tree, dict):
        return {k: bind(v, devices) for k, v in tree.items()}
    if type(tree) is list:                   # per-layer leaves of a stack
        return [bind(v, devices) for v in tree]
    return Bound(tree, devices)


class _Gather(torch.autograd.Function):
    """The pieces copied to ``dev`` and concatenated along ``dim`` in
    slice order. Backward, each piece's block of the gradient is copied
    to the piece's device, a new tensor even on the same device: a view
    would keep the whole gradient of the gathered leaf alive until the
    step's ``autograd.grad`` returns, so an owner would hold the whole
    layer's gradient of each layer instead of its piece's."""

    @staticmethod
    def forward(ctx, dev, dim, *pieces):
        ctx.dim = dim
        ctx.parts = [(p.shape[dim], p.device) for p in pieces]
        return torch.cat([p.to(dev) for p in pieces], dim)

    @staticmethod
    def backward(ctx, grad):
        out, start = [], 0
        for size, dev in ctx.parts:
            out.append(grad.narrow(ctx.dim, start, size).to(
                dev, copy=True, memory_format=torch.contiguous_format))
            start += size
        return (None, None, *out)


def _cat(pieces, dev, dim):
    if torch.is_grad_enabled() and any(p.requires_grad for p in pieces):
        return _Gather.apply(dev, dim, *pieces)
    return torch.cat([p.to(dev) for p in pieces], dim)


def gather(x):
    """What the layer functions take of ``x``: a ``Bound`` leaf copied to
    its unit's devices, pieces concatenated in slice order (a whole
    tensor on the first device, or ``Shards`` on the ranks;
    ``_Gather``); anything else as it is."""
    if not isinstance(x, Bound):
        return x
    leaf, devs = x
    if isinstance(leaf, Pieces):
        first = leaf[0]
        if isinstance(first, TP.Shards):
            return first.like([_cat([p[r] for p in leaf], devs[r], leaf.dim)
                               for r in range(len(first))])
        return _cat(list(leaf), devs[0], leaf.dim)
    if isinstance(leaf, TP.Shards):
        return leaf.like([p.to(d) for p, d in zip(leaf, devs)])
    return leaf.to(devs[0])


def gathered(tree):
    """``tree`` with its ``Bound`` leaves gathered, nested dicts walked
    and anything else (a stack's per-layer list included) kept."""
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    return gather(tree)


def placement(tree, _stand=None):
    """``tree`` with each ``Bound`` leaf replaced by where ``gather``
    puts it (``Shards`` of empty tensors on the unit's ranks for a leaf
    split over 'model', else the leaf): what ``tensor_parallel.remat_fn``
    reads to decide whether a layer's ranks span distinct devices."""
    stand = {} if _stand is None else _stand
    if isinstance(tree, dict):
        return {k: placement(v, stand) for k, v in tree.items()}
    if type(tree) is list:
        return [placement(v, stand) for v in tree]
    if not isinstance(tree, Bound):
        return tree
    leaf, devs = tree
    split = leaf[0] if isinstance(leaf, Pieces) else leaf
    if not isinstance(split, TP.Shards):
        return leaf
    if devs not in stand:
        stand[devs] = split.like([torch.empty(0, device=d)
                                  for d in devs[:len(split)]])
    return stand[devs]
