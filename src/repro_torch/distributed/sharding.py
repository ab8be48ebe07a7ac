"""Axis rules: the LM's parameters and batch, the sharded search's
population and the sharded design bank. Counterpart of
``repro/distributed/sharding.py``, copied in behaviour: the rules read only
``mesh.axis_names`` and ``mesh.shape``, so they take the port's
``launch.mesh.Mesh`` and the reference tests' ``SimpleNamespace`` meshes
alike.

A spec is a tuple with one entry per dimension: None, an axis name or a
tuple of names, trailing Nones dropped, as ``PartitionSpec`` prints it.
The LM's rule sets are the reference's: FSDP by default ('embed' over
('pod', 'data')); TP-only under ``grad_compression="int8"`` (parameters
replicated over the dp axes, so per-rank gradients exist for the int8
ring); extra_dp for archs whose heads do not split over 'model', where
'model' becomes data parallelism. The port reads both kinds of entry:
the 'model' ones in ``distributed/tensor_parallel.py`` (each leaf's
dimension split over the 'model' ranks), the dp ones ('pod' and 'data',
``dp_dims``) in ``distributed/fsdp.py`` (each dp slice holds its piece of
every leaf the spec splits over them, and of both AdamW moments).

``shard_plan`` says where each shard runs: shard k of a leading axis
split over ``axes`` runs on the first device of the k-th slice of the
mesh along ``axes``; mesh axes not in ``axes`` replicate, as under
``shard_map``.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

# GA individuals are embarrassingly parallel, so the population axis of
# the in-training ADC search (core/search.py, engine='sharded') may take
# every mesh axis: candidates tried in preference order; all axes present
# and the dim divides evenly
RULES_POPULATION: Tuple[Tuple[str, ...], ...] = (
    ("pod", "data", "model"), ("data", "model"), ("pod", "data"),
    ("data",), ("model",))


# candidates tried in order; a candidate applies iff all its axes exist in
# the mesh, none is already used in this tensor, and the dim divides evenly
RULES_FSDP: Dict[Optional[str], tuple] = {
    "batch": (("pod", "data"), ("data",)),
    "vocab": (("model",),),
    "embed": (("pod", "data"), ("data",)),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "head_dim": (("model",),),
    "mlp": (("model",),),
    "expert": (("model",),),
    "expert_mlp": (),
    "ssm_inner": (("model",),),
    "ssm_heads": (("model",),),
    "ssm_bc": (),
    "layers": (), "seq": (), "state": (), None: (),
}
RULES_TP_ONLY = dict(RULES_FSDP)
RULES_TP_ONLY["embed"] = ()          # replicate over dp: local grads exist
RULES_TP_ONLY["vocab"] = (("model",),)

# archs that cannot TP their attention/SSD heads (musicgen 24H, hymba 25H /
# 50 SSD heads): the model axis becomes extra data parallelism; weights are
# FSDP over 'data' only (replicated over 'model')
RULES_EXTRA_DP: Dict[Optional[str], tuple] = {
    "batch": (("pod", "data", "model"), ("data", "model"),
              ("pod", "data"), ("data",)),
    "vocab": (), "embed": (("data",),), "heads": (), "kv_heads": (),
    "head_dim": (), "mlp": (), "expert": (), "expert_mlp": (),
    "ssm_inner": (), "ssm_heads": (), "ssm_bc": (),
    "layers": (), "seq": (), "state": (), None: (),
}


def rules_for(cfg) -> Dict[Optional[str], tuple]:
    if cfg.grad_compression != "none":
        return RULES_TP_ONLY
    if getattr(cfg, "extra_dp", False):
        return RULES_EXTRA_DP
    return RULES_FSDP


Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


class Sharded(NamedTuple):
    """A stand-in for one input or state leaf of a step over a mesh: a
    meta tensor of its global shape and dtype, and its spec (the
    reference's ``ShapeDtypeStruct`` with a ``NamedSharding``)."""
    tensor: torch.Tensor
    spec: Spec


def spec_for(shape: Tuple[int, ...], logical: Tuple[Optional[str], ...],
             mesh, rules: Dict) -> Spec:
    """The spec of a tensor of ``shape`` whose dims carry the ``logical``
    axis names: each dim takes the first candidate of its rule that fits
    (see the rule tables), trailing Nones dropped."""
    if len(shape) != len(logical):
        raise ValueError(f"shape {shape} does not fit the logical axes "
                         f"{logical}")
    used: set = set()
    parts = []
    for dim, name in zip(shape, logical):
        chosen = None
        for cand in rules.get(name, ()):
            axes = tuple(a for a in cand if a in mesh.axis_names)
            if len(axes) != len(cand) or any(a in used for a in axes):
                continue
            size = math.prod(mesh.shape[a] for a in axes)
            if size > 1 and dim % size == 0:
                chosen = axes
                used.update(axes)
                break
        parts.append(None if chosen is None
                     else (chosen if len(chosen) > 1 else chosen[0]))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


_VECTOR = ("ln1", "ln2", "ln1p", "ln2p", "final_norm", "attn_scale",
           "ssm_scale", "norm_w", "conv_b_x", "conv_b_bc", "A_log", "D",
           "dt_bias")


def _leaf_logical(path: Tuple[str, ...], ndim: int,
                  inference: bool = False) -> Tuple[Optional[str], ...]:
    """The logical axis names of the parameter at ``path`` (dict keys),
    matched on its name as the reference matches them. Weights are never
    head_dim-sharded (a sharded contraction dim turns attention into a
    score all-reduce); a moe expert's hidden dim goes to the dp axes in
    inference (decode gathers tokens, never weights)."""
    name = path[-1]
    stacked = any(k in ("layers", "layers2", "prelayers") for k in path)
    lead: Tuple[Optional[str], ...] = ("layers",) if stacked else ()
    in_moe = "moe" in path and "shared" not in path

    def pad(t):
        out = lead + t
        if len(out) != ndim:
            raise ValueError(f"{'/'.join(path)}: {ndim} dims, logical "
                             f"axes {out}")
        return out

    if name == "embed":
        return pad(("vocab", "embed"))
    if name == "head":
        return pad(("embed", "vocab"))
    if name == "front_proj":
        return pad((None, "embed"))
    if name in _VECTOR:
        return pad((None,)) if ndim == len(lead) + 1 else pad((None, None))
    if name == "q":
        return pad(("embed", "heads", None))
    if name in ("k", "v"):
        return pad(("embed", "kv_heads", None))
    if name == "o":
        return pad(("heads", None, "embed"))
    if name == "router":
        return pad(("embed", None))
    if in_moe and name in ("wi", "wg"):
        return pad(("expert", None, "embed") if inference
                   else ("expert", "embed", "expert_mlp"))
    if in_moe and name == "wo":
        return pad(("expert", "embed", None) if inference
                   else ("expert", "expert_mlp", "embed"))
    if name in ("wi", "wg"):
        return pad(("embed", "mlp"))
    if name == "wo":
        return pad(("mlp", "embed"))
    if name in ("z_proj", "x_proj"):
        return pad(("embed", "ssm_inner"))
    if name == "bc_proj":
        return pad(("embed", "ssm_bc"))
    if name == "dt_proj":
        return pad(("embed", "ssm_heads"))
    if name == "conv_w_x":
        return pad((None, "ssm_inner"))
    if name == "conv_w_bc":
        return pad((None, "ssm_bc"))
    if name == "out_proj":
        return pad(("ssm_inner", "embed"))
    raise KeyError(f"no logical-axis rule for param path {path}")


def param_specs(params_shape, mesh, cfg, inference: bool = False):
    """The spec of every parameter, in ``params_shape``'s tree (nested
    dicts whose leaves are tensors or shape tuples, e.g.
    ``transformer.param_shapes(cfg)``)."""
    rules = rules_for(cfg)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        shape = tuple(node.shape if hasattr(node, "shape") else node)
        return spec_for(shape, _leaf_logical(path, len(shape), inference),
                        mesh, rules)

    return walk(params_shape, ())


def dp_dims(params_shape, mesh, cfg
            ) -> Dict[Tuple[str, ...], Optional[Tuple[int, Tuple[str, ...]]]]:
    """{parameter path: (the dimension its training spec puts over the dp
    axes, those axes: ('pod', 'data') or ('data',)), or None} for
    ``params_shape`` (as ``param_specs`` takes it) under
    ``rules_for(cfg)``: None everywhere under ``grad_compression="int8"``
    (``RULES_TP_ONLY`` replicates over dp), and where a leaf's 'embed'
    dimension does not divide the dp axes."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
            return
        out[path] = None
        for i, part in enumerate(node):
            axes = part if isinstance(part, tuple) else (part,)
            if any(a in ("pod", "data") for a in axes):
                out[path] = (i, tuple(axes))
                break

    walk(param_specs(params_shape, mesh, cfg), ())
    return out


def cache_specs(cache_shape, mesh, cfg) -> Dict[str, Spec]:
    """The spec of every leaf of a decode cache (``serving.init_cache``'s
    dict; leaves are tensors or shape tuples): batch over the dp axes;
    kv heads over 'model', or, where the kv heads do not divide 'model',
    the sequence (decode then all-reduces only the softmax statistics);
    the SSD's inner and head dims over 'model' where they divide."""
    rules = rules_for(cfg)
    tp = mesh.shape.get("model", 1)

    def one(key, leaf):
        shape = tuple(leaf.shape if hasattr(leaf, "shape") else leaf)
        nd = len(shape)
        if key == "pos":
            return ()
        if key in ("kpos", "kpos2"):
            return (None,)                 # the reference's P(None)
        if key.startswith(("k", "v")):
            # (L, B, C, KV, hd)
            if nd == 5 and tp > 1 and cfg.num_kv_heads % tp and \
                    shape[2] % tp == 0:
                loc = dict(rules, cache_seq=(("model",),), kv_heads=(),
                           head_dim=())
                return spec_for(shape, ("layers", "batch", "cache_seq",
                                        "kv_heads", "head_dim"), mesh, loc)
            logical = ("layers", "batch", "seq", "kv_heads",
                       "head_dim")[:nd]
        elif key == "conv_x":
            logical = ("layers", "batch", None, "ssm_inner")
        elif key == "conv_bc":
            logical = ("layers", "batch", None, "ssm_bc")
        elif key == "state":
            logical = ("layers", "batch", "ssm_heads", "state", None)
        else:
            logical = (None,) * nd
        return spec_for(shape, logical, mesh, rules)

    return {k: one(k, v) for k, v in cache_shape.items()}


def batch_spec(mesh, extra_dims: int = 1) -> Spec:
    """Sharding of (B, ...) activations and inputs: batch over the dp
    axes."""
    dp = dp_axes(mesh)
    return (dp if len(dp) > 1 else (dp[0] if dp else None),
            *([None] * extra_dims))


def batch_axes(mesh, cfg, b: int) -> Optional[Tuple[str, ...]]:
    """Mesh axes the batch dim shards over: the first candidate of
    ``rules_for(cfg)["batch"]`` whose axes are all in the mesh, whose
    size exceeds 1 and divides ``b``."""
    for cand in rules_for(cfg)["batch"]:
        axes = tuple(a for a in cand if a in mesh.axis_names)
        if len(axes) != len(cand):
            continue
        size = math.prod(mesh.shape[a] for a in axes)
        if size > 1 and b % size == 0:
            return axes
    return None


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def population_axes(mesh, p: int) -> Optional[Tuple[str, ...]]:
    """Mesh axes the (P,)-leading population batch shards over: the
    divisible candidate from RULES_POPULATION covering the most devices
    (ties go to the earlier candidate). A size-1 winner is legal (a
    trivial shard). None means no candidate divides P: the caller falls
    back to the unsharded path."""
    best: Optional[Tuple[str, ...]] = None
    best_size = 0
    for cand in RULES_POPULATION:
        axes = tuple(a for a in cand if a in mesh.axis_names)
        if len(axes) != len(cand):
            continue
        size = math.prod(mesh.shape[a] for a in axes)
        if p % size == 0 and size > best_size:
            best, best_size = axes, size
    return best


def design_bank_axes(mesh, d: int) -> Optional[Tuple[str, ...]]:
    """Mesh axes the (D,)-leading deployed-design bank shards over: a
    Pareto front's designs are independent as GA individuals are (one
    shared sample batch, per-design tables and weights), so the rules
    are the population rules."""
    return population_axes(mesh, d)


def shard_plan(mesh, axes: Optional[Tuple[str, ...]], n: int
               ) -> List[Tuple]:
    """``[(device, slice), ...]`` in shard order for a leading axis of
    length ``n`` split over ``axes``: shard k takes rows
    ``[k * n / s, (k + 1) * n / s)`` (s the product of the ``axes``
    sizes, major to minor in ``axes`` order) on the first device of the
    k-th slice of ``mesh.devices`` along ``axes``. A device that repeats
    in the mesh takes several shards. ``axes=None`` (no rule divides
    ``n``) is one unsharded entry on the mesh's first device. Raises if
    ``axes`` are not mesh axes or their size does not divide ``n``."""
    if axes is None:
        first = np.asarray(mesh.devices, dtype=object).reshape(-1)[0]
        return [(first, slice(0, n))]
    names = tuple(mesh.axis_names)
    axes = tuple(axes)
    missing = [a for a in axes if a not in names]
    if missing or len(set(axes)) != len(axes):
        raise ValueError(f"axes {axes} are not distinct axes of the mesh "
                         f"{names}")
    shards = math.prod(mesh.shape[a] for a in axes)
    if n % shards:
        raise ValueError(f"a leading axis of {n} does not split over "
                         f"{axes} ({shards} shards)")
    order = [names.index(a) for a in axes]
    order += [i for i in range(len(names)) if i not in order]
    grid = np.transpose(np.asarray(mesh.devices, dtype=object), order)
    firsts = grid.reshape(shards, -1)[:, 0]
    step = n // shards
    return [(dev, slice(k * step, (k + 1) * step))
            for k, dev in enumerate(firsts)]
