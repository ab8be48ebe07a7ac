"""Dry run of the production LM job: every (architecture x input-shape)
cell against the production meshes, counted on meta tensors. Counterpart
of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell's step for 512 fake devices
and reads memory, cost and collectives from the compiled module. The
port has no compiler between it and the card, so a cell here is one
device's step run on meta tensors (shapes and dtypes, no storage) under
``analysis.count_step``:

* the production mesh (``launch/mesh.make_production_mesh``: (16, 16)
  'data' x 'model', or (2, 16, 16) with 'pod') is abstract; its specs
  (``sharding.param_specs``, ``cache_specs``, ``steps.input_specs``) are
  the reference's;
* a device's rows are the rows the batch spec gives it; its step runs
  with no mesh on those rows. Where the batch is not split over 'model'
  and the parameter specs split weights over it, the device is rank 0
  of the port's tensor-parallel step (``TENSOR_PARALLEL``): its weights
  are rank 0's slices (``tensor_parallel.counting_plan``: 1/tp of each
  split leaf, the replicated leaves whole), so the split work (the
  projections over its heads, its MLP columns, its experts, its vocab
  columns and attention on its heads) counts 1/tp and the replicated
  work (embedding rows, norms, residual adds, the moe router, the loss
  on the gathered logits) counts whole. Its collective term adds what
  ``tensor_parallel.reduce_sum`` / ``gather_cat`` and their backward move
  a device (``tensor_parallel.metering``): a ring all-reduce of each
  attention-out, MLP-out, moe-out and embedding activation a layer
  forward (and in the rematerialised forward) and of its input's
  gradient backward, 2 (tp - 1) / tp of it, and an all-gather of the
  logits, (tp - 1) / tp. The ssm family's 'model' split is not ported
  (ROADMAP A11.9): its count is divided by the 'model' size, an even
  split assumed, with no collective (``SSM_DIVIDED``). Where no weight
  is split over 'model' (the extra_dp configs, whose heads do not divide
  it), a batch not split over it is replicated there, and the count
  stands whole;
* train: one microbatch's ``grad_step`` (its gradient-sum set-up and
  scale included) times ``n_microbatches``, then AdamW once on the
  device's parameters (``steps.apply_grads`` on rank 0's slices and the
  replicated leaves, scaled to the device's share under the spec: it is
  elementwise a leaf); the collective term adds the dp gradient sync, a
  ring all-reduce over the batch's axes: 2 (dp - 1) / dp of the device's
  gradient in int8 under ``grad_compression="int8"``, else in the
  gradient's dtype;
* prefill and decode: ``serving.prefill`` / ``decode_step`` on the
  device's rows (decode against a meta cache of ``seq_len``, rank 0's kv
  heads under tensor parallelism);
* per-device bytes: the parameters, AdamW's moments and the int8 error
  row, each under its spec, and the inputs under theirs (the cache
  included): the counterpart of ``memory_analysis``'s
  ``argument_size_in_bytes``.

Published configs whose heads pad (``pad_heads_to > num_heads``:
gemma2-2b, yi-34b, llama4-scout) are refused by the port's models
(ROADMAP C); their cells are counted with ``pad_heads_to=0`` and say so
(``"reduced"``). The roofline is the H100 row's (``analysis.H100``):
data-sheet rates, estimates and no measurement. Each (arch, shape) is
counted once per distinct per-device step and reused for the other mesh.

  PYTHONPATH=src python -m repro_torch.launch.dryrun              # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
      --shape train_4k --mesh single

Writes one JSON a cell to ``experiments/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCH_NAMES, applicable_shapes, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch import analysis
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import serving, steps, transformer
from repro_torch.optim import adamw

TENSOR_PARALLEL = ("rank 0 of the port's tensor-parallel step: split work "
                   "1/tp, replicated work whole, reduce_sum / gather_cat "
                   "and their backward as ring collectives")
SSM_DIVIDED = ("the ssm family's 'model' split is not ported (ROADMAP "
               "A11.9): count divided by the 'model' size, no collective")
PADDED = "pad_heads_to=0 (ROADMAP C)"


def _axes(part) -> tuple:
    """A spec entry's mesh axes."""
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def shards(spec, mesh) -> int:
    """How many ways ``spec`` splits its tensor over ``mesh``."""
    return math.prod(mesh.shape[a] for part in spec for a in _axes(part))


def _meta(shape, dtype, spec):
    return sharding.Sharded(torch.empty(tuple(shape), dtype=dtype,
                                        device="meta"), tuple(spec))


def _zip(shapes, specs, fn, path=()):
    return {k: (_zip(v, specs[k], fn, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v, specs[k]))
            for k, v in shapes.items()}


def state_structs(cfg, mesh, inference: bool = False):
    """(TrainState, params) of ``sharding.Sharded`` meta leaves: the
    parameters (``transformer.param_shapes``, ``leaf_dtype``) under
    ``param_specs``, AdamW's step and moments (``opt_state_dtype``, the
    parameters' specs) and, under ``grad_compression="int8"``, the
    (dp, n) bf16 error buffer, a row a dp rank. The counterpart of
    ``jax.eval_shape(init_params)``; nothing is drawn."""
    shapes = transformer.param_shapes(cfg)
    specs = sharding.param_specs(shapes, mesh, cfg, inference)
    params = _zip(shapes, specs, lambda path, shp, spec: _meta(
        shp, transformer.leaf_dtype(cfg, path), spec))
    opt_dt = transformer.torch_dtype(cfg.opt_state_dtype)

    def moment(path, shp, spec):
        return _meta(shp, opt_dt, spec)

    opt = adamw.OptState(step=_meta((), torch.int32, ()),
                         m=_zip(shapes, specs, moment),
                         v=_zip(shapes, specs, moment))
    err = None
    if cfg.grad_compression == "int8":
        n = sum(math.prod(s) for _, s in transformer._flat(shapes))
        dp = sharding.dp_axes(mesh)
        dpt = math.prod(mesh.shape[a] for a in dp)
        err = _meta((dpt, n), torch.bfloat16,
                    (dp if len(dp) > 1 else dp[0], None))
    return steps.TrainState(params, opt, err), params


def meta_state(cfg, plan=None) -> steps.TrainState:
    """The whole TrainState as meta tensors (an int8 config's one error
    row included): what one device's step runs on in the dry run; with a
    ``plan`` (``tensor_parallel.counting_plan``) the parameters and
    moments are its ranks' slices."""
    state, _ = state_structs(cfg, AbstractMesh((1, 1), ("data", "model")))
    err = None if state.err is None else [
        torch.empty(state.err.tensor.shape[1], dtype=torch.bfloat16,
                    device="meta")]

    def placed(tree):
        return TP.shard_params(tensors(tree), plan)

    return steps.TrainState(placed(state.params), adamw.OptState(
        tensors(state.opt.step), placed(state.opt.m), placed(state.opt.v)),
        err)


def tree_bytes(tree) -> float:
    """Bytes of a tree's tensors (a split leaf's held slices)."""
    return float(sum(t.numel() * t.element_size()
                     for t in adamw.tree_leaves(tree)))


def tensors(tree):
    """``tree`` with every ``Sharded`` leaf replaced by its tensor."""
    if isinstance(tree, sharding.Sharded):
        return tree.tensor
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    return tree


def _leaves(tree):
    if isinstance(tree, sharding.Sharded):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, adamw.OptState):
        return _leaves([tree.step, tree.m, tree.v])
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def bytes_per_device(tree, mesh=None) -> float:
    """Bytes one device of ``mesh`` holds of ``tree``'s ``Sharded``
    leaves (no mesh: the leaves whole)."""
    return float(sum(x.tensor.numel() * x.tensor.element_size()
                     / (shards(x.spec, mesh) if mesh else 1)
                     for x in _leaves(tree)))


def _local(s: sharding.Sharded, axis: int, rows: int, lead: bool):
    """A device's meta tensor of batch leaf ``s``: ``rows`` rows on its
    batch axis, one microbatch (kept as a lead of 1) when ``lead``."""
    t = s.tensor
    if not s.spec:                     # a constant (adc_mask): whole
        return t
    shape = list(t.shape)
    shape[axis] = rows
    if lead:
        shape[0] = 1
    return torch.empty(shape, dtype=t.dtype, device="meta")


def _sync_stats(cfg, state, baxes, mesh) -> analysis.StepStats:
    """The dp gradient sync's bytes per device: a ring all-reduce over
    the ``baxes`` ranks of the device's gradient (its parameters less
    the splits over other axes), int8 or in the gradient's dtype."""
    dp = math.prod(mesh.shape[a] for a in baxes)
    if dp < 2:
        return analysis.StepStats()
    total = 0.0
    for x in _leaves(state.params):
        split = math.prod(mesh.shape[a] for part in x.spec
                          for a in _axes(part) if a not in baxes)
        width = 1 if cfg.grad_compression == "int8" else torch.promote_types(
            x.tensor.dtype, torch.bfloat16).itemsize
        total += x.tensor.numel() / split * width
    ring = 2.0 * (dp - 1) / dp * total
    st = analysis.StepStats(collective_bytes=ring, collective_ops=1)
    st.collectives["all-reduce"] = ring
    st.top_collectives = [[ring, f"dp gradient sync over {baxes}"]]
    return st


def count_cell(cfg, shape: ShapeConfig, mesh, microbatches=None,
               memo: Optional[Dict] = None) -> Dict:
    """One device's step of the cell, counted on meta (see the module
    docstring): {"stats" (``StepStats``), "n_microbatches",
    "rows_per_device", "model_division", "bytes_per_device"}. ``memo``
    keeps the per-device counts between meshes."""
    memo = {} if memo is None else memo
    specs = steps.input_specs(cfg, shape, mesh, microbatches)
    train = shape.kind == "train"
    axis = 1 if train else 0
    batch = specs["batch"]
    baxes = _axes(batch["positions"].spec[axis])
    rows = batch["positions"].tensor.shape[axis] // math.prod(
        mesh.shape[a] for a in baxes)
    local = {k: _local(v, axis, rows, train) for k, v in batch.items()}
    inference = shape.kind == "decode"
    state, params = state_structs(cfg, mesh, inference=inference)
    # the 'model' axis splits the work where it splits weights and not
    # the batch; else it replicates it (extra_dp configs' prefill)
    tp = mesh.shape.get("model", 1) if "model" not in baxes and any(
        "model" in _axes(part) for x in _leaves(params)
        for part in x.spec) else 1
    plan = None
    if tp > 1:
        try:
            plan = TP.counting_plan(cfg, mesh, inference=inference)
        except NotImplementedError:          # the ssm family (A11.9)
            plan = None
    div = tp if plan is None else 1
    n_mb = specs.get("n_microbatches", 1)
    out = {"n_microbatches": n_mb, "rows_per_device": rows,
           "model_division": div, "model_ranks": tp,
           "tensor_parallel": (SSM_DIVIDED if div > 1 else TENSOR_PARALLEL
                               if plan is not None else "none")}
    key = (cfg.name, shape.name, rows)

    def counted(fn, *args):
        """``count_step`` with the TP collectives metered in."""
        with TP.metering() as rec:
            st, res = analysis.count_step(fn, *args)
        for kind in ("all-reduce", "all-gather"):
            if rec[kind]:
                st.collectives[kind] += rec[kind]
                st.collective_bytes += rec[kind]
                st.top_collectives.append(
                    [rec[kind], f"tensor-parallel {kind} over 'model'"])
        st.collective_ops += rec["calls"]
        return st, res

    if train:
        if key not in memo:
            live = meta_state(cfg, plan)
            grad_step = steps.make_grad_step(
                cfg, None, ShapeConfig(shape.name, shape.seq_len, rows,
                                       "train"), microbatches=1)
            mb, (grads, _, _) = counted(grad_step, live, local)
            lr = torch.empty((), dtype=torch.float32, device="meta")
            adam, _ = analysis.count_step(steps.apply_grads, cfg, live,
                                          grads, lr)
            memo[key] = (mb, adam, tree_bytes(live.params))
        mb, adam, held = memo[key]
        share = bytes_per_device(state.params, mesh) / held
        stats = (mb.scaled(n_mb / div, n_mb) + adam.scaled(share)
                 + _sync_stats(cfg, state, baxes, mesh))
        nbytes = {"params": bytes_per_device(state.params, mesh),
                  "opt": bytes_per_device(state.opt, mesh),
                  "err": bytes_per_device(state.err, mesh),
                  "inputs": bytes_per_device(batch, mesh)}
    else:
        if key not in memo:
            p = TP.shard_params(tensors(params), plan)
            if shape.kind == "prefill":
                memo[key], _ = counted(serving.prefill, p, local, cfg)
            else:
                cache = serving.init_cache(cfg, rows, shape.seq_len,
                                           device="meta", plan=plan)
                memo[key], _ = counted(serving.decode_step, p, local, cache,
                                       cfg)
        stats = memo[key].scaled(1.0 / div)
        nbytes = {"params": bytes_per_device(params, mesh),
                  "inputs": bytes_per_device(specs, mesh)}
    nbytes["total"] = sum(nbytes.values())
    out.update(stats=stats, bytes_per_device=nbytes)
    return out


def run_cell(arch: str, shape: ShapeConfig, mesh_name: str, outdir: Path,
             force: bool = False, memo: Optional[Dict] = None) -> dict:
    """Count one cell and write its record to
    ``outdir/<arch>__<shape>__<mesh>.json`` (an existing one is read
    back unless ``force``)."""
    out = Path(outdir) / f"{arch}__{shape.name}__{mesh_name}.json"
    if out.exists() and not force:
        return json.loads(out.read_text())
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
    chips = mesh.size
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
           "chips": chips, "kind": shape.kind,
           "params": cfg.param_counts()}
    if cfg.pad_heads_to > cfg.num_heads:
        cfg = cfg.replace(pad_heads_to=0)
        rec["reduced"] = PADDED
    t0 = time.time()
    try:
        cell = count_cell(cfg, shape, mesh, memo=memo)
        rec["count_s"] = round(time.time() - t0, 2)
        if shape.kind == "train":
            rec["n_microbatches"] = cell["n_microbatches"]
        rec["rows_per_device"] = cell["rows_per_device"]
        rec["model_division"] = cell["model_division"]
        rec["model_ranks"] = cell["model_ranks"]
        rec["tensor_parallel"] = cell["tensor_parallel"]
        rec["bytes_per_device"] = cell["bytes_per_device"]
        rec["step_stats"] = cell["stats"].to_dict()
        rec["roofline"] = analysis.roofline(
            cell["stats"], chips=chips,
            model_flops_global=analysis.model_flops(cfg, shape),
            ideal_bytes_per_dev=analysis.ideal_bytes(
                cfg, shape, chips, cell["n_microbatches"]))
        rec["ok"] = True
    except Exception as e:
        rec["count_s"] = round(time.time() - t0, 2)
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCH_NAMES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    n_ok = n_fail = 0
    for arch in archs:
        for shape in applicable_shapes(get_config(arch)):
            if args.shape and shape.name != args.shape:
                continue
            memo: Dict = {}
            for mesh_name in meshes:
                rec = run_cell(arch, shape, mesh_name, outdir, args.force,
                               memo)
                ok = rec.get("ok")
                n_ok += bool(ok)
                n_fail += not ok
                r = rec.get("roofline", {})
                # counted FLOPs over the model's, and argument GB a device
                ratio = (rec["step_stats"]["flops"] * rec["chips"]
                         / r["model_flops_global"]) if ok else 0.0
                gb = rec["bytes_per_device"]["total"] / 1e9 if ok else 0.0
                print(f"{arch:24s} {shape.name:12s} {mesh_name:6s} "
                      f"ok={str(bool(ok)):5s} t={rec.get('count_s', '-'):>7}s "
                      f"dom={r.get('dominant', '-'):10s} "
                      f"cmp={r.get('compute_s', 0):.3e} "
                      f"mem={r.get('memory_s', 0):.3e} "
                      f"col={r.get('collective_s', 0):.3e} "
                      f"flops/model={ratio:.3f} gb={gb:.3f}", flush=True)
                if not ok:
                    print("   ERROR:", rec.get("error"), flush=True)
    print(f"\ndone: {n_ok} ok, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
