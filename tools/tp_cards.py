#!/usr/bin/env python3
"""Tensor parallelism over four distinct cards: qwen2-vl-72b uncut served,
then training steps whose slices live on four cards.

  python3 tools/tp_cards.py [--gen 8]

Needs four CUDA cards.

Serving: the published config (80 layers, d_model 8192, 64 heads over 8
kv heads, d_ff 29568, vocab 152064), its weights in bf16 (145 GB: no
card holds the model), on a (1, 4) ('data', 'model') mesh of four
distinct cards: 16 heads, 2 kv heads and a quarter of every MLP and
vocab column a rank (``distributed/tensor_parallel.py``). The weights are
seeded and drawn a layer at a time (``transformer.init_params`` of the
one-layer config, seed 1000 + layer, split and copied into the ranks'
slices; the head and frontend from seed 0): a stacked leaf drawn whole
in float32 would not fit one card. A 2 x 2048 text prompt and 8 decode
steps through ``launch.serve.serve`` (twice; the second call is timed),
on ``[cuda:0, cuda:1, cuda:2, cuda:3]`` and then on the rotated layout
``[cuda:1, cuda:2, cuda:3, cuda:0]`` (each rank's slices moved to the
next card, a leaf at a time). Every logits array must be bitwise the
same in both layouts. Reports each card's peak memory, the flash
launches a prefill (one a layer a rank), prefill s and decode ms/token.

Training (``steps.init_state`` / ``make_train_step`` over the mesh, 2
steps each; the split state's slices, AdamW's per-device scalars, the
global norm's hops and, under int8, each group's gradients gathered and
split again all cross cards here):

* gemma2-2b (heads unpadded) uncut, 1 x 8192, at (1, 4) uncompressed,
  and cut to 8 layers at (2, 2) with int8 compression (2 x 4096, a group
  of two cards a dp rank, the second group's slices copied to its cards
  each step; each group's gradients gathered whole on its first card,
  which the uncut model's would not fit beside the state on one card):
  on the four cards against the same mesh on ``cuda:0`` repeated, whose
  semantics ``chip_smoke.py`` and the CPU tests hold to one device and
  to the reference. Losses, grad norms and every slice after the steps
  must be bitwise the same.
* qwen2-vl-72b at its published widths cut to 8 layers: 8.28 B float32
  parameters and AdamW moments, 99.3 GB (and 33 GB of gradients in a
  step), which no card holds; 1 x 2048 at (1, 4), on ``[cuda:0..3]``
  and on the rotated layout: bitwise across the two, the slices on all
  four cards, the loss finite and near log V.

Each case reports s/step, the cards holding slices and each card's
peak memory. The card's nvidia-smi name and power limit are printed
first; the last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

TP = 4
ROTATED = (1, 2, 3, 0)
TRAIN_STEPS = 2
# (name, arch, config changes, mesh shape, batch, seq, microbatches, int8)
GEMMA = (("gemma2-2b (1, 4)", "gemma2-2b", dict(pad_heads_to=0), (1, 4), 1,
          8192, 1, False),
         ("gemma2-2b 8 layers int8 (2, 2)", "gemma2-2b",
          dict(pad_heads_to=0, num_layers=8), (2, 2), 2, 4096, 1, True))
BIG = ("qwen2-vl-72b 8 layers (1, 4)", "qwen2-vl-72b", dict(num_layers=8),
       (1, TP), 1, 2048, 1, False)


def layerwise_params(torch, cfg, plan):
    """``cfg``'s parameters placed by ``plan``, drawn a layer at a time."""
    from repro_torch.distributed import tensor_parallel
    from repro_torch.models import transformer
    one = cfg.replace(num_layers=1)
    shapes = transformer.param_shapes(cfg)
    top = transformer.init_params(one, seed=0, device=plan.first)
    params = {k: tensor_parallel.place(v, plan.dims.get((k,)), plan)
              for k, v in top.items() if k != "layers"}
    del top

    def empty(path, shape):
        dtype = transformer.leaf_dtype(cfg, path)
        dim = plan.dims.get(path)
        if dim is None:
            return torch.empty(shape, dtype=dtype, device=plan.first)
        part = list(shape)
        part[dim] //= plan.tp
        return tensor_parallel.Shards(
            [torch.empty(part, dtype=dtype, device=d) for d in plan.devices],
            dim, plan.ranks, plan.tp)

    layers = {k: empty(("layers", k), s)
              for k, s in shapes["layers"].items()}
    for i in range(cfg.num_layers):
        drawn = transformer.init_params(one, seed=1000 + i,
                                        device=plan.first)["layers"]
        for k, leaf in layers.items():
            src = drawn[k][0]
            if isinstance(leaf, tensor_parallel.Shards):
                n = src.shape[leaf.dim - 1] // plan.tp
                for r, part in enumerate(leaf):
                    part[i].copy_(src.narrow(leaf.dim - 1, r * n, n))
            else:
                leaf[i].copy_(src)
        del drawn
    params["layers"] = layers
    return params


def rotate(torch, params, devices):
    """Each split leaf's slice j moved to ``devices[j]`` and each
    replicated leaf to ``devices[0]``, in place, a leaf at a time."""
    from repro_torch.distributed import tensor_parallel
    for node in (params, params["layers"]):
        for k, leaf in list(node.items()):
            if isinstance(leaf, dict):
                continue
            if isinstance(leaf, tensor_parallel.Shards):
                for j in range(len(leaf)):
                    leaf[j] = leaf[j].to(devices[j])
            else:
                node[k] = leaf.to(devices[0])
            torch.cuda.empty_cache()


def train_case(torch, case, devices):
    """``case`` trained TRAIN_STEPS steps over a mesh of ``devices``:
    (losses and grad norms, s/step, host copies of every slice, the
    cards holding slices, each card's peak GB, the state's GB)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import steps
    from repro_torch.optim import adamw
    _, arch, change, shape, b, s, n_mb, int8 = case
    cfg = get_config(arch).replace(
        **change, **({"grad_compression": "int8"} if int8 else {}))
    mesh = mesh_lib.make_mesh(shape, ("data", "model"), devices=devices)
    cards = [torch.device("cuda", i) for i in range(TP)]
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    state = steps.init_state(cfg, seed=0, mesh=mesh)
    step = steps.make_train_step(cfg, mesh, ShapeConfig("cards", s, b,
                                                        "train"), n_mb,
                                 total_steps=100)
    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                    global_batch=b, microbatches=n_mb), cfg)
    metrics, walls = [], []
    for i in range(TRAIN_STEPS):
        for d in cards:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        state, m = step(state, data.device_batch(i, mesh.first_device), i)
        for d in cards:
            torch.cuda.synchronize(d)
        walls.append(time.perf_counter() - t0)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    leaves = adamw.tree_leaves(state.params)
    state_gb = sum(t.numel() * t.element_size() for tree in (
        state.params, state.opt.m, state.opt.v)
        for t in adamw.tree_leaves(tree)) / 1e9
    homes = sorted({str(t.device) for t in leaves})
    snap = [t.cpu() for t in leaves]
    peak = [torch.cuda.max_memory_allocated(d) / 1e9 for d in cards]
    del state, step, leaves
    torch.cuda.empty_cache()
    return {"metrics": metrics, "step_s": walls, "homes": homes,
            "peak_gb_per_card": peak, "state_gb": state_gb,
            "vocab": cfg.vocab_size}, snap


def train_pair(torch, np, case, layouts):
    """``case`` on each of two device layouts: their records, and whether
    the losses, grad norms and slices are bitwise the same."""
    recs, snaps = {}, []
    for name, devices in layouts.items():
        rec, snap = train_case(torch, case, devices)
        recs[name] = rec
        snaps.append(snap)
        print(f"{case[0]} on {name}: losses / grad norms {rec['metrics']}, "
              f"s/step {[round(w, 3) for w in rec['step_s']]}, slices on "
              f"{rec['homes']}, state {rec['state_gb']:.2f} GB, peak GB a "
              f"card {[round(p, 2) for p in rec['peak_gb_per_card']]}",
              flush=True)
    a, b = list(recs.values())
    same = a["metrics"] == b["metrics"] and all(
        torch.equal(x, y) for x, y in zip(*snaps, strict=True))
    finite = all(np.isfinite(v) for r in recs.values()
                 for step in r["metrics"] for v in step)
    print(f"{case[0]}: bitwise across {list(layouts)}: {same}; "
          f"{len(snaps[0])} slices and leaves", flush=True)
    return {"layouts": recs, "bitwise": same, "finite": finite}


def train_runs(torch, np):
    """The training cases (see the module docstring)."""
    cards = [torch.device("cuda", i) for i in range(TP)]
    one = [cards[0]] * TP
    out = {}
    for case in GEMMA:
        out[case[0]] = train_pair(torch, np, case, {
            "cuda:0..3": cards, "cuda:0 repeated": one})
    big = train_pair(torch, np, BIG, {
        "cuda:0..3": cards, "rotated": [cards[i] for i in ROTATED]})
    rec = big["layouts"]["cuda:0..3"]
    one_card = torch.cuda.get_device_properties(0).total_memory / 1e9
    big["one_card_gb"] = one_card
    big["loss_near_log_v"] = all(
        abs(r["metrics"][0][0] - np.log(r["vocab"])) <= 1.5
        for r in big["layouts"].values())
    print(f"{BIG[0]}: parameters and AdamW moments {rec['state_gb']:.2f} "
          f"GB against one card's {one_card:.2f} GB; first loss "
          f"{rec['metrics'][0][0]:.4f} (log V {np.log(rec['vocab']):.4f})",
          flush=True)
    out[BIG[0]] = big
    ok = all(r["bitwise"] and r["finite"] for r in out.values()) and (
        big["loss_near_log_v"] and rec["state_gb"] > one_card
        and all(len(r["homes"]) == TP for r in big["layouts"].values()))
    return out, ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gen", type=int, default=8)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < TP:
        print(f"tp_cards: FAIL: needs {TP} CUDA cards", file=sys.stderr)
        return 3
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel
    from repro_torch.kernels import _build, flash_attention
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve
    from repro_torch.models import serving

    card = chip_smoke.card_line()
    print(f"nvidia-smi: {card}", flush=True)
    _build.build_all(["flash_attention_tc", "flash_attention_bwd_tc"])
    cfg = get_config("qwen2-vl-72b").replace(param_dtype="bfloat16")
    chip_smoke.check_published(get_config("qwen2-vl-72b"))
    devs = [torch.device("cuda", i) for i in range(TP)]
    mesh = mesh_lib.make_mesh((1, TP), ("data", "model"), devices=devs)
    plan = serving.serving_plan(cfg, mesh)
    t0 = time.perf_counter()
    params = layerwise_params(torch, cfg, plan)
    for d in devs:
        torch.cuda.synchronize(d)
    init_s = time.perf_counter() - t0
    per_rank = tensor_parallel.weight_bytes(params)
    gb = [round(x / 1e9, 2) for x in per_rank]
    print(f"{cfg.name} uncut ({cfg.num_layers} layers), bf16 weights: "
          f"{sum(per_rank) / 1e9:.2f} GB, a rank {gb} GB, drawn in "
          f"{init_s:.1f} s; {cfg.num_heads // TP} heads and "
          f"{len(plan.kv_heads(0))} kv heads a rank", flush=True)
    layouts = {"cuda:0..3": list(range(TP)), "rotated": list(ROTATED)}
    out = {"card": card, "layers": cfg.num_layers, "init_s": init_s,
           "weight_bytes_per_rank": per_rank, "layouts": {}}
    logits = {}
    for name, order in layouts.items():
        ds = [devs[i] for i in order]
        if name != "cuda:0..3":
            rotate(torch, params, ds)
        m = mesh_lib.make_mesh((1, TP), ("data", "model"), devices=ds)
        for d in devs:
            torch.cuda.reset_peak_memory_stats(d)
        runs = []
        for _ in range(2):
            flash_attention.reset_launches()
            runs.append(serve.serve(cfg, params, requests=2,
                                    prompt_len=2048, gen=args.gen,
                                    device=ds[0], seed=0, mesh=m)[1])
        info = runs[1]
        logits[name] = info["logits"]
        peak = [torch.cuda.max_memory_allocated(d) / 1e9 for d in devs]
        rec = {"devices": [str(d) for d in ds],
               "prefill_s": info["prefill_s"],
               "prefill_s_first": runs[0]["prefill_s"],
               "decode_ms_per_token": info["decode_ms_per_token"],
               "prefill_flash_launches": info["prefill_flash_launches"],
               "peak_gb_per_card": peak,
               "finite": all(bool(np.isfinite(lg).all())
                             for lg in info["logits"])}
        out["layouts"][name] = rec
        print(f"{name} {rec['devices']}: prefill {rec['prefill_s']:.4f} s "
              f"(first {rec['prefill_s_first']:.4f}), decode "
              f"{rec['decode_ms_per_token']:.2f} ms/token, "
              f"{rec['prefill_flash_launches']} flash launches a prefill, "
              f"peak GB a card {[round(p, 2) for p in peak]}", flush=True)
    same = all(np.array_equal(a, b) for a, b in zip(
        logits["cuda:0..3"], logits["rotated"], strict=True))
    ok = (same and all(r["finite"] for r in out["layouts"].values())
          and all(r["prefill_flash_launches"] == TP * cfg.num_layers
                  for r in out["layouts"].values()))
    out.update(bitwise_across_layouts=same)
    print(f"logits bitwise across the layouts: {same}", flush=True)
    del params
    torch.cuda.empty_cache()
    out["train"], train_ok = train_runs(torch, np)
    out["ok"] = ok = ok and train_ok
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
