#!/usr/bin/env python3
"""Data-parallel LM training on distinct cards against one card repeated.

  python3 tools/dp_cards.py [--steps 3]

Needs at least two CUDA cards (four for the pod case).
The port's mesh is single-process (``launch/mesh.py``): ``[cuda:0,
cuda:1]`` puts rank 1's rows, parameter copy, error row and ring
messages on the second card, where ``[cuda:0, cuda:0]`` keeps them all on
one. The results must not depend on that, so this tool checks, bitwise:

* ``optim/compression.py``'s ring at n = 2 and 3 on distinct cards, and
  ``compressed_mean`` at pod 2 x data 2 on four, against the CPU (the
  reference test's inputs, seed 0, 8 x 1000);
* deepseek-7b's smoke config, int8, data 2, ``--steps`` train steps on
  ``[cuda:0, cuda:1]`` against ``[cuda:0, cuda:0]`` (loss, every
  parameter, every error row, each row on its rank's card);

then times musicgen-medium at its published config with int8 at data 2
on ``[cuda:0, cuda:1]`` and on ``[cuda:0, cuda:0]`` (8 x 2048 in 2
microbatches, chip_smoke.py's phase dp_train; the first step is warm-up,
the rest timed on the host clock, synchronized on every card), with each
card's peak memory, and checks the two layouts' losses bitwise. Only
int8 steps are compared: an uncompressed step runs the reference's
global step on the mesh's first card (``models/steps.py``).

The card's nvidia-smi name and power limit are printed first; the last
line is one JSON object with every number.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("dp_cards: FAIL: needs at least two CUDA cards",
              file=sys.stderr)
        return 3
    import chip_smoke
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import steps
    from repro_torch.optim import adamw, compression

    card = chip_smoke.card_line()
    print(f"nvidia-smi: {card}", flush=True)
    n_cards = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    _build.build_all(["flash_attention", "flash_attention_tc",
                      "flash_attention_bwd", "flash_attention_bwd_tc"])
    out = {"cards": n_cards, "card": card}

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    # the ring on distinct cards against the CPU
    xs = np.random.default_rng(0).normal(size=(8, 1000)).astype(np.float32)
    cases = [(n, ("data",), (n,)) for n in (2, 3) if n <= n_cards]
    if n_cards >= 4:
        cases.append((4, ("pod", "data"), (2, 2)))
    for n, axes, sizes in cases:
        cpu = compression.compressed_mean(
            [torch.from_numpy(x.copy()) for x in xs[:n]], axes, sizes)
        got = compression.compressed_mean(
            [torch.from_numpy(x.copy()).to(d) for x, d in
             zip(xs[:n], cards)], axes, sizes)
        ok = all(g.device == d and torch.equal(g.cpu(), c)
                 for g, c, d in zip(got, cpu, cards))
        out[f"ring {sizes}"] = ok
        chip_smoke.check(ok, f"the ring {dict(zip(axes, sizes))} on distinct "
                             f"cards is not the CPU's")

    def run(cfg, devices, axes, seq, batch, n_steps):
        shape = ShapeConfig("cards", seq, batch, "train")
        mesh = mesh_lib.make_mesh(axes, ("data", "model"), devices=devices)
        data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=seq, global_batch=batch,
                                        microbatches=2), cfg)
        state = steps.init_state(cfg, seed=0, mesh=mesh)
        step = steps.make_train_step(cfg, mesh, shape, 2, total_steps=100)
        losses, walls = [], []
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        for i in range(n_steps):
            batch_i = data.device_batch(i, mesh.first_device)
            sync()
            t0 = time.perf_counter()
            state, m = step(state, batch_i, i)
            sync()
            walls.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        peaks = [torch.cuda.max_memory_allocated(d) / 1e9 for d in cards]
        return state, losses, walls, peaks

    def same(a, b):
        return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(
            adamw.tree_leaves(a.params) + a.err,
            adamw.tree_leaves(b.params) + b.err))

    int8 = smoke_config("deepseek-7b").replace(grad_compression="int8")
    two, one = cards[:2], [cards[0]] * 2
    s2, l2, _, _ = run(int8, two, (2, 1), 64, 8, args.steps)
    s1, l1, _, _ = run(int8, one, (2, 1), 64, 8, args.steps)
    ok = l2 == l1 and same(s2, s1) and [e.device for e in s2.err] == two
    out["smoke int8 data 2"] = ok
    chip_smoke.check(ok, "deepseek smoke int8 on [cuda:0, cuda:1] is not "
                         "bitwise [cuda:0, cuda:0]")
    del s2, s1
    print(f"bitwise: {out}", flush=True)

    big = get_config("musicgen-medium").replace(grad_compression="int8")
    timing = {}
    for name, devices in (("[cuda:0, cuda:1]", two),
                          ("[cuda:0, cuda:0]", one)):
        state, losses, walls, peaks = run(big, devices, (2, 1), 2048, 8,
                                          args.steps + 1)
        timing[name] = {"losses": losses, "step_s": walls,
                        "warm_step_s": min(walls[1:]),
                        "tokens_per_s": 8 * 2048 / min(walls[1:]),
                        "peak_gb": peaks}
        print(f"musicgen-medium int8 data 2 on {name}: s/step "
              + ", ".join(f"{w:.3f}" for w in walls)
              + f"; warm {min(walls[1:]):.3f} s "
              f"({8 * 2048 / min(walls[1:]):.0f} tokens/s); peak GB by card "
              + ", ".join(f"{p:.2f}" for p in peaks) + f" ({card})",
              flush=True)
        del state
        torch.cuda.empty_cache()
    ok = (timing["[cuda:0, cuda:1]"]["losses"]
          == timing["[cuda:0, cuda:0]"]["losses"])
    chip_smoke.check(ok, "musicgen-medium int8 losses differ between the "
                         "two layouts")
    out["musicgen-medium int8 data 2"] = timing
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
