#!/usr/bin/env python3
"""The gate train's table lookup on one card: one-hot product or gather.

  python3 tools/lookup_backward_ab.py [--runs 5]

The gradient engine's lane loss reads ``tab[l, c, code[m, c]]`` for every
lane, channel and training row. ``core.grad_gates.lane_losses`` does it
as a batched product of the fixed one-hot codes (C, M, 2^N) with the
lane tables (C, 2^N, L); a ``torch.gather`` gives the same forward, but
its backward is a ``scatter_add_`` of float atomics. This tool builds
the two forms at the chip smoke's gradient MLP shape (cardio, 4-bit tree
ADC, 32 lanes, the seeded ``init_lanes`` start), takes the backward to
the gate logits ``--runs`` times on the same inputs for each form, and
prints whether each form's gradients are bitwise equal across runs, the
largest difference between runs, and each form's forward + backward time
(CUDA events, 50 calls after warm-up).

The card's nvidia-smi name and power limit are printed first; the last
line is one JSON object with every number. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lookup_backward_ab: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3
    from chip_smoke import DATASET, GRADIENT_CUTS, SEARCH, card_line, cuda_ms
    from repro_torch.core import grad_gates, search
    from repro_torch.data import tabular
    from repro_torch.device import resolve_device

    card = card_line()
    print(f"nvidia-smi: {card}")
    dev = resolve_device("cuda")
    spec = tabular.SPECS[DATASET]
    sizes = (spec.features, spec.hidden, spec.classes)
    cfg = search.SearchConfig(model="mlp", engine="gradient", **SEARCH,
                              **GRADIENT_CUTS["mlp"])
    data = tabular.make_dataset(DATASET)
    lanes = cfg.grad_points
    state = grad_gates.init_lanes(sizes, cfg, lanes, dev)
    onehot, _, values = grad_gates.train_inputs(data, sizes, cfg, dev)
    codes = onehot.argmax(-1).T                                  # (M, C)
    tau = grad_gates.tau_schedule(cfg, 2)[0].to(dev)
    weight = torch.randn(codes.shape, generator=torch.Generator(
        ).manual_seed(0)).to(dev)

    def grad(form):
        logits = state.logits.clone().requires_grad_(True)
        tab = grad_gates.soft_value_table(
            grad_gates.gate_soft(logits, tau), values, cfg.grad_beta)
        if form == "product":
            xq = torch.bmm(onehot, tab.permute(1, 2, 0)).permute(2, 1, 0)
        else:
            idx = codes.expand(tab.shape[0], -1, -1)
            xq = torch.gather(tab.transpose(1, 2), 1, idx)
        return torch.autograd.grad((xq.sin() * weight).sum(), logits)[0]

    result = {"card": card, "lanes": lanes, "shape_onehot":
              list(onehot.shape), "runs": args.runs, "forms": {}}
    for form in ("product", "gather"):
        runs = [grad(form) for _ in range(args.runs)]
        spread = max(float((r - runs[0]).abs().max()) for r in runs)
        row = {"bitwise_equal": all(torch.equal(runs[0], r)
                                    for r in runs[1:]),
               "max_abs_spread": spread,
               "ms": cuda_ms(torch, lambda: grad(form), 50)}
        result["forms"][form] = row
        print(f"{form}: {args.runs} backward runs on the same inputs, "
              f"bitwise equal {row['bitwise_equal']}, largest difference "
              f"{spread!r}; forward + backward {row['ms']:.4f} ms on {card}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
