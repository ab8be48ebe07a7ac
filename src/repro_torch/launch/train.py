"""Search launcher: the paper's in-training ADC optimization on the card.
Counterpart of the ``--adc-search`` path of ``repro/launch/train.py``;
reports per-generation wall time and individuals/s.

  # on the card (default --device cuda):
  PYTHONPATH=src python -m repro_torch.launch.train --adc-search \\
      --dataset cardio --bits 4 --pop 16 --generations 4 --train-steps 100
  # the same through the plain PyTorch versions on the CPU:
  ... --device cpu

Add ``--export-front`` to freeze the searched Pareto front into deployable
classifier artifacts under <ckpt-dir>/front, servable by
``repro_torch.launch.serve_classifier`` (and by the JAX package's).

The reference's LM training (``--arch``), robustness (``--mc-samples``,
``--nonideal-sigma``, ``--fault-rate``, ``--range-drift``), fault
tolerance (``--faulttol``), the sharded and gradient engines,
``--screen-factor`` and ``--resume`` belong to later slices; they are
accepted here only to fail with the ROADMAP item that ports them.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from pathlib import Path

import numpy as np

_LATER = {
    "arch": "--arch (LM training, ROADMAP A11)",
    "nonideal": "--mc-samples/--nonideal-sigma/--fault-rate/--range-drift "
                "(the robustness objective, ROADMAP A5)",
    "faulttol": "--faulttol (fault-tolerant co-search, ROADMAP A6)",
    "screen": "--screen-factor (surrogate screening, ROADMAP A7)",
    "resume": "--resume (search checkpoint/resume, ROADMAP A3)",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="In-training ADC search through the PyTorch/CUDA port.")
    ap.add_argument("--adc-search", action="store_true",
                    help="run the paper's in-training ADC optimization")
    ap.add_argument("--dataset", default="seeds")
    ap.add_argument("--bits", type=int, default=3)
    ap.add_argument("--pop", type=int, default=16)
    ap.add_argument("--generations", type=int, default=4)
    ap.add_argument("--train-steps", type=int, default=100)
    ap.add_argument("--engine", default="batched",
                    choices=("batched", "reference"))
    ap.add_argument("--model", default="mlp", choices=("mlp", "svm"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"),
                    help="--export-front writes the front to "
                         "<ckpt-dir>/front")
    ap.add_argument("--export-front", action="store_true",
                    help="freeze the Pareto front into deployable "
                         "classifiers (baked value tables + po2 weights + "
                         "area) under <ckpt-dir>/front")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the hand-written kernels; cpu: their plain "
                         "PyTorch versions")
    # reference options of later slices: accepted only to be refused
    ap.add_argument("--arch")
    ap.add_argument("--mc-samples", type=int, default=0)
    ap.add_argument("--nonideal-sigma", type=float, default=0.0)
    ap.add_argument("--fault-rate", type=float, default=0.0)
    ap.add_argument("--range-drift", type=float, default=0.0)
    ap.add_argument("--faulttol", action="store_true")
    ap.add_argument("--screen-factor", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    return ap


def run_adc_search(args) -> np.ndarray:
    """Drive the batched (or reference) search on the chosen device, one
    population evaluation per generation, timed through the evolve log
    hook. Returns the Pareto fitness."""
    from repro_torch.core import area, search
    from repro_torch.core.spec import AdcSpec
    from repro_torch.data import tabular
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    spec = tabular.SPECS[args.dataset]
    data = tabular.make_dataset(args.dataset)
    sizes = (spec.features, spec.hidden, spec.classes)
    adc_spec = AdcSpec(bits=args.bits)
    cfg = search.SearchConfig.for_spec(
        adc_spec, pop_size=args.pop, generations=args.generations,
        train_steps=args.train_steps, engine=args.engine, model=args.model,
        seed=args.seed)
    print(f"adc-search[repro_torch {cfg.engine} {cfg.model}] "
          f"dataset={args.dataset} adc=({adc_spec.describe()}) "
          f"pop={cfg.pop_size} gens={cfg.generations} "
          f"qat-steps={cfg.train_steps} device={dev}")
    marks = [time.perf_counter()]

    def log(g, pop, fit):
        marks.append(time.perf_counter())
        dt = marks[-1] - marks[-2]
        print(f"  gen {g:2d}: {dt:6.2f}s/gen "
              f"{cfg.pop_size / dt:7.1f} individuals/s  "
              f"best-acc {1 - fit[:, 0].min():.3f}  "
              f"min-area {fit[:, 1].min():.3f}", flush=True)

    out = search.run_search(data, sizes, cfg, log=log,
                            return_trained=args.export_front, device=dev)
    pg, pf = out[0], out[1]
    gen_s = [b - a for a, b in zip(marks[:-1], marks[1:])]
    if gen_s:
        # the first interval also holds the initial population's
        # evaluation and the kernel build; steady state is the tail
        steady = gen_s[1:] or gen_s
        print(f"pareto points: {len(pf)}; per-generation "
              f"{sum(steady) / len(steady):.2f}s steady "
              f"({cfg.pop_size * len(steady) / sum(steady):.1f} "
              f"individuals/s), {gen_s[0]:.2f}s first (incl. the initial "
              f"population)")
    else:
        print(f"pareto points: {len(pf)} (initial population only, no "
              f"generations evolved)")
    flash = area.flash_full_tc(cfg.bits) * sizes[0]
    for f in pf[np.argsort(pf[:, 0])]:
        print(f"  acc={1 - f[0]:.3f}  area={f[1] * flash:.0f}T "
              f"(norm {f[1]:.3f})")
    if args.export_front:
        from repro_torch.core import deploy
        front_dir = Path(args.ckpt_dir) / "front"
        designs = deploy.export_front(pg, data, sizes, cfg, trained=out[3],
                                      device=dev)
        deploy.save_front(front_dir, designs,
                          extra_meta={"dataset": args.dataset,
                                      "sizes": list(sizes)})
        print(f"exported {len(designs)} deployed design(s) -> {front_dir}")
        for i, d in enumerate(designs):
            print(f"  design {i}: acc={d.accuracy:.3f}  area={d.area_tc}T  "
                  f"dp={int(d.dp)}  kept-levels="
                  f"{int(d.mask.sum())}/{d.mask.size}")
        print(f"serve it:  PYTHONPATH=src python -m repro_torch.launch."
              f"serve_classifier --front-dir {front_dir} --dataset "
              f"{args.dataset} --device {dev.type}")
    return pf


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    asked = {"arch": args.arch is not None,
             "nonideal": (args.mc_samples > 0 or args.nonideal_sigma > 0
                          or args.fault_rate > 0 or args.range_drift > 0),
             "faulttol": args.faulttol, "screen": args.screen_factor > 1,
             "resume": args.resume}
    for key, on in asked.items():
        if on:
            ap.error(f"{_LATER[key]} is not yet ported to repro_torch; use "
                     f"the JAX package (python -m repro.launch.train)")
    if not args.adc_search:
        ap.error("repro_torch.launch.train runs only --adc-search (LM "
                 "training is ROADMAP A11)")
    from repro_torch.device import resolve_device
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        ap.error(str(exc))
    return run_adc_search(args)


if __name__ == "__main__":
    main()
