"""Training launcher of the port: the paper's in-training ADC
optimization (``--adc-search``) and LM training (``--arch``), on the card.
Counterpart of ``repro/launch/train.py``.

LM training, the dense, audio, vlm, moe, ssm and hybrid families
(deepseek-7b, phi3-mini-3.8b, yi-34b, gemma2-2b, musicgen-medium,
qwen2-vl-72b, kimi-k2-1t-a32b, llama4-scout-17b-a16e, mamba2-1.3b,
hymba-1.5b), with the reference's microbatched AdamW step, schedule,
synthetic corpus and checkpoint/restart loop:

  PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-medium \
      --smoke --steps 12 --batch 2 --seq 32 --ckpt-dir /tmp/lm_ckpt
  # the plain PyTorch versions on the CPU: ... --device cpu
  # a moe smoke config: --arch kimi-k2-1t-a32b --smoke ...
  # the ssm and hybrid families: --arch mamba2-1.3b / hymba-1.5b ...
  # local_global and M-RoPE: --arch gemma2-2b / qwen2-vl-72b ...
  # tensor parallel over 'model' (every family but the extra_dp configs):
  # --model-ax 2, a (1, 2) mesh of the first two visible cards (fewer
  # raise); --device cuda:0 runs both ranks on that card, and on the
  # CPU the device repeats

It prints the reference's log lines and fails if the loss did not
improve. Published configs that pad their heads (yi-34b, gemma2-2b,
llama4-scout: ``pad_heads_to``, ROADMAP C) are refused with ROADMAP C
named; their ``--smoke`` configs run.

The search reports per-generation wall time and individuals/s:

  # on the card (default --device cuda):
  PYTHONPATH=src python -m repro_torch.launch.train --adc-search \\
      --dataset cardio --bits 4 --pop 16 --generations 4 --train-steps 100
  # the same through the plain PyTorch versions on the CPU:
  ... --device cpu

Add ``--export-front`` to freeze the searched Pareto front into deployable
classifier artifacts under <ckpt-dir>/front, servable by
``repro_torch.launch.serve_classifier`` (and by the JAX package's).

``--vmin``/``--vmax`` take a scalar range or per-channel comma lists;
``--auto-range`` (``--auto-range-pct``) derives per-channel ranges from
the training data's percentiles (``AdcSpec.from_data``).

``--mc-samples S`` with a non-ideality knob (``--nonideal-sigma``,
``--fault-rate``, ``--range-drift``; ``--nonideal-seed`` names the draw
stream) adds the Monte-Carlo robustness objective
(``--robust-objective expected|worst|yield``, ``--yield-margin``);
``--faulttol`` (``--max-spares``) adds the fault-tolerance genome. With
``--export-front`` the robustness report of the exported front is
written next to it as ``robustness.json`` (yield at ``--yield-margins``).

``--engine sharded`` splits each generation's population over
``search.default_search_mesh(--device)``: every visible card (one entry
on the CPU), fitness bitwise the batched engine's. ``--engine gradient``
trains one family of gated designs and re-scores its snapped genomes
exactly (one timing line, no generations);
``--screen-factor K`` (K > 1) oversamples each generation's offspring K
times and lets the online surrogate pick which are evaluated.

The search state is saved after every generation (the gradient engine:
after every gate-train chunk) under <ckpt-dir>/adc_search, keeping the
two newest steps; ``--resume`` restarts a killed run from the latest one,
bit-identically. A run without ``--resume`` deletes that directory
first, so a stale step cannot hijack a later resume.

``build`` and ``main`` are the LM path's entry points.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.device import device_arg
    ap = argparse.ArgumentParser(
        description="LM training and the in-training ADC search through "
                    "the PyTorch/CUDA port.")
    ap.add_argument("--arch", help="LM architecture (required unless "
                                   "--adc-search)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--model-ax", type=int, default=1,
                    help="LM training: the mesh's 'model' axis (tensor "
                         "parallelism over a (1, N) mesh of the first N "
                         "visible cards, or of one device repeated: "
                         "--device cuda:N or cpu)")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--adc-search", action="store_true",
                    help="run the paper's in-training ADC optimization "
                         "instead of LM training")
    ap.add_argument("--dataset", default="seeds")
    ap.add_argument("--bits", type=int, default=3)
    ap.add_argument("--vmin", default="0.0",
                    help="analog range minimum: scalar, or comma-separated "
                         "per-channel list (heterogeneous sensors)")
    ap.add_argument("--vmax", default="1.0",
                    help="analog range maximum (same forms as --vmin)")
    ap.add_argument("--auto-range", action="store_true",
                    help="derive per-channel vmin/vmax from the training "
                         "data's percentiles (AdcSpec.from_data) instead "
                         "of --vmin/--vmax — heterogeneous sensors "
                         "without hand-typed comma lists")
    ap.add_argument("--auto-range-pct", type=float, default=0.5,
                    help="percentile clip for --auto-range: range covers "
                         "[pct, 100-pct] of each channel's distribution")
    ap.add_argument("--pop", type=int, default=16)
    ap.add_argument("--generations", type=int, default=4)
    ap.add_argument("--train-steps", type=int, default=100)
    ap.add_argument("--engine", default="batched",
                    choices=("batched", "sharded", "reference",
                             "gradient"),
                    help="'sharded': the population split over every "
                         "visible device of --device's type; 'gradient': "
                         "one gate-logit train sweeps the accuracy/area "
                         "family, then re-scores through the exact "
                         "batched path")
    ap.add_argument("--screen-factor", type=int, default=1,
                    help="surrogate-screened NSGA-II: oversample "
                         "offspring by this factor and let the online "
                         "fitness predictor pick which pay the exact QAT "
                         "evaluation (1 = off)")
    ap.add_argument("--resume", action="store_true",
                    help="restart the search from its latest checkpoint "
                         "under <ckpt-dir>/adc_search (bit-identical "
                         "continuation)")
    ap.add_argument("--model", default="mlp", choices=("mlp", "svm"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"),
                    help="LM checkpoints go to <ckpt-dir>, search "
                         "checkpoints to <ckpt-dir>/adc_search, "
                         "--export-front writes the front to "
                         "<ckpt-dir>/front")
    ap.add_argument("--export-front", action="store_true",
                    help="freeze the Pareto front into deployable "
                         "classifiers (baked value tables + po2 weights + "
                         "area) under <ckpt-dir>/front")
    ap.add_argument("--device", type=device_arg, default="cuda",
                    help="cuda (cuda:N: that card alone): the hand-written "
                         "kernels; cpu: their plain PyTorch versions")
    ap.add_argument("--mc-samples", type=int, default=0,
                    help="Monte-Carlo instances per design for the "
                         "robustness objective (0 disables)")
    ap.add_argument("--nonideal-sigma", type=float, default=0.0,
                    help="per-comparator input-referred offset sigma, "
                         "in LSBs")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="stuck-at-0/1 probability per surviving "
                         "comparator")
    ap.add_argument("--range-drift", type=float, default=0.0,
                    help="reference-ladder drift sigma, as a fraction "
                         "of each channel's full scale")
    ap.add_argument("--nonideal-seed", type=int, default=0,
                    help="MC draw stream seed (NonIdealSpec.seed)")
    ap.add_argument("--robust-objective", default="expected",
                    choices=("expected", "worst", "yield"),
                    help="third objective: expected accuracy drop, "
                         "worst-case error, or 1 - yield@margin over the "
                         "MC instances")
    ap.add_argument("--yield-margin", type=float, default=0.01,
                    help="accuracy-drop margin of the 'yield' objective")
    ap.add_argument("--yield-margins", default="0.01,0.05",
                    help="comma list of margins the exported robustness "
                         "report tabulates yield at (robustness.json)")
    ap.add_argument("--faulttol", action="store_true",
                    help="fault-tolerant search: per-channel TMR and "
                         "spare-level genes and a calibrate gene; needs "
                         "--mc-samples and a non-ideality knob")
    ap.add_argument("--max-spares", type=int, default=2,
                    help="per-channel spare-level gene range of "
                         "--faulttol (0 disables the spare action)")
    return ap


def arch_config(arch: str, smoke: bool):
    """The config of ``arch`` (its smoke config with ``smoke``); raises
    KeyError for an unknown name and NotImplementedError, naming the
    ROADMAP item, for a config the port refuses
    (``transformer.check_supported``)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import transformer
    cfg = smoke_config(arch) if smoke else get_config(arch)
    transformer.check_supported(cfg)
    return cfg


def build(arch: str, *, smoke: bool, seq: int, batch: int,
          microbatches: int, data_ax: int = 1, model_ax: int = 1,
          steps_total: int = 100, device=None):
    """(cfg, mesh, train_step, data) of an LM training run: the config,
    a ``make_host_mesh(data_ax, model_ax)`` on ``device`` (default: the
    first visible cards, raising where fewer are visible; ``cuda:N`` or
    the CPU: that one device repeated), the microbatched train step
    over ``steps_total`` steps of the schedule (data parallel over the
    mesh's dp ranks: with ``cfg.grad_compression`` int8 the ring, else
    FSDP, each data slice holding its pieces of the state; tensor
    parallel over 'model' where the parameter rules split weights over
    it; the state placed by ``steps.init_state(cfg, mesh=mesh)``:
    ``models/steps.py``), and the synthetic corpus at (batch, seq) split
    into ``microbatches``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import steps
    cfg = arch_config(arch, smoke)
    mesh = mesh_lib.make_host_mesh(data_ax, model_ax, device=device)
    shape = ShapeConfig("cli", seq, batch, "train")
    train_step = steps.make_train_step(cfg, mesh, shape,
                                       microbatches=microbatches,
                                       total_steps=steps_total)
    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch,
                                    microbatches=microbatches), cfg)
    return cfg, mesh, train_step, data


def run_lm_training(args):
    """Train ``args.arch`` for ``args.steps`` steps through
    ``fault.run_with_recovery`` (a checkpoint every ``--ckpt-every``
    steps and at the end, under ``--ckpt-dir``; a run finding a later
    step there resumes from it). Returns the per-step losses; raises
    AssertionError, as the reference does, when the last loss is not
    below the first."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import fault
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import steps

    cfg, mesh, train_step, data = build(
        args.arch, smoke=args.smoke, seq=args.seq, batch=args.batch,
        microbatches=args.microbatches, model_ax=args.model_ax,
        steps_total=args.steps, device=args.device)
    dev = mesh.first_device
    state = steps.init_state(cfg, seed=args.seed, mesh=mesh)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    print(f"train[repro_torch] arch={cfg.name} batch={args.batch} "
          f"seq={args.seq} microbatches={args.microbatches} "
          f"steps={args.steps} device={dev}"
          + (f" {mesh_lib.describe(mesh)}" if args.model_ax > 1 else ""),
          flush=True)
    losses = []

    def on_metrics(step, metrics):
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)

    t0 = time.time()
    state, info = fault.run_with_recovery(
        train_step, state, lambda i: data.device_batch(i, dev),
        num_steps=args.steps, ckpt=ckpt, ckpt_every=args.ckpt_every,
        on_metrics=on_metrics)
    dt = time.time() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({dt / max(args.steps, 1):.2f}s/step); "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; {info}")
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not improve")
    return losses


def parse_yield_margins(text: str):
    """'0.01,0.05' -> (0.01, 0.05): the accuracy-drop margins the exported
    robustness report tabulates yield at."""
    try:
        margins = tuple(float(t) for t in str(text).split(",") if t.strip())
    except ValueError:
        margins = ()
    if not margins or any(not 0.0 <= m < 1.0 for m in margins):
        raise ValueError(f"--yield-margins must be a comma list of "
                         f"fractions in [0, 1), got {text!r}")
    return margins


def adc_search_config(args, channels: int, data=None):
    """argv -> the search's (AdcSpec, SearchConfig) pair, with the
    reference's checks: ``--auto-range`` derives per-channel vmin/vmax
    from ``data["x_train"]`` (AdcSpec.from_data) and refuses an explicit
    --vmin/--vmax beside it or a missing dataset; the spec must drive
    ``channels`` sensor channels; a non-ideality knob needs
    --mc-samples, --mc-samples needs a knob, --faulttol needs both."""
    from repro_torch.core import search
    from repro_torch.core.nonideal import NonIdealSpec
    from repro_torch.core.spec import AdcSpec, parse_range
    from repro_torch.faulttol import FaultTolSpec

    if args.auto_range:
        if args.vmin != "0.0" or args.vmax != "1.0":
            raise ValueError(
                "--auto-range derives vmin/vmax from the training data; "
                "drop the explicit --vmin/--vmax (or drop --auto-range)")
        if data is None:
            raise ValueError("--auto-range needs the dataset to derive "
                             "ranges from")
        adc_spec = AdcSpec.from_data(data["x_train"], bits=args.bits,
                                     pct=args.auto_range_pct)
    else:
        adc_spec = AdcSpec(bits=args.bits, vmin=parse_range(args.vmin),
                           vmax=parse_range(args.vmax))
    adc_spec.validate_channels(channels)
    knobs = (args.nonideal_sigma > 0 or args.fault_rate > 0
             or args.range_drift > 0)
    if knobs and args.mc_samples <= 0:
        raise ValueError(
            "--nonideal-sigma/--fault-rate/--range-drift need "
            "--mc-samples > 0 to take effect; refusing to silently run "
            "an ideal-hardware search")
    if args.mc_samples > 0 and not knobs:
        raise ValueError(
            "--mc-samples without any non-ideality knob "
            "(--nonideal-sigma/--fault-rate/--range-drift) would "
            "Monte-Carlo ideal hardware; set at least one knob > 0")
    ni = ft = None
    if knobs:
        ni = NonIdealSpec(sigma_offset=args.nonideal_sigma,
                          sigma_range=args.range_drift,
                          fault_rate=args.fault_rate,
                          seed=args.nonideal_seed)
    if args.faulttol:
        if not knobs or args.mc_samples <= 0:
            raise ValueError(
                "--faulttol extends the robustness search; it needs "
                "--mc-samples > 0 and at least one non-ideality knob")
        ft = FaultTolSpec(max_spares=args.max_spares)
    parse_yield_margins(args.yield_margins)
    cfg = search.SearchConfig.for_spec(
        adc_spec, pop_size=args.pop, generations=args.generations,
        train_steps=args.train_steps, engine=args.engine, model=args.model,
        seed=args.seed, screen_factor=args.screen_factor, nonideal=ni,
        mc_samples=args.mc_samples if ni else 0,
        robust_objective=args.robust_objective,
        yield_margin=args.yield_margin, faulttol=ft)
    return adc_spec, cfg


def run_adc_search(args) -> np.ndarray:
    """Drive the search on the chosen device: one population evaluation
    per generation, timed through the evolve log hook (the gradient
    engine: one gate train and its exact re-score, timed whole). The
    search state is saved after every generation under
    <ckpt-dir>/adc_search; ``--resume`` restarts from the latest step.
    Returns the Pareto fitness."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import area, search
    from repro_torch.data import tabular
    from repro_torch.device import resolve_device
    from repro_torch.launch import mesh as mesh_lib

    dev = resolve_device(args.device)
    spec = tabular.SPECS[args.dataset]
    data = tabular.make_dataset(args.dataset)
    sizes = (spec.features, spec.hidden, spec.classes)
    adc_spec, cfg = adc_search_config(args, spec.features, data=data)
    mesh = (search.default_search_mesh(dev) if cfg.engine == "sharded"
            else None)
    ckpt_dir = Path(args.ckpt_dir) / "adc_search"
    if not args.resume and ckpt_dir.exists():
        # a fresh start: a stale higher-numbered step would outlive this
        # run's in the keep-N retention and hijack a later --resume
        shutil.rmtree(ckpt_dir)
    ckpt = CheckpointManager(ckpt_dir, keep=2)
    if args.resume and ckpt.latest_step() is not None:
        print(f"resuming from step {ckpt.latest_step()} ({ckpt.dir})")
    print(f"adc-search[repro_torch {cfg.engine} {cfg.model}] "
          f"dataset={args.dataset} adc=({adc_spec.describe()}) "
          f"pop={cfg.pop_size} gens={cfg.generations} "
          f"qat-steps={cfg.train_steps} device={dev}"
          + (f" {mesh_lib.describe(mesh)}" if mesh is not None else ""))
    if cfg.wants_robustness:
        margin = (f"@{cfg.yield_margin:g}"
                  if cfg.robust_objective == "yield" else "")
        print(f"  robustness objective [{cfg.robust_objective}{margin}] "
              f"over {cfg.mc_samples} MC instances: "
              f"{cfg.nonideal.describe()}")
    if cfg.faulttol is not None:
        print(f"  fault-tolerance genome: {cfg.faulttol.describe()} "
              f"(+{cfg.faulttol.gene_bits(sizes[0])} genes)")
    if cfg.screen_factor > 1:
        print(f"  surrogate screening: {cfg.screen_factor}x offspring, "
              f"{cfg.pop_size} evaluated per generation")
    marks = [time.perf_counter()]

    def log(g, pop, fit):
        marks.append(time.perf_counter())
        dt = marks[-1] - marks[-2]
        extra = (f"  best-robust {fit[:, 2].min():.3f}"
                 if fit.shape[1] > 2 else "")
        print(f"  gen {g:2d}: {dt:6.2f}s/gen "
              f"{cfg.pop_size / dt:7.1f} individuals/s  "
              f"best-acc {1 - fit[:, 0].min():.3f}  "
              f"min-area {fit[:, 1].min():.3f}{extra}", flush=True)

    out = search.run_search(data, sizes, cfg, log=log, ckpt=ckpt,
                            resume=args.resume,
                            return_trained=args.export_front, device=dev,
                            mesh=mesh)
    pg, pf = out[0], out[1]
    gen_s = [b - a for a, b in zip(marks[:-1], marks[1:])]
    if cfg.engine == "gradient":
        # one gate train and one exact re-score (and polish), no
        # generations
        total = marks[-1] - marks[0]
        print(f"pareto points: {len(pf)}; gate family + exact re-score "
              f"in {total:.2f}s ({cfg.pop_size / total:.1f} "
              f"individuals/s incl. the kernel build)")
    elif gen_s:
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
        if cfg.wants_robustness:
            # the report rides with the artifact: the same NonIdealSpec,
            # hence the same draw stream, as the search's third objective
            margins = parse_yield_margins(args.yield_margins)
            rep = deploy.evaluate_robustness(
                designs, cfg.nonideal, data["x_test"], data["y_test"],
                samples=cfg.mc_samples, yield_margins=margins, device=dev)
            deploy.save_robustness(front_dir, rep)
            for i, row in enumerate(rep["designs"]):
                ys = "  ".join(f"yield@{m:g} {row['yield'][f'{m:g}']:.2f}"
                               for m in margins)
                print(f"  design {i} robustness: mean "
                      f"{row['mean_accuracy']:.3f}  worst "
                      f"{row['worst_accuracy']:.3f}  {ys}")
            print(f"robustness report -> {front_dir}/robustness.json")
        print(f"serve it:  PYTHONPATH=src python -m repro_torch.launch."
              f"serve_classifier --front-dir {front_dir} --dataset "
              f"{args.dataset} --device {dev.type}")
    return pf


def main(argv=None):
    """The CLI."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.arch is not None:
        from repro_torch.device import resolve_device
        try:
            cfg = arch_config(args.arch, args.smoke)
            resolve_device(args.device)
            if args.model_ax > 1:
                from repro_torch.distributed import tensor_parallel
                from repro_torch.launch import mesh as mesh_lib
                tensor_parallel.tp_plan(cfg, mesh_lib.make_host_mesh(
                    1, args.model_ax, device=args.device))
        except (KeyError, NotImplementedError, RuntimeError,
                ValueError) as exc:
            ap.error(str(exc))
    if not args.adc_search:
        if args.arch is None:
            ap.error("--arch is required unless --adc-search is given")
        return run_lm_training(args)
    from repro_torch.data import tabular
    from repro_torch.device import resolve_device
    try:
        data = tabular.make_dataset(args.dataset) if args.auto_range else None
        adc_search_config(args, tabular.SPECS[args.dataset].features,
                          data=data)
        resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        ap.error(str(exc))
    return run_adc_search(args)


if __name__ == "__main__":
    main()
