"""Serving launcher for deployed ADC+classifier fronts, on the card.
Counterpart of ``repro/launch/serve_classifier.py`` (its ``--driver
batch`` path).

The fixed-microbatch loop drains a request list into ``--batch``-row
microbatches (a microbatch may span many small requests or a slice of one
large request; the tail is padded), pushes each through the *whole*
deployed front in one bank-kernel launch, and reports requests/s and
samples/s. Every response carries all D designs' predictions. After
serving, the front's served accuracies on the dataset's test split must
equal each design's exported accuracy exactly.

  # serve a front exported by either package, on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve_classifier \\
      --front-dir tests/fixtures/fronts/cardio_mlp --dataset cardio \\
      --requests 256 --request-size 8 --batch 1024
  # the same through the plain PyTorch versions on the CPU:
  ... --device cpu

``--nonideal-sigma/--fault-rate/--range-drift`` serve the front through
ONE sampled non-ideal hardware instance (instance ``--nonideal-instance``
of the ``--mc-samples``-sample stream of ``--nonideal-seed``) through the
Monte-Carlo kernel: the report prints served-vs-exported degradation per
design instead of the parity check, plus the yield over the instance
stream (``--yield-margins``). ``--calibrate`` re-bakes the front against
the sampled instance's measured non-idealities and serves through the
calibrated tables, printing the recovered accuracy per design.

``--smoke`` needs no front on disk: a tiny fixed-seed search of
``--dataset`` (2-bit ADC, pop 6, one generation, 30 QAT steps) is
exported and served, parity check included:

  PYTHONPATH=src python -m repro_torch.launch.serve_classifier --smoke \\
      --dataset seeds --device cpu

The reference's ``--driver async`` (with or without ``--calibrate``) and
``--sharded`` paths belong to a later slice of the port (ROADMAP A9);
they are accepted here only to fail with a clear message.
"""
from __future__ import annotations

import argparse
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import deploy
from repro_torch.device import DeviceLike, resolve_device


def make_request_stream(x: np.ndarray, num_requests: int, request_size: int,
                        seed: int = 0) -> List[Tuple[int, np.ndarray]]:
    """Synthetic client traffic: ``num_requests`` requests of
    ``request_size`` sample rows each, drawn (with replacement) from the
    dataset, deterministic under ``seed`` (the reference's stream)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(x), size=(num_requests, request_size))
    return [(rid, np.asarray(x[idx[rid]], np.float32))
            for rid in range(num_requests)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(designs: Sequence[deploy.DeployedClassifier],
          requests: Sequence[Tuple[int, np.ndarray]], batch: int, *,
          device: DeviceLike = None, bank_fn=None) -> Dict:
    """Drain ``requests`` through the bank in fixed ``batch``-row
    microbatches. Returns the throughput report plus per-request
    responses ``{rid: (D, n_rows) predicted classes}``. ``bank_fn``
    overrides the (M, C) -> (D, M, O) bank closure
    (deploy.make_bank_fn by default). Request rows are samples of the
    front's ``sample_shape``: (C,) rows, or raw (W, C_raw) windows for a
    feature-baked front."""
    dev = resolve_device(device)
    fn = bank_fn if bank_fn is not None else deploy.make_bank_fn(
        designs, device=dev)
    sample_shape = designs[0].sample_shape
    queue = deque(requests)
    carry: Optional[Tuple[int, np.ndarray]] = None
    responses: Dict[int, List[np.ndarray]] = {rid: [] for rid, _ in requests}
    total_rows = sum(len(x) for _, x in requests)
    batches = padded_rows = 0
    # warm-up on a dummy batch through the whole per-microbatch path (the
    # first CUDA call builds and loads the kernels), so the report times
    # serving only
    torch.argmax(fn(torch.zeros((batch,) + sample_shape,
                                dtype=torch.float32, device=dev)),
                 dim=-1).cpu()
    _sync(dev)
    t0 = time.perf_counter()
    while queue or carry:
        rows, meta, filled = [], [], 0
        while filled < batch and (queue or carry):
            rid, x = carry if carry is not None else queue.popleft()
            carry = None
            take = min(batch - filled, len(x))
            rows.append(x[:take])
            meta.append((rid, take))
            filled += take
            if take < len(x):
                carry = (rid, x[take:])
        xb = np.concatenate(rows, axis=0)
        pad = batch - len(xb)
        if pad:
            xb = np.pad(xb, ((0, pad),) + ((0, 0),) * len(sample_shape))
            padded_rows += pad
        logits = fn(torch.from_numpy(xb).to(dev))
        preds = torch.argmax(logits, dim=-1).cpu().numpy()   # (D, batch)
        off = 0
        for rid, take in meta:
            responses[rid].append(preds[:, off:off + take])
            off += take
        batches += 1
    _sync(dev)
    wall_s = time.perf_counter() - t0
    out = {rid: np.concatenate(chunks, axis=1)
           for rid, chunks in responses.items()}
    return {
        "device": str(dev),
        "num_designs": len(designs),
        "kind": designs[0].kind,
        "bits": designs[0].bits,
        "batch": batch,
        "requests": len(requests),
        "samples": total_rows,
        "batches": batches,
        "pad_fraction": padded_rows / max(batches * batch, 1),
        "wall_s": wall_s,
        "requests_per_s": len(requests) / wall_s,
        "samples_per_s": total_rows / wall_s,
        "responses": out,
    }


def _smoke_front(dataset: str, device: DeviceLike = None):
    """Tiny fixed-seed search + export of ``dataset`` (the reference's
    smoke config), so ``--smoke`` needs no exported front on disk.
    Returns (designs, data)."""
    from repro_torch.core import search
    from repro_torch.data import tabular
    spec = tabular.SPECS[dataset]
    data = tabular.make_dataset(dataset)
    sizes = (spec.features, spec.hidden, spec.classes)
    cfg = search.SearchConfig(bits=2, pop_size=6, generations=1,
                              train_steps=30)
    pg, _, _ = search.run_search(data, sizes, cfg, device=device)
    return deploy.export_front(pg, data, sizes, cfg, device=device), data


_LATER = {
    "driver": "--driver async (the serving engine, with its "
              "calibrate-on-recovery path, ROADMAP A9)",
    "sharded": "--sharded (multi-GPU design sharding, ROADMAP A9)",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serve an exported ADC+classifier front through the "
                    "PyTorch/CUDA port.")
    ap.add_argument("--front-dir",
                    help="front saved by save_front (either package); "
                         "required unless --smoke")
    ap.add_argument("--dataset", default="seeds",
                    help="sample stream + labels for the parity check")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--request-size", type=int, default=8)
    ap.add_argument("--batch", type=int, default=128,
                    help="microbatch rows (continuous batching)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the hand-written kernels; cpu: their plain "
                         "PyTorch versions")
    ap.add_argument("--nonideal-sigma", type=float, default=0.0,
                    help="serve through a sampled non-ideal instance: "
                         "comparator offset sigma in LSBs")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="stuck-at-0/1 probability per comparator")
    ap.add_argument("--range-drift", type=float, default=0.0,
                    help="reference-ladder drift sigma (fraction of "
                         "full scale)")
    ap.add_argument("--nonideal-seed", type=int, default=0)
    ap.add_argument("--nonideal-instance", type=int, default=0,
                    help="which MC instance of the seed's stream to "
                         "sample the served hardware from")
    ap.add_argument("--mc-samples", type=int, default=0,
                    help="the MC stream size --nonideal-instance indexes "
                         "into: a robustness report's samples serves "
                         "exactly the instance it lists (0: a minimal "
                         "instance+1-sample stream)")
    ap.add_argument("--calibrate", action="store_true",
                    help="with --nonideal-*: calibrate the front against "
                         "the sampled instance's measured non-idealities "
                         "and serve through the calibrated tables")
    ap.add_argument("--yield-margins", default="0.01,0.05",
                    help="with --nonideal-*: comma list of accuracy-drop "
                         "margins for the served front's yield summary")
    ap.add_argument("--smoke", action="store_true",
                    help="search and export a tiny front of --dataset "
                         "first (no --front-dir needed), then serve it "
                         "with a short request stream")
    # reference options of a later slice: accepted only to be refused
    ap.add_argument("--driver", choices=("batch", "async"), default="batch")
    ap.add_argument("--sharded", action="store_true")
    return ap


def main(argv=None) -> Dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    asked = {"driver": args.driver == "async", "sharded": args.sharded}
    for key, on in asked.items():
        if on:
            ap.error(f"{_LATER[key]} is not yet ported to repro_torch; "
                     f"use the JAX package (python -m "
                     f"repro.launch.serve_classifier)")
    nonideal = None
    if (args.nonideal_sigma > 0 or args.fault_rate > 0
            or args.range_drift > 0):
        from repro_torch.core.nonideal import NonIdealSpec
        nonideal = NonIdealSpec(sigma_offset=args.nonideal_sigma,
                                sigma_range=args.range_drift,
                                fault_rate=args.fault_rate,
                                seed=args.nonideal_seed)
    if args.calibrate and nonideal is None:
        ap.error("--calibrate re-bakes the front against a measured "
                 "non-ideal instance; it needs --nonideal-sigma / "
                 "--fault-rate / --range-drift")
    from repro_torch.launch.train import parse_yield_margins
    try:
        yield_margins = parse_yield_margins(args.yield_margins)
    except ValueError as exc:
        ap.error(str(exc))

    from repro_torch.data import tabular
    if args.front_dir is None and not args.smoke:
        ap.error("--front-dir is required unless --smoke is given")
    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        ap.error(str(exc))
    if args.smoke:
        args.requests, args.request_size = 16, 4
        args.batch = min(args.batch, 32)
    if args.front_dir is not None:
        designs = deploy.load_front(args.front_dir)
        trained_on = deploy.front_meta(args.front_dir).get("dataset")
        if trained_on is not None and trained_on != args.dataset:
            ap.error(f"front at {args.front_dir} was exported from dataset "
                     f"{trained_on!r}; serving {args.dataset!r} traffic "
                     f"through it would be wrong-domain (pass --dataset "
                     f"{trained_on})")
        data = tabular.make_dataset(args.dataset)
    else:
        designs, data = _smoke_front(args.dataset, dev)
    if designs[0].channels != data["x_test"].shape[1]:
        ap.error(f"front expects {designs[0].channels} sensor channels but "
                 f"dataset {args.dataset!r} has {data['x_test'].shape[1]}")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain PyTorch versions)")
    print(f"serve_classifier[repro_torch driver=batch D={len(designs)} "
          f"{designs[0].kind} {designs[0].spec.describe()}] device={dev} "
          f"({name})"
          + (f" nonideal=({nonideal.describe()} "
             f"instance={args.nonideal_instance})" if nonideal else ""))

    nonideal_fn = cal_fn = None
    if nonideal is not None:
        # built once: serve() drives it for throughput and the
        # degradation report below reuses it
        samples = args.mc_samples or None
        nonideal_fn = deploy.make_nonideal_bank_fn(
            designs, nonideal, instance=args.nonideal_instance,
            samples=samples, device=dev)
        if args.calibrate:
            cal_fn = deploy.make_calibrated_bank_fn(
                designs, nonideal, instance=args.nonideal_instance,
                samples=samples, device=dev)

    requests = make_request_stream(data["x_test"], args.requests,
                                    args.request_size)
    rep = serve(designs, requests, args.batch, device=dev,
                bank_fn=cal_fn if cal_fn is not None else nonideal_fn)
    print(f"  {rep['requests']} requests ({rep['samples']} samples) in "
          f"{rep['wall_s']:.3f}s: {rep['requests_per_s']:.1f} req/s, "
          f"{rep['samples_per_s']:.0f} samples/s "
          f"({rep['batches']} batches of {rep['batch']}, "
          f"{rep['pad_fraction'] * 100:.1f}% pad) on {name}")

    if nonideal is not None:
        return _report_nonideal(rep, designs, data, nonideal, nonideal_fn,
                                cal_fn, yield_margins, args, dev)

    # round-trip parity: the served front reproduces each design's
    # export-time accuracy exactly
    served = deploy.served_accuracies(designs, data["x_test"],
                                      data["y_test"], device=dev)
    exported = np.array([d.accuracy for d in designs])
    for i, d in enumerate(designs):
        print(f"  design {i}: area={d.area_tc:4d}T  dp={int(d.dp):+d}  "
              f"acc exported={d.accuracy:.3f} served={served[i]:.3f}")
    if not np.array_equal(served, exported):
        raise SystemExit(f"served accuracies diverge from the exported "
                         f"front: {served} != {exported}")
    print("  parity OK: served == exported accuracy for every design")
    rep["served_accuracies"] = [float(a) for a in served]
    return rep


def _fn_accuracies(fn, data, dev) -> np.ndarray:
    """(D,) float32 accuracies of a bank closure on the test split."""
    logits = fn(data["x_test"])
    y = torch.as_tensor(np.asarray(data["y_test"])).to(dev)
    return deploy._mean_acc(torch.argmax(logits, -1)
                            == y[None, :]).cpu().numpy()


def _report_nonideal(rep, designs, data, nonideal, nonideal_fn, cal_fn,
                     yield_margins, args, dev) -> Dict:
    """The degraded-hardware report: the sampled instance's accuracy per
    design against the exported one, the calibrated recovery with
    ``--calibrate``, and the yield over the instance stream the served
    instance was drawn from."""
    exported = np.array([d.accuracy for d in designs])
    served = _fn_accuracies(nonideal_fn, data, dev)
    recovered = (_fn_accuracies(cal_fn, data, dev) if cal_fn is not None
                 else None)
    for i, d in enumerate(designs):
        rec = (f" calibrated={recovered[i]:.3f} "
               f"(recovered {recovered[i] - served[i]:+.3f})"
               if recovered is not None else "")
        print(f"  design {i}: area={d.area_tc:4d}T  acc "
              f"exported={d.accuracy:.3f} served={served[i]:.3f} "
              f"(drop {d.accuracy - served[i]:+.3f}){rec}")
    print(f"  served a sampled non-ideal instance ({nonideal.describe()}):"
          f" mean accuracy drop {float(np.mean(exported - served)):+.3f}"
          + (f", calibrated recovery "
             f"{float(np.mean(recovered - served)):+.3f}"
             if recovered is not None else ""))
    rob = deploy.evaluate_robustness(
        designs, nonideal, data["x_test"], data["y_test"],
        samples=args.mc_samples or args.nonideal_instance + 1,
        yield_margins=yield_margins, device=dev)
    for m in yield_margins:
        ys = "  ".join(f"{row['yield'][f'{m:g}']:.2f}"
                       for row in rob["designs"])
        print(f"  yield@{m:g} over {rob['samples']} instances: {ys}")
    rep["nonideal"] = nonideal.to_meta()
    rep["served_accuracies"] = [float(a) for a in served]
    if recovered is not None:
        rep["calibrated_accuracies"] = [float(a) for a in recovered]
    rep["yield_margins"] = [float(m) for m in yield_margins]
    rep["yield"] = [row["yield"] for row in rob["designs"]]
    return rep


if __name__ == "__main__":
    main()
