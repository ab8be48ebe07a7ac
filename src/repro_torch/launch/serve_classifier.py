"""Serving launcher for deployed ADC+classifier fronts, on the card.
Counterpart of ``repro/launch/serve_classifier.py``. Two drivers:

* ``--driver batch`` (default; DESIGN.md §8): the fixed-microbatch loop
  drains a request list into ``--batch``-row microbatches (a microbatch
  may span many small requests or a slice of one large request; the tail
  is padded), pushes each through the *whole* deployed front in one
  bank-kernel launch, and reports requests/s and samples/s.
* ``--driver async`` (DESIGN.md §12): the serving engine
  (``launch/serving_engine.py``): an open-loop load trace
  (``launch/loadgen.py``: ``--rate``, ``--traffic
  uniform|bursty|diurnal``) with per-request deadlines
  (``--deadline-ms``) and counted shedding, per-tenant p50/p95/p99,
  adaptive microbatch sizes (``--target-latency-ms``, ``--max-batch``)
  and multi-tenant routing: repeat ``--front-dir`` to make several
  fronts resident, each named by its ``front_meta`` dataset.
  ``--fail-device-at N`` injects a device loss at bank launch N; the
  pool holds the one ``--device`` (with ``--sharded``, every visible
  device of its type), so on one card the run ends in the pool's
  exhaustion error (``api.serve_stream(devices=...)`` takes a larger
  pool). With ``--nonideal-*`` the async driver needs ``--calibrate``:
  every tenant then serves calibrated tables and re-calibrates after a
  recovery.

``--sharded`` splits the design bank D/n over the devices: the batch
driver serves through ``make_bank_fn(mesh=search.default_search_mesh(
--device))`` (every visible card; one entry on the CPU), the async
driver's pool is made sharded (a mesh over its survivors while at least
two are alive). ``--sharded`` with ``--nonideal-*`` is refused under the
batch driver, as in the reference.

Every response carries all D designs' predictions. After serving, the
front's served accuracies on the dataset's test split must equal each
design's exported accuracy exactly (per tenant under ``--driver
async``).

  # serve a front exported by either package, on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve_classifier \\
      --front-dir tests/fixtures/fronts/cardio_mlp --dataset cardio \\
      --requests 256 --request-size 8 --batch 1024
  # the same through the plain PyTorch versions on the CPU:
  ... --device cpu
  # the serving engine, bursty open-loop traffic at 800 req/s:
  ... --driver async --rate 800 --traffic bursty --deadline-ms 500

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
      --dataset seeds --device cpu    # --driver async: the engine
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
from repro_torch.launch import mesh as mesh_lib


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
          device: DeviceLike = None, mesh=None, bank_fn=None) -> Dict:
    """Drain ``requests`` through the bank in fixed ``batch``-row
    microbatches. Returns the throughput report plus per-request
    responses ``{rid: (D, n_rows) predicted classes}``. ``bank_fn``
    overrides the (M, C) -> (D, M, O) bank closure
    (deploy.make_bank_fn by default); ``mesh`` splits the default bank's
    design axis over a mesh (``launch.mesh.work_device``: the work runs
    on its first device, which ``device``, if given, must be).
    Request rows are samples of the front's ``sample_shape``: (C,) rows,
    or raw (W, C_raw) windows for a feature-baked front."""
    if bank_fn is not None and mesh is not None:
        raise ValueError("a custom bank_fn (non-ideal serving) and "
                         "--sharded are mutually exclusive")
    dev = mesh_lib.work_device(device, mesh)
    fn = bank_fn if bank_fn is not None else deploy.make_bank_fn(
        designs, device=dev, mesh=mesh)
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


def _serve_async(fronts, args, dev: torch.device, nonideal=None) -> Dict:
    """The --driver async path: one Tenant per loaded front, an open-loop
    load trace per tenant, merged into one stream through the engine on
    the pool ``[dev]`` (with --sharded: every visible device of its type,
    the pool sharded). With ``nonideal`` (--calibrate) every tenant
    serves calibrated tables and re-calibrates on device-loss recovery
    (DESIGN.md §15)."""
    from repro_torch.launch import loadgen, serving_engine
    from repro_torch.launch.mesh import visible_devices

    tenants, traces = [], []
    for name, designs, data in fronts:
        tenants.append(serving_engine.Tenant(
            name=name, designs=designs,
            parity_data=(data["x_test"], data["y_test"]),
            nonideal=nonideal))
        traces.append(loadgen.make_workload(
            data["x_test"], args.requests, tenant=name,
            rate_rps=args.rate, request_size=args.request_size,
            deadline_ms=args.deadline_ms, shape=args.traffic,
            seed=args.seed))
    workload = loadgen.merge_workloads(*traces)
    print(f"  load: {loadgen.describe(workload)}")

    inject = None
    if args.fail_device_at is not None:
        fail_at = args.fail_device_at
        inject = lambda b: 0 if b == fail_at else None   # noqa: E731

    rep = serving_engine.run_workload(
        tenants, workload,
        devices=visible_devices(dev) if args.sharded else [dev],
        target_latency_ms=args.target_latency_ms,
        max_batch=args.max_batch, sharded=args.sharded,
        inject_device_failure=inject)
    for name, slo in sorted(rep["tenants"].items()):
        print(f"  tenant {name}: {slo['completed']}/{slo['requests']} ok "
              f"({slo['shed']} shed, {slo['rejected']} rejected)  "
              f"p50={slo['p50_ms']:.1f}ms p95={slo['p95_ms']:.1f}ms "
              f"p99={slo['p99_ms']:.1f}ms  "
              f"{slo['requests_per_s']:.1f} req/s "
              f"{slo['samples_per_s']:.0f} samples/s")
    bs = rep["batch_sizes"]
    print(f"  {rep['batches']} batches "
          f"({rep['pad_fraction'] * 100:.1f}% pad, "
          f"{rep['stragglers']} stragglers); batch ladders: "
          + ", ".join(f"{n}: quantum {v['quantum']} ({v['quantum_source']})"
                      f" -> final {v['final']}" for n, v in sorted(bs.items())))
    dv = rep["devices"]
    print(f"  devices: {dv['alive']} alive, {dv['lost']} lost, "
          f"{rep['recoveries']} recoveries (sharded={dv['sharded']})")
    if rep.get("calibrations"):
        print("  calibrations: " + ", ".join(
            f"{n}: {c}" for n, c in sorted(rep["calibrations"].items())))
    if args.fail_device_at is not None and rep["recoveries"] < 1:
        raise SystemExit("requested --fail-device-at but no recovery ran "
                         "(stream ended before the failing batch?)")
    # post-run parity: the served front reproduces each tenant's export
    # bit for bit
    for name, designs, data in fronts:
        served = deploy.served_accuracies(designs, data["x_test"],
                                          data["y_test"], device=dev)
        exported = np.array([d.accuracy for d in designs])
        if not np.array_equal(served, exported):
            raise SystemExit(f"tenant {name}: served accuracies diverge "
                             f"from the exported front: {served} != "
                             f"{exported}")
    print("  parity OK: served == exported accuracy for every tenant")
    return rep


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serve an exported ADC+classifier front through the "
                    "PyTorch/CUDA port.")
    ap.add_argument("--front-dir", action="append",
                    help="front saved by save_front (either package); "
                         "required unless --smoke; repeat with --driver "
                         "async for multi-tenant serving")
    ap.add_argument("--dataset", default="seeds",
                    help="sample stream + labels for the parity check")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--request-size", type=int, default=8)
    ap.add_argument("--batch", type=int, default=128,
                    help="microbatch rows (continuous batching)")
    ap.add_argument("--driver", choices=("batch", "async"), default="batch",
                    help="batch: fixed-microbatch loop (§8); async: the "
                         "serving engine (§12)")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="[async] offered load, requests/s (open loop)")
    ap.add_argument("--traffic", choices=("uniform", "bursty", "diurnal"),
                    default="uniform", help="[async] arrival-rate envelope")
    ap.add_argument("--deadline-ms", type=float, default=100.0,
                    help="[async] per-request deadline budget")
    ap.add_argument("--target-latency-ms", type=float, default=50.0,
                    help="[async] adaptive batcher's latency target")
    ap.add_argument("--max-batch", type=int, default=512,
                    help="[async] batch-ladder ceiling")
    ap.add_argument("--seed", type=int, default=0,
                    help="[async] load-generator seed")
    ap.add_argument("--fail-device-at", type=int, default=None,
                    help="[async] simulate losing device 0 at this "
                         "bank-launch index (the pool is the one "
                         "--device, so this ends in its exhaustion error)")
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
    ap.add_argument("--sharded", action="store_true",
                    help="split the design bank D/n over every visible "
                         "device of --device's type (batch driver), or "
                         "shard the async engine's device pool")
    return ap


def main(argv=None) -> Dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    nonideal = None
    if (args.nonideal_sigma > 0 or args.fault_rate > 0
            or args.range_drift > 0):
        from repro_torch.core.nonideal import NonIdealSpec
        nonideal = NonIdealSpec(sigma_offset=args.nonideal_sigma,
                                sigma_range=args.range_drift,
                                fault_rate=args.fault_rate,
                                seed=args.nonideal_seed)
    if args.driver == "async" and nonideal is not None and not args.calibrate:
        ap.error("--driver async serves the ideal-hardware parity "
                 "contract; --nonideal-* needs --driver batch, or add "
                 "--calibrate to serve calibrated tables with "
                 "calibrate-on-recovery")
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
    if (args.front_dir and args.driver == "batch"
            and len(args.front_dir) > 1):
        ap.error("--driver batch serves one front; repeat --front-dir "
                 "only with --driver async (multi-tenant routing)")
    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        ap.error(str(exc))
    mesh = None
    if args.sharded and args.driver == "batch":
        if nonideal is not None:
            ap.error("--sharded and --nonideal-* are mutually exclusive")
        from repro_torch.core import search
        mesh = search.default_search_mesh(dev)
    if args.smoke:
        args.requests, args.request_size = 16, 4
        args.batch = min(args.batch, 32)
        args.rate = min(args.rate, 400.0)
    fronts = []          # (tenant name, designs, data) per resident front
    for fdir in args.front_dir or ():
        designs = deploy.load_front(fdir)
        trained_on = deploy.front_meta(fdir).get("dataset")
        # --driver async routes by front provenance: the tenant IS the
        # front's dataset; the batch driver checks it against --dataset
        name = trained_on or args.dataset
        if (args.driver == "batch" and trained_on is not None
                and trained_on != args.dataset):
            ap.error(f"front at {fdir} was exported from dataset "
                     f"{trained_on!r}; serving {args.dataset!r} traffic "
                     f"through it would be wrong-domain (pass --dataset "
                     f"{trained_on})")
        data = tabular.make_dataset(name if args.driver == "async"
                                    else args.dataset)
        if designs[0].channels != data["x_test"].shape[1]:
            ap.error(f"front expects {designs[0].channels} sensor channels "
                     f"but dataset {name!r} has {data['x_test'].shape[1]}")
        fronts.append((name, designs, data))
    if not fronts:
        designs, data = _smoke_front(args.dataset, dev)
        fronts.append((args.dataset, designs, data))
    designs, data = fronts[0][1], fronts[0][2]
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain PyTorch versions)")
    print(f"serve_classifier[repro_torch driver={args.driver} "
          f"tenants={[f[0] for f in fronts]} D={len(designs)} "
          f"{designs[0].kind} {designs[0].spec.describe()}] device={dev} "
          f"({card}) sharded={args.sharded}"
          + (f" nonideal=({nonideal.describe()} "
             f"instance={args.nonideal_instance})" if nonideal else ""))
    if args.driver == "async":
        return _serve_async(fronts, args, dev,
                            nonideal=nonideal if args.calibrate else None)

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
    rep = serve(designs, requests, args.batch, device=dev, mesh=mesh,
                bank_fn=cal_fn if cal_fn is not None else nonideal_fn)
    print(f"  {rep['requests']} requests ({rep['samples']} samples) in "
          f"{rep['wall_s']:.3f}s: {rep['requests_per_s']:.1f} req/s, "
          f"{rep['samples_per_s']:.0f} samples/s "
          f"({rep['batches']} batches of {rep['batch']}, "
          f"{rep['pad_fraction'] * 100:.1f}% pad) on {card}")

    if nonideal is not None:
        return _report_nonideal(rep, designs, data, nonideal, nonideal_fn,
                                cal_fn, yield_margins, args, dev)

    # round-trip parity: the served front reproduces each design's
    # export-time accuracy exactly
    served = deploy.served_accuracies(designs, data["x_test"],
                                      data["y_test"], device=dev, mesh=mesh)
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
