"""repro_torch.api: the paper's pipeline as one facade. Counterpart of
``repro/api.py`` (the verbs of the ported slices)::

    from repro_torch import api

    spec = api.AdcSpec(bits=4)
    front = api.search(spec, data, sizes=(21, 5, 3), pop_size=16,
                       generations=8)           # NSGA-II x batched QAT
    front = api.search_gradient(spec, data, sizes=(21, 5, 3),
                                pop_size=16)    # one gate train + re-score
    bank = api.deploy(front)                     # frozen classifiers
    logits = api.serve(bank, x)                  # fused bank kernel
    api.save_front("front_dir", bank)
    bank = api.load_front("front_dir")           # bit-for-bit restore

    ni = api.NonIdealSpec(sigma_offset=0.5, fault_rate=0.01)
    rep = api.evaluate_robustness(bank, ni, x, y)     # MC yield report
    api.robustness_curve(bank, x, y, [0, 0.5, 1.0])   # accuracy vs sigma
    front = api.search(spec, data, sizes=(21, 5, 3), nonideal=ni,
                       mc_samples=32, robust_objective="yield",
                       faulttol=api.FaultTolSpec())   # 3 objectives
    cal = api.calibrate(api.deploy(front), ni, instance=0)

    stream = timeseries.make_stream("stress")   # raw (M, W, C_raw) windows
    front = api.cosearch(stream, api.FeatureSpec(channels=4, window=32),
                         bits=3, pop_size=16, generations=4)
    api.serve(api.deploy(front), stream["x_test"])   # raw windows in

    trace = api.make_workload(x, 256, tenant="cardio", rate_rps=800.0,
                              shape="bursty", deadline_ms=500.0)
    rep = api.serve_stream(bank, trace)   # asyncio engine: SLOs, shedding

    mesh = make_mesh((2, 1), ("data", "model"))   # launch/mesh.py
    front = api.search(spec, data, engine="sharded", mesh=mesh)
    api.serve(bank, x, mesh=mesh)          # D/2 designs per shard
    api.serve_stream(bank, trace, devices=["cuda:0", "cuda:1"],
                     sharded=True)         # re-meshed on a device loss

    api.autotune()      # time every kernel tile on the card, write and
                        # activate kernels/tuned_tables.json

Every verb runs on the card (``device=None`` means ``cuda``) unless the
caller passes ``device="cpu"``; a ``mesh`` (``launch.mesh.make_mesh``,
e.g. over ``["cpu", "cpu"]``) places the work on its devices instead.
It is a thin composition of core/search, core/deploy and kernels/ops,
so the search -> export -> load -> serve contract holds through the
facade: ``bank.accuracies(x_test, y_test)`` equals the search-time
fitness exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import deploy as _deploy
from repro_torch.core import search as _search
from repro_torch.core.deploy import DeployedClassifier
from repro_torch.core.nonideal import NonIdealSpec
from repro_torch.core.search import SearchConfig
from repro_torch.core.spec import AdcSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.faulttol import FaultTolSpec
from repro_torch.kernels import ops as _ops
from repro_torch.launch.mesh import Mesh
from repro_torch.timeseries.feature import FeatureSpec

__all__ = [
    "AdcSpec",
    "Bank",
    "DeployedClassifier",
    "FaultTolSpec",
    "FeatureSpec",
    "Front",
    "NonIdealSpec",
    "SearchConfig",
    "autotune",
    "calibrate",
    "cosearch",
    "deploy",
    "evaluate_robustness",
    "load_front",
    "make_workload",
    "quantize",
    "robustness_curve",
    "save_front",
    "search",
    "search_gradient",
    "serve",
    "serve_stream",
]


@dataclasses.dataclass(frozen=True)
class Front:
    """A searched Pareto front, still in genome form: everything
    ``deploy`` needs to freeze it into servable artifacts without
    re-running QAT (the trained parameter stacks ride along)."""
    spec: AdcSpec
    config: SearchConfig
    sizes: Tuple[int, ...]
    genomes: np.ndarray            # (K, G) uint8 Pareto genomes
    fitness: np.ndarray            # (K, 2) [1-acc, normalized area], or
                                   # (K, 3) with the robustness column
    trained: tuple                 # train_pareto_front's (accs, params,
                                   # masks, dps), the export short-circuit
    device: str = "cuda"           # where the QAT ran

    def __len__(self) -> int:
        return len(self.genomes)

    @property
    def accuracies(self) -> np.ndarray:
        return 1.0 - self.fitness[:, 0]

    @property
    def areas(self) -> np.ndarray:
        """Normalized ADC areas (vs the full flash bank)."""
        return self.fitness[:, 1]


@dataclasses.dataclass(frozen=True)
class Bank:
    """A deployed front: frozen classifiers + the fused serving entry."""
    designs: Tuple[DeployedClassifier, ...]

    def __len__(self) -> int:
        return len(self.designs)

    @property
    def spec(self) -> AdcSpec:
        return self.designs[0].spec

    def logits(self, x, *, device: DeviceLike = None,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
        """(M, C) samples (raw (M, W, C_raw) windows for a feature-baked
        bank) -> (D, M, O) logits through the fused multi-design bank
        kernel (design-sharded over ``mesh`` if given)."""
        return _deploy.serve_bank(self.designs, x, device=device, mesh=mesh)

    def predict(self, x, **kw) -> torch.Tensor:
        return torch.argmax(self.logits(x, **kw), dim=-1)

    def accuracies(self, x, y, *, device: DeviceLike = None,
                   mesh: Optional[Mesh] = None) -> np.ndarray:
        """(D,) served accuracies (design-sharded over ``mesh`` if given):
        bit for bit the exported (== search fitness) accuracies."""
        return _deploy.served_accuracies(self.designs, x, y, device=device,
                                         mesh=mesh)

    def evaluate_robustness(self, nonideal: NonIdealSpec, x, y,
                            samples: int = 32, **kw) -> Dict:
        """Monte-Carlo yield/accuracy report of the whole bank under
        ``nonideal`` hardware (module-level ``evaluate_robustness``)."""
        return _deploy.evaluate_robustness(self.designs, nonideal, x, y,
                                           samples, **kw)


def search(spec: AdcSpec, data: Dict, sizes: Optional[Sequence[int]] = None,
           *, model: str = "mlp", pop_size: int = 32, generations: int = 16,
           train_steps: int = 300, engine: str = "batched", seed: int = 0,
           weight_bits: int = 8, hidden: int = 4, log=None,
           ckpt=None, resume: bool = False, device: DeviceLike = None,
           mesh: Optional[Mesh] = None, **cfg_kw) -> Front:
    """Run the paper's in-training ADC optimization around ``spec``.

    data: dict with x_train/y_train/x_test/y_test (data.tabular layout).
    sizes: (features, hidden, classes); inferred from the data (with
    ``hidden`` hidden units) when omitted. Remaining kwargs mirror
    core/search.SearchConfig; ``engine`` picks batched | sharded |
    reference | gradient (``mesh`` feeds 'sharded': default
    ``search.default_search_mesh(device)``, and the front's QAT then
    runs on its first device), ``ckpt``/``resume`` checkpoint the
    search and restart it (``checkpoint.manager.CheckpointManager``).
    Returns a ``Front`` carrying the Pareto genomes, their fitness, and
    the trained parameter stacks ``deploy`` reuses."""
    dev = _search.search_device(engine, device, mesh)
    if sizes is None:
        features = int(np.asarray(data["x_train"]).shape[-1])
        classes = int(np.asarray(data["y_train"]).max()) + 1
        sizes = (features, hidden, classes)
    sizes = tuple(int(s) for s in sizes)
    spec.validate_channels(sizes[0])
    cfg = SearchConfig.for_spec(spec, model=model, pop_size=pop_size,
                                generations=generations,
                                train_steps=train_steps, engine=engine,
                                seed=seed, weight_bits=weight_bits,
                                **cfg_kw)
    pg, pf, _, trained = _search.run_search(data, sizes, cfg, log=log,
                                            ckpt=ckpt, resume=resume,
                                            return_trained=True, device=dev,
                                            mesh=mesh)
    return Front(spec=spec, config=cfg, sizes=sizes,
                 genomes=np.asarray(pg, np.uint8),
                 fitness=np.asarray(pf, np.float64), trained=trained,
                 device=str(dev))


def search_gradient(spec: AdcSpec, data: Dict,
                    sizes: Optional[Sequence[int]] = None, *,
                    model: str = "mlp", pop_size: int = 32,
                    train_steps: int = 300, seed: int = 0,
                    weight_bits: int = 8, hidden: int = 4, log=None,
                    ckpt=None, resume: bool = False,
                    device: DeviceLike = None, **cfg_kw) -> Front:
    """The gradient engine behind the same ``Front`` contract as
    ``search``: one gate train over ``4 * pop_size`` lanes (override
    with ``grad_points=...``) with a log-spaced area-weight sweep, its
    snapshots snapped to genomes and re-scored through the exact fitness
    path, then surrogate-screened polish; the returned front re-trains
    to its fitness bit for bit. ``ckpt``/``resume`` checkpoint the gate
    train's chunks."""
    return search(spec, data, sizes, model=model, pop_size=pop_size,
                  generations=0, train_steps=train_steps,
                  engine="gradient", seed=seed, weight_bits=weight_bits,
                  hidden=hidden, log=log, ckpt=ckpt, resume=resume,
                  device=device, **cfg_kw)


def cosearch(data: Dict, feature: FeatureSpec, *, bits: int = 3,
             pct: float = 0.5, model: str = "mlp", pop_size: int = 32,
             generations: int = 16, train_steps: int = 300,
             engine: str = "batched", seed: int = 0, weight_bits: int = 8,
             hidden: int = 4, init=None, device: DeviceLike = None, log=None,
             mesh: Optional[Mesh] = None, **cfg_kw) -> Front:
    """Streaming sensor -> feature -> ADC -> classifier co-design.

    data: raw sliding-window splits (``timeseries.make_stream`` layout,
    x_* of shape (M, W, C_raw)). ``feature`` names the analog front-end
    design space (subsample grid, feature kinds, allocation ladder); the
    genome grows feature genes and the engine searches front end and ADC
    jointly, the front end's transistors on the same area axis. The
    per-channel ``AdcSpec`` is auto-ranged over every featurized variant
    (``AdcSpec.from_data``, clip ``pct``). Returns the same ``Front`` as
    ``search``: ``deploy`` bakes each design's FeatureSpec, and the bank
    then serves raw windows. ``init`` seeds the population, e.g. an
    ADC-only front lifted by ``timeseries.cosearch.embed_adc_only``.
    ``mesh`` feeds ``engine='sharded'`` as in ``search``."""
    from repro_torch.timeseries import cosearch as _cosearch
    dev = _search.search_device(engine, device, mesh)
    pg, pf, _, trained, cfg, _, sizes, spec = _cosearch.run(
        data, feature, bits=bits, pct=pct, hidden=hidden, init=init,
        log=log, device=dev, mesh=mesh, model=model, pop_size=pop_size,
        generations=generations, train_steps=train_steps, engine=engine,
        seed=seed, weight_bits=weight_bits, **cfg_kw)
    return Front(spec=spec, config=cfg, sizes=tuple(sizes),
                 genomes=np.asarray(pg, np.uint8),
                 fitness=np.asarray(pf, np.float64), trained=trained,
                 device=str(dev))


def deploy(front: Front, data: Optional[Dict] = None) -> Bank:
    """Freeze a searched ``Front`` into a servable ``Bank``: baked value
    tables, po2-quantized weights, exact transistor-count area, export
    accuracy == search fitness bit for bit. The front's trained stacks
    short-circuit the QAT re-train; ``data`` is only needed for a
    ``Front`` reconstructed without them."""
    if front.trained is None and data is None:
        raise ValueError("this Front carries no trained stacks; pass the "
                         "training data so deploy() can re-derive them")
    designs = _deploy.export_front(front.genomes, data, front.sizes,
                                   front.config, trained=front.trained,
                                   device=front.device)
    return Bank(designs=tuple(designs))


def serve(bank: Union[Bank, Sequence[DeployedClassifier]], x, *,
          device: DeviceLike = None,
          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One shared (M, C) sample batch (raw (M, W, C_raw) windows for a
    feature-baked bank) through the whole deployed bank: (D, M, O)
    logits through the fused multi-design kernel; with ``mesh`` the
    design axis is split over the mesh, one bank launch per shard, the
    logits gathered on its first device."""
    designs = bank.designs if isinstance(bank, Bank) else tuple(bank)
    return _deploy.serve_bank(designs, x, device=device, mesh=mesh)


def make_workload(x, num_requests: int, *, tenant: str = "default",
                  rate_rps: float = 200.0, shape: str = "uniform",
                  **kw):
    """A seeded open-loop request trace for ``serve_stream`` (DESIGN.md
    §12): ``num_requests`` small requests drawn from ``x``, arriving per
    a shaped Poisson process (``uniform`` | ``bursty`` | ``diurnal``,
    mean rate ``rate_rps``), each with a deadline. Deterministic under
    ``seed``, bit for bit the reference's trace; full knob set in
    ``repro_torch.launch.loadgen.make_workload``."""
    from repro_torch.launch import loadgen
    return loadgen.make_workload(x, num_requests, tenant=tenant,
                                 rate_rps=rate_rps, shape=shape, **kw)


def serve_stream(bank: Union[Bank, Sequence[DeployedClassifier], Dict],
                 workload, *, parity_data=None,
                 nonideal: Optional[NonIdealSpec] = None,
                 **engine_kw) -> Dict:
    """Serve an open-loop request trace through the serving engine
    (DESIGN.md §12): asyncio ingestion with deadlines and counted
    shedding, adaptive microbatching, per-tenant p50/p95/p99 SLO
    snapshot, device-pool recovery.

    ``bank`` is one deployed bank (single tenant, named by the
    workload's requests) or a ``{tenant_name: bank}`` dict for
    multi-tenant serving; ``parity_data`` ((x, y) or a per-tenant dict of
    them) arms the post-recovery bit-for-bit parity re-assert. Returns
    the structured metrics snapshot (``tenants`` SLO stats, batching
    counters, device-pool state, per-request ``responses``). Engine
    knobs (``devices``, ``sharded``, ``target_latency_ms``,
    ``max_batch``, ``inject_device_failure``, ...) pass through;
    ``devices=None`` serves on ``cuda``; ``sharded=True`` splits every
    bank over a mesh of the pool's survivors while two are alive.
    ``nonideal`` marks the hardware as carrying measured non-idealities:
    every tenant then serves calibrated tables and re-calibrates after
    each device-loss recovery (DESIGN.md §15)."""
    from repro_torch.launch import serving_engine

    if isinstance(bank, dict):
        banks = {name: tuple(_designs(b)) for name, b in bank.items()}
    else:
        names = {r.tenant for r in workload}
        if len(names) != 1:
            raise ValueError(
                f"single-bank serve_stream needs a single-tenant workload; "
                f"got tenants {sorted(names)}; pass a {{tenant: bank}} "
                f"dict to route")
        banks = {next(iter(names)): tuple(_designs(bank))}
    if parity_data is not None and not isinstance(parity_data, dict):
        parity_data = {name: parity_data for name in banks}
    tenants = [serving_engine.Tenant(
        name=name, designs=designs,
        parity_data=(parity_data or {}).get(name), nonideal=nonideal)
        for name, designs in banks.items()]
    return serving_engine.run_workload(tenants, workload, **engine_kw)


def save_front(directory, bank: Union[Bank, Sequence[DeployedClassifier]],
               extra_meta: Optional[Dict] = None) -> None:
    """Persist a deployed bank (atomic commit, one .npy per leaf, in the
    reference's format: the JAX package loads it too)."""
    designs = bank.designs if isinstance(bank, Bank) else tuple(bank)
    _deploy.save_front(directory, list(designs), extra_meta=extra_meta)


def load_front(directory) -> Bank:
    """Inverse of ``save_front``: the reloaded bank serves bit for bit as
    the one exported."""
    return Bank(designs=tuple(_deploy.load_front(directory)))


def _designs(bank) -> list:
    return list(bank.designs if isinstance(bank, Bank) else bank)


def evaluate_robustness(bank: Union[Bank, Sequence[DeployedClassifier]],
                        nonideal: NonIdealSpec, x, y, samples: int = 32,
                        **kw) -> Dict:
    """Monte-Carlo robustness of a deployed bank under non-ideal hardware:
    S perturbed instances of every design (comparator offsets,
    reference-ladder drift, stuck-at faults per ``nonideal``) against the
    shared (x, y) test set through the MC kernel. With an all-zero
    ``NonIdealSpec`` it reproduces the exported accuracies, and for a
    3-objective search it reproduces the robustness column, bit for
    bit."""
    return _deploy.evaluate_robustness(_designs(bank), nonideal, x, y,
                                       samples, **kw)


def calibrate(bank: Union[Bank, Sequence[DeployedClassifier]],
              nonideal: NonIdealSpec, *, instance: int = 0,
              samples: Optional[int] = None,
              device: DeviceLike = None) -> Bank:
    """Re-bake a deployed bank against ONE measured hardware instance
    (instance ``instance`` of the ``samples``-sample stream of
    ``nonideal``'s seed, as ``evaluate_robustness`` indexes it): value
    tables become the measured reconstruction, ranges the drifted ones,
    and the ideal serving path then reconstructs what the fabricated ADC
    resolves."""
    return Bank(designs=tuple(_deploy.calibrate_front(
        _designs(bank), nonideal, instance=instance, samples=samples,
        device=device)))


def robustness_curve(bank: Union[Bank, Sequence[DeployedClassifier]], x, y,
                     sigmas: Sequence[float], samples: int = 32,
                     **kw) -> Dict:
    """Accuracy-vs-sigma sweep over comparator-offset sigmas: one
    ``evaluate_robustness`` report per point (persist with
    ``core.deploy.save_robustness`` next to the front)."""
    return _deploy.robustness_curve(_designs(bank), x, y, sigmas, samples,
                                    **kw)


def autotune(workloads=None, *, write: bool = True, path=None,
             **kw) -> Dict:
    """Time every candidate tile of every hand kernel on the card (or of
    the given ``repro_torch.perf.Workload`` list; default
    ``perf.autotune.default_workloads()``, the paths' shapes), persist the
    winners as the tuned table next to the dispatch layer
    (kernels/tuned_tables.json by default) and activate them in-process:
    later kernel resolutions take the tuned tile for matching shape
    classes and log it; everything else keeps the heuristic. Tuning
    changes speed only, never values. Needs a CUDA device unless
    ``measure_fn`` is passed. Returns the tuned table; ``write=False``
    measures without persisting."""
    from repro_torch.perf import autotune as _autotune
    return _autotune.autotune(workloads, write=write, path=path, **kw)


def quantize(x, mask, spec: AdcSpec, *,
             device: DeviceLike = None) -> torch.Tensor:
    """Quantize (M, C) samples through per-channel pruned ADCs described
    by ``spec`` (mask (C, 2^bits)), or through a whole population at once
    (mask (P, C, 2^bits) -> (P, M, C)): the population quantizer kernel
    on the card."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev).contiguous()
    mask = torch.as_tensor(mask).to(dev)
    if mask.ndim == 3:
        return _ops.adc_quantize_population(x, mask, spec=spec)
    return _ops.adc_quantize(x, mask, spec=spec)
