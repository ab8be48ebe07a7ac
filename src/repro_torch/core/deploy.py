"""Deployment artifacts: a searched front as servable ADC+classifier
designs. Counterpart of ``repro/core/deploy.py``: export a searched front,
save, load, stack and serve it.

A ``DeployedClassifier`` holds one frozen design: the baked (C, 2^N)
code->value table, the power-of-two weights, the genome's ``dp``, the
provenance mask, the exact transistor-count area and the export-time test
accuracy, which is bit for bit the search-time fitness (``export_front``
takes it from ``search.train_pareto_front``, and ``verify_front_parity``
re-trains to check it). Fronts are stored in the reference's format
(checkpoint/manager.py), so a front exported by the JAX package serves
here at exactly its recorded accuracies, and a front saved here loads in
the JAX package.

Serving stacks the front into one bank and pushes every batch through all
D designs in one kernel launch (kernels/ops.classifier_bank): on a CUDA
device through the hand-written bank kernels, on the CPU through their
plain versions. With a ``launch.mesh.Mesh`` (``mesh=`` on
``make_bank_fn``, ``serve_bank`` and ``served_accuracies``) the design
axis is split over the mesh, one bank launch per shard.

A design of the streaming co-search carries a baked ``FeatureSpec``
(``feature``): it serves raw (M, W, C_raw) windows, featurized by
``timeseries.feature.featurize_fn``, the same callable the search data
was built with. A front of such designs serves one bank per baked
subsample factor and scatters the logits back into front order.

Robustness: ``evaluate_robustness`` pushes the test split through S
perturbed hardware instances of every design in one launch of the
Monte-Carlo population kernel (the calibrated-table entry for a
fault-tolerant front) and re-scores each view through
``search.mc_accuracies``, the same forward the search's third column was
measured with, from the same draw stream; the report's reductions are
the search's host-side f64 ones, so a 3-objective front's third column
is reproduced bit for bit. ``make_nonideal_bank_fn`` serves one sampled
instance, ``calibrate_front`` / ``make_calibrated_bank_fn`` serve one
measured instance through re-baked tables.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, replace as dataclass_replace
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import (CheckpointManager, pack_json,
                                            unpack_json)
from repro_torch.core import area, qat
from repro_torch.core import nonideal as nonideal_lib
from repro_torch.core.adc import range_rows_tensors
from repro_torch.core.nonideal import NonIdealSpec
from repro_torch.core.search import (SearchConfig, decode_population_cosearch,
                                     decode_population_faulttol,
                                     mc_accuracies, train_pareto_front)
from repro_torch.core.spec import AdcSpec, Range
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.faulttol import calibrate as faulttol_cal
from repro_torch.faulttol import redundancy as ft_redundancy
from repro_torch.kernels import ops, qmlp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import svm as svm_lib
from repro_torch.models.mlp import mean_accuracy as _mean_acc
from repro_torch.timeseries import feature as feature_lib
from repro_torch.timeseries.feature import FeatureSpec

FORMAT_VERSION = 1

# weight leaf names per classifier family, in ops.classifier_bank order
_WEIGHT_LEAVES = {"mlp": ("w1", "b1", "w2", "b2"), "svm": ("w", "b")}


@dataclass(frozen=True)
class DeployedClassifier:
    """One frozen ADC+classifier design, ready to serve."""
    kind: str                        # 'mlp' | 'svm'
    bits: int
    mode: str                        # pruned-ADC semantics of the table
    vmin: Range                      # analog range: float or per-channel
    vmax: Range
    dp: float                        # genome decimal-point position
    mask: np.ndarray                 # (C, 2^N) int32, provenance only
    table: np.ndarray                # (C, 2^N) float32 baked value table
    weights: Tuple[np.ndarray, ...]  # po2-quantized, _WEIGHT_LEAVES order
    area_tc: int                     # exact transistor count
    accuracy: float                  # export-time test accuracy
    # baked analog front end of a streaming co-searched design: None for
    # tabular (M, C) designs, a subsample/alloc-baked FeatureSpec for
    # designs that consume raw (M, W, C_raw) windows
    feature: Optional[FeatureSpec] = None
    # fault-tolerance provenance: the per-channel TMR genes (None for
    # plain designs; spare levels are already folded into ``mask``) and
    # the calibrate gene. Robustness evaluation of such a front runs the
    # redundant draw stream and per-instance calibrated tables; ideal
    # serving does not read them
    tmr: Optional[np.ndarray] = None
    calibrated: bool = False

    @property
    def spec(self) -> AdcSpec:
        return AdcSpec(bits=self.bits, mode=self.mode, vmin=self.vmin,
                       vmax=self.vmax)

    @property
    def channels(self) -> int:
        """ADC input channel count C (feature channels for a co-searched
        design)."""
        return int(self.table.shape[0])

    @property
    def sample_shape(self) -> Tuple[int, ...]:
        """Shape of ONE raw sample this design serves: (C,) for tabular
        designs, (window, raw_channels) for streaming ones."""
        if self.feature is not None:
            return (self.feature.window, self.feature.channels)
        return (self.channels,)

    def logits(self, x, *, device: DeviceLike = None) -> torch.Tensor:
        """Samples (M, C) -> (M, O) logits on ``device``, through the
        single-design entry (the D=1 call of the bank kernel) with the
        baked table. A feature-baked design takes raw (M, W, C_raw)
        windows through ``feature.featurize_fn``; already featurized
        (M, C) input goes straight to the kernel."""
        dev = resolve_device(device)
        if self.feature is not None and np.ndim(x) == 3:
            x = feature_lib.featurize_fn(self.feature)(x, device=dev)
        x = torch.as_tensor(x, dtype=torch.float32).to(dev).contiguous()
        table = torch.from_numpy(self.table).to(dev)
        weights = tuple(torch.from_numpy(w).to(dev) for w in self.weights)
        single = qmlp.bespoke_mlp if self.kind == "mlp" else qmlp.bespoke_svm
        return single(x, table, *weights, spec=self.spec)

    def predict(self, x, *, device: DeviceLike = None) -> torch.Tensor:
        return torch.argmax(self.logits(x, device=device), dim=-1)

    def accuracy_on(self, x, y, *, device: DeviceLike = None) -> float:
        pred = self.predict(x, device=device)
        y = torch.as_tensor(np.asarray(y)).to(pred.device)
        return float(_mean_acc(pred[None] == y[None])[0])


def from_numpy(kind: str, spec_meta: Dict, table, weights, *, mask, dp,
               area_tc, accuracy, tmr=None, calibrated: bool = False,
               feature: Optional[FeatureSpec] = None
               ) -> DeployedClassifier:
    """Carry one design's arrays (as the JAX package exports and saves
    them) into a port ``DeployedClassifier``, checking kind, spec, dtypes
    and shapes: ``table`` (C, 2^N) float32; ``weights`` in
    ``_WEIGHT_LEAVES[kind]`` order ((C, H), (H,), (H, O), (O,) for an MLP;
    (C, O), (O,) for an SVM); ``mask`` (C, 2^N); a baked ``feature``
    must produce C feature channels."""
    if kind not in _WEIGHT_LEAVES:
        raise ValueError(f"unknown classifier kind {kind!r}")
    spec = AdcSpec.from_meta(spec_meta)
    table = np.asarray(table)
    if table.dtype != np.float32 or table.ndim != 2 \
            or table.shape[1] != spec.levels:
        raise ValueError(f"table must be float32 (C, {spec.levels}); got "
                         f"{table.dtype} {table.shape}")
    c = table.shape[0]
    spec.validate_channels(c)
    weights = tuple(np.asarray(w, np.float32) for w in weights)
    names = _WEIGHT_LEAVES[kind]
    if len(weights) != len(names):
        raise ValueError(f"{kind} needs weights {names}, got "
                         f"{len(weights)} arrays")
    if kind == "mlp":
        h, o = weights[0].shape[-1], weights[2].shape[-1]
        want = ((c, h), (h,), (h, o), (o,))
    else:
        o = weights[0].shape[-1]
        want = ((c, o), (o,))
    for name, w, shape in zip(names, weights, want):
        if w.shape != shape:
            raise ValueError(f"{name} must be {shape}, got {w.shape}")
    mask = np.asarray(mask, np.int32)
    if mask.shape != table.shape:
        raise ValueError(f"mask {mask.shape} does not match table "
                         f"{table.shape}")
    if feature is not None and (feature.subsample is None
                                or feature.feature_channels != c):
        raise ValueError(f"feature must be baked and produce {c} feature "
                         f"channels; got {feature.describe()}")
    return DeployedClassifier(
        kind=kind, bits=spec.bits, mode=spec.mode, vmin=spec.vmin,
        vmax=spec.vmax, dp=float(dp), mask=mask, table=table,
        weights=weights, area_tc=int(area_tc), accuracy=float(accuracy),
        feature=feature,
        tmr=None if tmr is None else np.asarray(tmr, np.int32),
        calibrated=bool(calibrated))


# -------------------------------------------------------- search -> artifact
def export_front(genomes: np.ndarray, data: Dict, sizes: Sequence[int],
                 cfg: SearchConfig, trained=None, *,
                 device: DeviceLike = None) -> List[DeployedClassifier]:
    """Freeze (typically Pareto-front) genomes into deployable designs:
    deterministic QAT re-train (``search.train_pareto_front``) on
    ``device``, bake value tables, quantize the trained weights once with
    each genome's dp, and attach the exact transistor-count area. With a
    frontend each design bakes its genome's (subsample, alloc) into a
    ``FeatureSpec`` and its area adds the front end's transistors.

    ``trained`` short-circuits the re-train: pass the (accs, params,
    masks, dps) tuple already produced by ``train_pareto_front`` /
    ``run_search(..., return_trained=True)`` for these same genomes. The
    weights are quantized on ``device``, the device the QAT forward ran
    on, so they are the numbers the fitness was measured with."""
    if cfg.model == "mlp" and len(sizes) != 3:
        raise ValueError(
            f"the fused serving kernels cover the paper's 1-hidden-layer "
            f"printed-MLP topology; got sizes={tuple(sizes)}")
    dev = resolve_device(device)
    accs, params, masks, dps = (
        train_pareto_front(genomes, data, sizes, cfg, device=dev)
        if trained is None else trained)
    if len(accs) != len(genomes):
        raise ValueError(f"trained tuple covers {len(accs)} individuals, "
                         f"got {len(genomes)} genomes")
    spec = cfg.adc_spec.validate_channels(sizes[0])
    wb = cfg.weight_bits
    if cfg.faulttol is not None:
        # the masks from train_pareto_front already carry the spare
        # levels; the TMR/calibrate genes price the voter and
        # calibration-store overhead on the same budget axis
        _, _, tmrs, _, cals = decode_population_faulttol(
            genomes, sizes[0], cfg.bits, cfg.min_levels, cfg.faulttol)
    fe = cfg.frontend
    if fe is not None:
        # the masks from train_pareto_front already carry the alloc
        # ladder, so the baked table is the one the fitness measured
        _, _, subs, allocs = decode_population_cosearch(
            genomes, sizes[0], cfg.bits, cfg.min_levels, fe)
    designs = []
    for k in range(len(accs)):
        dp = float(dps[k])
        feature, fe_tc = None, 0
        if fe is not None:
            sub_f = fe.sub_grid[int(subs[k])]
            alloc_t = tuple(int(a) for a in allocs[k].tolist())
            feature = fe.bake(sub_f, alloc_t)
            fe_tc = feature_lib.frontend_tc(fe, sub_f, alloc_t)
        tmr, calibrated, ft_tc = None, False, 0
        if cfg.faulttol is not None:
            tmr = tmrs[k].numpy().astype(np.int32)
            calibrated = bool(int(cals[k]))
            ft_tc = area.faulttol_tc(np.asarray(masks[k], np.int32), tmr,
                                     calibrated)
        if cfg.model == "svm":
            w, b = (a[k] for a in params)
            weights = (_po2(w, dp, wb, dev), _fixed(b, dp, wb, dev))
        else:
            (w1, b1), (w2, b2) = [(layer[0][k], layer[1][k])
                                  for layer in params]
            weights = (_po2(w1, dp, wb, dev), _fixed(b1, dp, wb, dev),
                       _po2(w2, dp, wb, dev), _fixed(b2, dp, wb, dev))
        mask = np.asarray(masks[k], np.int32)
        designs.append(DeployedClassifier(
            kind=cfg.model, bits=spec.bits, mode=spec.mode,
            vmin=spec.vmin, vmax=spec.vmax, dp=dp, mask=mask,
            table=spec.value_table(torch.from_numpy(mask)).numpy(),
            weights=weights,
            area_tc=area.system_tc(mask, cfg.design) + fe_tc + ft_tc,
            accuracy=float(accs[k]), feature=feature, tmr=tmr,
            calibrated=calibrated))
    return designs


def verify_front_parity(designs: Sequence[DeployedClassifier],
                        genomes: np.ndarray, data: Dict,
                        sizes: Sequence[int], cfg: SearchConfig, *,
                        device: DeviceLike = None) -> bool:
    """Bit-for-bit contract check: re-train the given genomes through the
    batched fitness path and compare against the accuracies the designs
    report. Every QAT lane is a pure function of (genome, data, cfg), so
    this must hold exactly; any drift means the purity contract broke."""
    accs, _, _, _ = train_pareto_front(genomes, data, sizes, cfg,
                                       device=device)
    reported = np.array([d.accuracy for d in designs], np.float64)
    return bool(np.array_equal(np.asarray(accs, np.float64), reported))


def _po2(w, dp: float, weight_bits: int, device) -> np.ndarray:
    t = torch.as_tensor(np.asarray(w, np.float32)).to(device)
    return qat.quantize_po2(t, dp, weight_bits).cpu().numpy()


def _fixed(b, dp: float, weight_bits: int, device) -> np.ndarray:
    t = torch.as_tensor(np.asarray(b, np.float32)).to(device)
    return qat.quantize_fixed(t, dp, weight_bits).cpu().numpy()


# ----------------------------------------------------------------- save/load
def save_front(directory, designs: Sequence[DeployedClassifier],
               extra_meta: Optional[Dict] = None) -> None:
    """Persist a front under ``directory`` as step 0, in the reference's
    leaf layout (atomic commit, one .npy per leaf). A co-searched front
    carries its shared base FeatureSpec in the meta and each design's
    baked (subsample, alloc) as leaves."""
    if not designs:
        raise ValueError("refusing to save an empty front")
    kinds = {d.kind for d in designs}
    specs = {d.spec for d in designs}
    feats = {None if d.feature is None else d.feature.base()
             for d in designs}
    if len(kinds) != 1 or len(specs) != 1 or len(feats) != 1:
        raise ValueError(f"mixed fronts unsupported: kinds={kinds} "
                         f"specs={specs} features={feats}")
    meta = {"format": FORMAT_VERSION, "kind": designs[0].kind,
            **designs[0].spec.to_meta(),
            "num_designs": len(designs), **(extra_meta or {})}
    fe = next(iter(feats))
    if fe is not None:
        meta["feature"] = fe.to_meta()
    tree = {"meta": pack_json(meta)}
    for i, d in enumerate(designs):
        leaf = {"mask": d.mask.astype(np.int32), "table": d.table,
                "dp": np.float32(d.dp), "acc": np.float64(d.accuracy),
                "area_tc": np.int64(d.area_tc)}
        if d.feature is not None:
            leaf["subsample"] = np.int64(d.feature.subsample)
            leaf["alloc"] = np.asarray(d.feature.alloc, np.int32)
        if d.tmr is not None:
            leaf["tmr"] = np.asarray(d.tmr, np.int32)
        if d.tmr is not None or d.calibrated:
            leaf["calibrated"] = np.int64(d.calibrated)
        leaf.update(zip(_WEIGHT_LEAVES[d.kind], d.weights))
        tree[f"design_{i:03d}"] = leaf
    CheckpointManager(directory).save(0, tree)


def front_meta(directory) -> Dict:
    """The metadata ``save_front`` persisted (format/kind/bits plus any
    ``extra_meta`` provenance such as the training dataset)."""
    flat = CheckpointManager(directory).restore_flat(0)
    return unpack_json(flat["meta"])


def load_front(directory) -> List[DeployedClassifier]:
    """Inverse of ``save_front``, for fronts saved by either package.
    Every design goes through ``from_numpy``."""
    flat = CheckpointManager(directory).restore_flat(0)
    meta = unpack_json(flat["meta"])
    if meta["format"] != FORMAT_VERSION:
        raise ValueError(f"unknown front format {meta['format']}")
    fe = (FeatureSpec.from_meta(meta["feature"])
          if meta.get("feature") is not None else None)
    kind = meta["kind"]
    designs = []
    for i in range(meta["num_designs"]):
        p = f"design_{i:03d}/"
        feature = None
        if fe is not None:
            feature = fe.bake(int(flat[p + "subsample"]),
                              tuple(int(a) for a in flat[p + "alloc"]))
        designs.append(from_numpy(
            kind, meta, flat[p + "table"],
            tuple(flat[p + n] for n in _WEIGHT_LEAVES[kind]),
            mask=flat[p + "mask"], dp=flat[p + "dp"],
            area_tc=flat[p + "area_tc"], accuracy=flat[p + "acc"],
            tmr=flat.get(p + "tmr"),
            calibrated=bool(int(flat.get(p + "calibrated", 0))),
            feature=feature))
    return designs


# -------------------------------------------------------------- bank serving
def bank_arrays(designs: Sequence[DeployedClassifier]
                ) -> Tuple[np.ndarray, Tuple[np.ndarray, ...]]:
    """Stack a front into the bank kernel's operands: (tables (D, C, 2^N),
    weights each (D, ...)). Mixed kinds are rejected."""
    kinds = {d.kind for d in designs}
    if len(kinds) != 1:
        raise ValueError(f"bank needs one classifier kind, got {kinds}")
    tables = np.stack([d.table for d in designs])
    weights = tuple(np.stack([d.weights[j] for d in designs])
                    for j in range(len(designs[0].weights)))
    return tables, weights


def _bank_closure(designs: Sequence[DeployedClassifier], dev, mesh=None):
    """One bank call closed over ``designs``' tables, weights and range
    rows, moved to ``dev`` once: a featurized (M, C) tensor on ``dev``
    -> (D, M, O) logits. With ``mesh`` the operands are placed once per
    shard instead (``ops.bank_shards``: the D axis split by
    ``design_bank_axes``, or whole on the first device when nothing
    divides D) and each call launches one bank per shard."""
    specs = {d.spec for d in designs}
    if len(specs) != 1:
        raise ValueError(f"bank needs one AdcSpec, got {specs}")
    tables, weights = bank_arrays(designs)
    kind, spec = designs[0].kind, designs[0].spec
    if mesh is not None:
        shards = ops.bank_shards(tables, weights, mesh=mesh)
        return lambda xb: ops.classifier_bank_shards(xb, shards, kind=kind,
                                                     spec=spec)
    tables_t = torch.from_numpy(tables).to(dev)
    weights_t = tuple(torch.from_numpy(w).to(dev) for w in weights)
    rows = range_rows_tensors(spec.bits, spec.vmin, spec.vmax,
                              tables.shape[1], dev)
    return lambda xb: ops.classifier_bank(xb, tables_t, weights_t,
                                          kind=kind, spec=spec, rows=rows)


def make_bank_fn(designs: Sequence[DeployedClassifier], *,
                 device: DeviceLike = None, mesh=None
                 ) -> Callable[[object], torch.Tensor]:
    """The serving hot path: a closure (M, C) batch -> (D, M, O) logits
    over the whole front. Tables, weights and range rows move to
    ``device`` once, here, not once per microbatch; each call moves only
    the batch. With ``mesh`` (a ``launch.mesh.Mesh``) the design axis is
    split D/n over the mesh (``ops.classifier_bank_sharded``'s rule),
    the batch replicates and the logits gather on the mesh's first
    device (``device``, if also given, must be that device). A
    feature-baked front
    takes raw (M, W, C_raw) windows (``_make_feature_bank_fn``)."""
    dev = mesh_lib.work_device(device, mesh)
    designs = list(designs)
    if any(d.feature is not None for d in designs):
        return _make_feature_bank_fn(designs, dev, mesh)
    bank = _bank_closure(designs, dev, mesh)

    def fn(xb) -> torch.Tensor:
        xb = torch.as_tensor(xb, dtype=torch.float32).to(dev).contiguous()
        return bank(xb)

    return fn


def _feature_groups(designs: Sequence[DeployedClassifier]) -> Dict:
    """{subsample -> design indices} of a feature-baked front. The bank
    kernels take ONE shared sample batch, but co-searched designs can
    bake different subsample factors (different featurized views of the
    same windows), so serving runs one bank per subsample group. Mixed
    feature/tabular fronts and fronts of several base FeatureSpecs are
    refused."""
    withf = {d.feature is not None for d in designs}
    if len(withf) != 1:
        raise ValueError("mixed feature/tabular fronts unsupported")
    bases = {d.feature.base() for d in designs}
    if len(bases) != 1:
        raise ValueError(f"bank needs one base FeatureSpec, got {bases}")
    groups: Dict = {}
    for i, d in enumerate(designs):
        groups.setdefault(int(d.feature.subsample), []).append(i)
    return dict(sorted(groups.items()))


def _make_feature_bank_fn(designs: Sequence[DeployedClassifier], dev,
                          mesh=None) -> Callable[[object], torch.Tensor]:
    """The streaming twin of ``make_bank_fn``: (M, W, C_raw) windows ->
    (D, M, O) logits on ``dev``. Designs group by baked subsample
    factor; each group serves its own bank (operands on the device once)
    over ``feature.featurize_fn`` of its factor, the callable the search
    data was built with, so served accuracies reproduce the search
    fitness bit for bit; the group logits scatter back into front
    order on the device. With ``mesh`` each group's bank is split within
    the group (its D_g designs by ``design_bank_axes``; a group nothing
    divides serves whole on the first device), featurize runs on
    ``dev``, the mesh's first device."""
    groups = _feature_groups(designs)
    sub_banks = []
    for idx in groups.values():
        grp = [designs[i] for i in idx]
        sub_banks.append((torch.tensor(idx, device=dev),
                          feature_lib.featurize_fn(grp[0].feature),
                          _bank_closure(grp, dev, mesh)))

    def fn(xb) -> torch.Tensor:
        xb = feature_lib.as_windows(xb, dev)
        out = None
        for idx, feat, bank in sub_banks:
            lg = bank(feat(xb))
            if out is None:
                out = torch.empty((len(designs),) + tuple(lg.shape[1:]),
                                  dtype=lg.dtype, device=dev)
            out[idx] = lg
        return out

    return fn


def serve_bank(designs: Sequence[DeployedClassifier], x, *,
               device: DeviceLike = None, mesh=None) -> torch.Tensor:
    """One shared sample batch through the whole front: (D, M, O)
    logits on ``device`` (with ``mesh``: design-sharded, gathered on the
    mesh's first device). A feature-baked front takes raw (M, W, C_raw)
    windows and serves per subsample group."""
    return make_bank_fn(designs, device=device, mesh=mesh)(x)


def served_accuracies(designs: Sequence[DeployedClassifier], x, y, *,
                      device: DeviceLike = None, mesh=None) -> np.ndarray:
    """(D,) float32 test accuracies of the served front (raw windows for
    a feature-baked one; design-sharded over ``mesh`` if given): the
    round-trip check against each design's exported ``accuracy``."""
    logits = serve_bank(designs, x, device=device, mesh=mesh)
    y = torch.as_tensor(np.asarray(y)).to(logits.device)
    return _mean_acc(torch.argmax(logits, dim=-1) == y[None, :]).cpu().numpy()


# ----------------------------------------------------------------- robustness
def _stacked_model_params(designs: Sequence[DeployedClassifier], device):
    """The front's baked weights as the model family's params with a
    leading design axis, on ``device``: the structure
    ``search.mc_accuracies`` consumes."""
    w = tuple(torch.from_numpy(a).to(device)
              for a in bank_arrays(designs)[1])
    if designs[0].kind == "svm":
        return (w[0], w[1])
    return [(w[0], w[1]), (w[2], w[3])]


def _is_faulttol(designs, draws) -> bool:
    """A fault-tolerant front (TMR/calibrate provenance) or an explicit
    ``RedundantDraws`` stream evaluates through the calibrated-table
    entry."""
    return (isinstance(draws, ft_redundancy.RedundantDraws)
            or any(d.tmr is not None or d.calibrated for d in designs))


def _front_masks(designs) -> torch.Tensor:
    return torch.from_numpy(np.stack([np.asarray(d.mask, np.int32)
                                      for d in designs]))


def _front_genes(designs):
    """(tmr (D, C), cal (D,)) int32 of a front; zeros where a design has
    no TMR provenance."""
    c = designs[0].channels
    tmr = np.stack([np.zeros(c, np.int32) if d.tmr is None
                    else np.asarray(d.tmr, np.int32) for d in designs])
    cal = np.array([int(d.calibrated) for d in designs], np.int32)
    return tmr, cal


def _mc_views(designs, nonideal: NonIdealSpec, x: torch.Tensor, *,
              draws=None, samples: Optional[int] = None) -> torch.Tensor:
    """(D, S, M, C): the shared batch x through S perturbed instances of
    every design, one launch of the MC population entry (the
    calibrated-table one for a fault-tolerant front)."""
    spec = designs[0].spec
    masks = _front_masks(designs)
    dev = x.device
    c = masks.shape[1]
    s = samples if samples else 32
    if _is_faulttol(designs, draws):
        draws = (ft_redundancy.draw_redundant(spec.bits, c, s, nonideal,
                                              dev) if draws is None
                 else ft_redundancy.as_redundant_draws(draws, dev))
        tmr, cal = _front_genes(designs)
        operands = faulttol_cal.mc_operands_ft(spec, nonideal, masks, tmr,
                                               cal, draws, dev)
        return ops.mc_eval_cal_population(x, *operands, spec=spec)
    draws = (nonideal_lib.draw(spec.bits, c, s, nonideal, dev)
             if draws is None
             else nonideal_lib.as_draws(draws, dev, cls=nonideal_lib.Draws))
    operands = nonideal_lib.mc_operands(spec, nonideal, masks, draws=draws,
                                        device=dev)
    return ops.mc_eval_population(x, *operands, spec=spec)


def _mc_instance_accuracies(designs: Sequence[DeployedClassifier],
                            nonideal: NonIdealSpec, x, y, *, draws=None,
                            samples: Optional[int] = None,
                            device: DeviceLike = None) -> np.ndarray:
    """(D, S) float32 per-design, per-instance test accuracies of a
    deployed front under ``nonideal``: the MC views re-scored by each
    design's baked classifier through ``search.mc_accuracies``, the
    forward the search's robustness column used (dp=None: the baked
    weights are already quantized)."""
    dev = resolve_device(device)
    designs = list(designs)
    xd = torch.as_tensor(np.asarray(x, np.float32)).to(dev).contiguous()
    yd = torch.as_tensor(np.asarray(y)).to(dev)
    xq_mc = _mc_views(designs, nonideal, xd, draws=draws, samples=samples)
    acc = mc_accuracies(designs[0].kind, _stacked_model_params(designs, dev),
                        None, xq_mc, yd)
    return acc.cpu().numpy()


def evaluate_robustness(designs: Sequence[DeployedClassifier],
                        nonideal: NonIdealSpec, x, y, samples: int = 32, *,
                        draws=None,
                        yield_margins: Tuple[float, ...] = (0.01, 0.05),
                        device: DeviceLike = None) -> Dict:
    """Monte-Carlo robustness report of a deployed front: S perturbed
    hardware instances of every design against the shared (x, y) test
    set, on ``device`` (default ``cuda``). ``draws`` (numpy or tensors;
    a ``RedundantDraws`` for a fault-tolerant front) replaces the
    stream drawn from ``nonideal.seed``.

    Returns a JSON-able report, field for field the reference's: per
    design the exported accuracy, area, mean/worst/std over instances,
    the two search objectives (``expected_drop``, ``worst_case_error``),
    the yield at each of ``yield_margins`` and the per-instance
    accuracies. The reductions are the search's host-side f64 ones on
    the same instance accuracies, so a 3-objective front's third column
    is reproduced bit for bit from the same ``NonIdealSpec``."""
    designs = list(designs)
    mc_accs = _mc_instance_accuracies(designs, nonideal, x, y, draws=draws,
                                      samples=samples, device=device)
    exported = np.array([d.accuracy for d in designs])
    expected = nonideal_lib.robust_objective(exported, mc_accs, "expected")
    worst = nonideal_lib.robust_objective(exported, mc_accs, "worst")
    means = nonideal_lib.mc_mean_accuracy(mc_accs)
    rows = []
    for i, d in enumerate(designs):
        inst = mc_accs[i]
        rows.append({
            "exported_accuracy": float(d.accuracy),
            "area_tc": int(d.area_tc),
            "mean_accuracy": float(means[i]),
            "worst_accuracy": float(inst.min()),
            "std_accuracy": float(np.asarray(inst, np.float64).std()),
            "expected_drop": float(expected[i]),
            "worst_case_error": float(worst[i]),
            # the f64 count the search's 'yield' column reduces
            "yield": {f"{m:g}": float(nonideal_lib.yield_fraction(
                np.float64(d.accuracy), inst[None], m)[0])
                for m in yield_margins},
            "instance_accuracies": [float(a) for a in inst],
        })
    return {"nonideal": nonideal.to_meta(), "samples": int(mc_accs.shape[1]),
            "yield_margins": [float(m) for m in yield_margins],
            "kind": designs[0].kind, "num_designs": len(designs),
            "designs": rows}


def robustness_curve(designs: Sequence[DeployedClassifier], x, y,
                     sigmas: Sequence[float], samples: int = 32, *,
                     base: Optional[NonIdealSpec] = None,
                     device: DeviceLike = None) -> Dict:
    """Accuracy-vs-sigma sweep: one ``evaluate_robustness`` report per
    comparator-offset sigma (other knobs from ``base``). The sigma=0
    point of an all-zero ``base`` reproduces the exported accuracies."""
    base = base if base is not None else NonIdealSpec()
    points = [evaluate_robustness(designs, base.replace(sigma_offset=s), x,
                                  y, samples, device=device)
              for s in sigmas]
    return {"sigma_offset": [float(s) for s in sigmas],
            "samples": samples, "base": base.to_meta(),
            "mean_accuracy": [[d["mean_accuracy"] for d in p["designs"]]
                              for p in points],
            "points": points}


def save_robustness(directory, report: Dict) -> None:
    """Persist a robustness report or curve next to the front artifact,
    as ``<front-dir>/robustness.json``."""
    path = Path(directory)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "robustness.json", "w") as f:
        json.dump(report, f, indent=1)


def load_robustness(directory) -> Dict:
    with open(Path(directory) / "robustness.json") as f:
        return json.load(f)


def _instance_slice(draws, instance: int):
    return type(draws)(*(a[instance:instance + 1] for a in draws))


def _check_instance(instance: int, samples: Optional[int]) -> int:
    samples = instance + 1 if samples is None else samples
    if not 0 <= instance < samples:
        raise ValueError(f"instance {instance} outside the "
                         f"{samples}-sample MC stream")
    return samples


def _bank_forward(designs, device):
    """(D, 1, M, C) perturbed views -> (D, M, O) logits through the
    designs' baked classifiers, in the fixed-order forward the
    robustness accuracies use."""
    params = _stacked_model_params(designs, device)
    apply = (svm_lib.apply_svm_fixed_order if designs[0].kind == "svm"
             else mlp_lib.apply_mlp_fixed_order)
    return lambda xq: apply(params, xq)[:, 0]


def make_nonideal_bank_fn(designs: Sequence[DeployedClassifier],
                          nonideal: NonIdealSpec, *, instance: int = 0,
                          samples: Optional[int] = None,
                          device: DeviceLike = None
                          ) -> Callable[[object], torch.Tensor]:
    """The serving closure through one *sampled non-ideal hardware
    instance*: (M, C) samples -> (D, M, O) logits on ``device``, the
    degraded twin of ``make_bank_fn``. The instance's interval tables and
    drifted rows are built once, here. ``samples`` names the MC stream
    ``instance`` indexes: pass a report's ``samples`` to serve exactly
    the instance whose accuracy it lists (``instance_accuracies
    [instance]``); None draws a minimal ``instance + 1``-sample stream."""
    dev = resolve_device(device)
    designs = list(designs)
    spec = designs[0].spec
    samples = _check_instance(instance, samples)
    masks = _front_masks(designs)
    draws = nonideal_lib.draw(spec.bits, masks.shape[1], samples, nonideal,
                              dev)
    operands = nonideal_lib.mc_operands(
        spec, nonideal, masks, draws=_instance_slice(draws, instance),
        device=dev)
    forward = _bank_forward(designs, dev)

    def fn(xb) -> torch.Tensor:
        xb = torch.as_tensor(xb, dtype=torch.float32).to(dev).contiguous()
        with torch.no_grad():
            return forward(ops.mc_eval_population(xb, *operands, spec=spec))

    return fn


def _measured_instance(designs: Sequence[DeployedClassifier],
                       nonideal: NonIdealSpec, instance: int,
                       samples: Optional[int], device):
    """The shared front half of the calibration paths: re-derive the
    redundant MC stream (the one the search and ``evaluate_robustness``
    consume, same ``samples`` semantics as ``make_nonideal_bank_fn``),
    slice the measured ``instance`` and compile the calibrated-table
    operands for the whole front with the calibrate action on."""
    spec = designs[0].spec
    samples = _check_instance(instance, samples)
    masks = _front_masks(designs)
    draws = ft_redundancy.draw_redundant(spec.bits, masks.shape[1],
                                         samples, nonideal, device)
    tmr, _ = _front_genes(designs)
    cal = np.ones(len(designs), np.int32)
    return spec, faulttol_cal.mc_operands_ft(
        spec, nonideal, masks, tmr, cal, _instance_slice(draws, instance),
        device)


def calibrate_front(designs: Sequence[DeployedClassifier],
                    nonideal: NonIdealSpec, *, instance: int = 0,
                    samples: Optional[int] = None,
                    device: DeviceLike = None) -> List[DeployedClassifier]:
    """Re-bake a deployed front against ONE measured hardware instance:
    each design's value table becomes the measured interval midpoints
    (``faulttol.calibrated_value_rows``) and its range the instance's
    drifted range, so the ideal serving path (``make_bank_fn``) then
    reconstructs through calibrated values: code ``k``'s entry is the
    calibrated value of the measured leaf interval holding that code's
    midpoint. Residual comparator offsets still move leaf boundaries off
    the integer grid; ``make_calibrated_bank_fn`` serves the instance's
    exact interval walk. For an all-zero ``NonIdealSpec`` and an
    unpruned design the re-bake gives back the nominal table. The
    operands are compiled on ``device`` (default ``cuda``); the re-bake
    itself is f64 numpy, as in the reference."""
    dev = resolve_device(device)
    designs = list(designs)
    spec, (lb, ub, values, lo, scale) = _measured_instance(
        designs, nonideal, instance, samples, dev)
    lb, ub, values = (t.cpu().numpy() for t in (lb, ub, values))
    n = 2 ** spec.bits
    lo0 = lo.cpu().numpy().astype(np.float64)[0]                  # (C,)
    scale0 = scale.cpu().numpy().astype(np.float64)[0]
    vmin = tuple(float(v) for v in lo0)
    vmax = tuple(float(v) for v in lo0 + n / scale0)
    probes = np.arange(n, dtype=np.float64) + 0.5    # measured code units
    out = []
    for k, d in enumerate(designs):
        lbk = np.asarray(lb[k, 0], np.float64)                     # (C, n)
        ubk = np.asarray(ub[k, 0], np.float64)
        vals = np.asarray(values[k, 0], np.float32)                # leaf values
        # sel[c, code, leaf]: the probes partition over the measured leaf
        # intervals, exactly one live term per code
        sel = ((probes[None, :, None] >= lbk[:, None, :])
               & (probes[None, :, None] < ubk[:, None, :]))
        table = (sel * vals[:, None, :]).sum(-1).astype(np.float32)
        out.append(dataclass_replace(d, table=table, vmin=vmin, vmax=vmax,
                                     calibrated=True))
    return out


def make_calibrated_bank_fn(designs: Sequence[DeployedClassifier],
                            nonideal: NonIdealSpec, *, instance: int = 0,
                            samples: Optional[int] = None,
                            device: DeviceLike = None
                            ) -> Callable[[object], torch.Tensor]:
    """The calibrated twin of ``make_nonideal_bank_fn``: (M, C) samples
    -> (D, M, O) logits through a sampled instance's exact measured
    interval walk with per-design re-baked value tables (the
    ``mc_eval_cal_population`` entry)."""
    dev = resolve_device(device)
    designs = list(designs)
    spec, operands = _measured_instance(designs, nonideal, instance,
                                        samples, dev)
    forward = _bank_forward(designs, dev)

    def fn(xb) -> torch.Tensor:
        xb = torch.as_tensor(xb, dtype=torch.float32).to(dev).contiguous()
        with torch.no_grad():
            return forward(ops.mc_eval_cal_population(xb, *operands,
                                                      spec=spec))

    return fn
