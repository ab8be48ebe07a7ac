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
plain versions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import (CheckpointManager, pack_json,
                                            unpack_json)
from repro_torch.core import area, qat
from repro_torch.core.adc import range_rows_tensors
from repro_torch.core.search import SearchConfig, train_pareto_front
from repro_torch.core.spec import AdcSpec, Range
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.mlp import mean_accuracy as _mean_acc

FORMAT_VERSION = 1

# weight leaf names per classifier family, in ops.classifier_bank order
_WEIGHT_LEAVES = {"mlp": ("w1", "b1", "w2", "b2"), "svm": ("w", "b")}

_STREAMING_LATER = ("fronts with a baked FeatureSpec (streaming "
                    "co-design) are not served by this port yet: the "
                    "streaming slice (ROADMAP A8) ports them")


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
    # fault-tolerance provenance (per-channel TMR genes, calibrate gene),
    # carried through save/load; serving does not read them
    tmr: Optional[np.ndarray] = None
    calibrated: bool = False

    @property
    def spec(self) -> AdcSpec:
        return AdcSpec(bits=self.bits, mode=self.mode, vmin=self.vmin,
                       vmax=self.vmax)

    @property
    def channels(self) -> int:
        """ADC input channel count C."""
        return int(self.table.shape[0])

    def logits(self, x, *, device: DeviceLike = None) -> torch.Tensor:
        """Samples (M, C) -> (M, O) logits on ``device``, served as a
        size-1 bank."""
        return serve_bank([self], x, device=device)[0]

    def predict(self, x, *, device: DeviceLike = None) -> torch.Tensor:
        return torch.argmax(self.logits(x, device=device), dim=-1)

    def accuracy_on(self, x, y, *, device: DeviceLike = None) -> float:
        pred = self.predict(x, device=device)
        y = torch.as_tensor(np.asarray(y)).to(pred.device)
        return float(_mean_acc(pred[None] == y[None])[0])


def from_numpy(kind: str, spec_meta: Dict, table, weights, *, mask, dp,
               area_tc, accuracy, tmr=None, calibrated: bool = False
               ) -> DeployedClassifier:
    """Carry one design's arrays (as the JAX package exports and saves
    them) into a port ``DeployedClassifier``, checking kind, spec, dtypes
    and shapes: ``table`` (C, 2^N) float32; ``weights`` in
    ``_WEIGHT_LEAVES[kind]`` order ((C, H), (H,), (H, O), (O,) for an MLP;
    (C, O), (O,) for an SVM); ``mask`` (C, 2^N)."""
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
    return DeployedClassifier(
        kind=kind, bits=spec.bits, mode=spec.mode, vmin=spec.vmin,
        vmax=spec.vmax, dp=float(dp), mask=mask, table=table,
        weights=weights, area_tc=int(area_tc), accuracy=float(accuracy),
        tmr=None if tmr is None else np.asarray(tmr, np.int32),
        calibrated=bool(calibrated))


# -------------------------------------------------------- search -> artifact
def export_front(genomes: np.ndarray, data: Dict, sizes: Sequence[int],
                 cfg: SearchConfig, trained=None, *,
                 device: DeviceLike = None) -> List[DeployedClassifier]:
    """Freeze (typically Pareto-front) genomes into deployable designs:
    deterministic QAT re-train (``search.train_pareto_front``) on
    ``device``, bake value tables, quantize the trained weights once with
    each genome's dp, and attach the exact transistor-count area.

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
    designs = []
    for k in range(len(accs)):
        dp = float(dps[k])
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
            weights=weights, area_tc=area.system_tc(mask, cfg.design),
            accuracy=float(accs[k])))
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
    leaf layout (atomic commit, one .npy per leaf)."""
    if not designs:
        raise ValueError("refusing to save an empty front")
    kinds = {d.kind for d in designs}
    specs = {d.spec for d in designs}
    if len(kinds) != 1 or len(specs) != 1:
        raise ValueError(f"mixed fronts unsupported: kinds={kinds} "
                         f"specs={specs}")
    meta = {"format": FORMAT_VERSION, "kind": designs[0].kind,
            **designs[0].spec.to_meta(),
            "num_designs": len(designs), **(extra_meta or {})}
    tree = {"meta": pack_json(meta)}
    for i, d in enumerate(designs):
        leaf = {"mask": d.mask.astype(np.int32), "table": d.table,
                "dp": np.float32(d.dp), "acc": np.float64(d.accuracy),
                "area_tc": np.int64(d.area_tc)}
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
    if meta.get("feature") is not None:
        raise NotImplementedError(_STREAMING_LATER)
    kind = meta["kind"]
    designs = []
    for i in range(meta["num_designs"]):
        p = f"design_{i:03d}/"
        designs.append(from_numpy(
            kind, meta, flat[p + "table"],
            tuple(flat[p + n] for n in _WEIGHT_LEAVES[kind]),
            mask=flat[p + "mask"], dp=flat[p + "dp"],
            area_tc=flat[p + "area_tc"], accuracy=flat[p + "acc"],
            tmr=flat.get(p + "tmr"),
            calibrated=bool(int(flat.get(p + "calibrated", 0)))))
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


def make_bank_fn(designs: Sequence[DeployedClassifier], *,
                 device: DeviceLike = None
                 ) -> Callable[[object], torch.Tensor]:
    """The serving hot path: a closure (M, C) batch -> (D, M, O) logits
    over the whole front. Tables, weights and range rows move to
    ``device`` once, here, not once per microbatch; each call moves only
    the batch."""
    dev = resolve_device(device)
    designs = list(designs)
    specs = {d.spec for d in designs}
    if len(specs) != 1:
        raise ValueError(f"bank needs one AdcSpec, got {specs}")
    tables, weights = bank_arrays(designs)
    tables_t = torch.from_numpy(tables).to(dev)
    weights_t = tuple(torch.from_numpy(w).to(dev) for w in weights)
    d0 = designs[0]
    spec = d0.spec
    rows = range_rows_tensors(spec.bits, spec.vmin, spec.vmax,
                              tables.shape[1], dev)

    def fn(xb) -> torch.Tensor:
        xb = torch.as_tensor(xb, dtype=torch.float32).to(dev).contiguous()
        return ops.classifier_bank(xb, tables_t, weights_t, kind=d0.kind,
                                   spec=spec, rows=rows)

    return fn


def serve_bank(designs: Sequence[DeployedClassifier], x, *,
               device: DeviceLike = None) -> torch.Tensor:
    """One shared sample batch through the whole front: (D, M, O)
    logits on ``device``."""
    return make_bank_fn(designs, device=device)(x)


def served_accuracies(designs: Sequence[DeployedClassifier], x, y, *,
                      device: DeviceLike = None) -> np.ndarray:
    """(D,) float32 test accuracies of the served front: the round-trip
    check against each design's exported ``accuracy``."""
    logits = serve_bank(designs, x, device=device)
    y = torch.as_tensor(np.asarray(y)).to(logits.device)
    return _mean_acc(torch.argmax(logits, dim=-1) == y[None, :]).cpu().numpy()
