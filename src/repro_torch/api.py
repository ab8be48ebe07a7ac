"""repro_torch.api: the paper's pipeline as one facade. Counterpart of
``repro/api.py`` (the verbs of the search slice)::

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

Every verb runs on the card (``device=None`` means ``cuda``) unless the
caller passes ``device="cpu"``. It is a thin composition of core/search,
core/deploy and kernels/ops, so the search -> export -> load -> serve
contract holds through the facade: ``bank.accuracies(x_test, y_test)``
equals the search-time fitness exactly.
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

__all__ = [
    "AdcSpec",
    "Bank",
    "DeployedClassifier",
    "FaultTolSpec",
    "Front",
    "NonIdealSpec",
    "SearchConfig",
    "calibrate",
    "deploy",
    "evaluate_robustness",
    "load_front",
    "quantize",
    "robustness_curve",
    "save_front",
    "search",
    "search_gradient",
    "serve",
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

    def logits(self, x, *, device: DeviceLike = None) -> torch.Tensor:
        """(M, C) samples -> (D, M, O) logits through the fused
        multi-design bank kernel."""
        return _deploy.serve_bank(self.designs, x, device=device)

    def predict(self, x, **kw) -> torch.Tensor:
        return torch.argmax(self.logits(x, **kw), dim=-1)

    def accuracies(self, x, y, *, device: DeviceLike = None) -> np.ndarray:
        """(D,) served accuracies: bit for bit the exported (== search
        fitness) accuracies."""
        return _deploy.served_accuracies(self.designs, x, y, device=device)

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
           **cfg_kw) -> Front:
    """Run the paper's in-training ADC optimization around ``spec``.

    data: dict with x_train/y_train/x_test/y_test (data.tabular layout).
    sizes: (features, hidden, classes); inferred from the data (with
    ``hidden`` hidden units) when omitted. Remaining kwargs mirror
    core/search.SearchConfig; ``engine`` picks batched | reference |
    gradient, ``ckpt``/``resume`` checkpoint the search and restart it
    (``checkpoint.manager.CheckpointManager``). Returns a ``Front``
    carrying the Pareto genomes, their fitness, and the trained
    parameter stacks ``deploy`` reuses."""
    dev = resolve_device(device)
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
                                            return_trained=True, device=dev)
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
          device: DeviceLike = None) -> torch.Tensor:
    """One shared (M, C) sample batch through the whole deployed bank:
    (D, M, O) logits through the fused multi-design kernel."""
    designs = bank.designs if isinstance(bank, Bank) else tuple(bank)
    return _deploy.serve_bank(designs, x, device=device)


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
