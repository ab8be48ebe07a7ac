"""In-training ADC optimization (paper §3.2): NSGA-II over per-channel
level masks + weight decimal positions, with quantization-aware training
in the inner loop, minimizing {1 - accuracy, normalized ADC area}.
Counterpart of ``repro/core/search.py`` (the batched and reference
engines, two objectives).

A generation is one batched program: genomes decode to a (P, C, 2^N)
mask batch, the shared train and test batches each go through all P
pruned ADC banks in one launch of the population quantizer
(kernels/ops.adc_quantize_population, the hand-written kernel on the
card), and the P QAT loops run side by side as explicit (P, ...)
parameter stacks: the loss is the sum of the per-lane losses, so each
lane's gradient is its own. ``evaluate_population_reference`` keeps the
paper's per-individual path as the parity oracle.

Lane purity. Every QAT lane must be a pure function of its genome:
``train_pareto_front`` re-trains a front and must reproduce its search
fitness bit for bit (``deploy.verify_front_parity``), and dedup changes
how many distinct genomes a generation trains. On the card a reduction's
split and a batched product's algorithm may depend on the lane count, so
every QAT call here runs at one fixed lane count, ``cfg.pop_size``: a
smaller batch is padded by repeating its first genome, a larger one is
cut into chunks. A lane's result then never depends on how many other
genomes were trained with it.

Initial weights come from a ``torch.Generator`` seeded with ``cfg.seed``:
a documented stream, different from the reference's ``jax.random`` one.
Tests inject the reference's initial parameters through ``init_params``
(``stacked_init_from_numpy``) so both packages start from one point.

Robustness (a ``NonIdealSpec`` and ``mc_samples > 0``) adds a third
minimized column: after the QAT, the Monte-Carlo population kernel
(kernels/mc_eval.py) pushes the test split through ``mc_samples``
perturbed instances of every individual's ADC in one launch, the trained
lanes re-score each perturbed view, and ``nonideal.robust_objective``
reduces the (P, S) instance accuracies on the host in f64 ('expected'
drop, 'worst'-case error or 1 - 'yield'@margin). The draw block is drawn
once per run (``search_draws``), common to every individual and
generation. A ``FaultTolSpec`` appends redundancy genes (per-channel TMR
and spare levels, a global calibrate bit), folds TMR into the draws and
calibration into per-design value tables, and runs the calibrated-table
population entry instead. ``deploy.evaluate_robustness`` re-derives the
same draws from the spec and scores through the same forward
(``models.mlp.accuracy``), so a deployed report reproduces the searched
third column bit for bit.

Search state checkpoints through checkpoint/manager.py: genomes, fitness
matrix, the numpy Generator's state, the generation counter and, for a
screened search, the surrogate's leaves, in the reference's format, so a
killed search resumes bit-identically (``run_search(..., ckpt=...,
resume=True)``) and either package restores the other's steps.

``screen_factor > 1`` oversamples each generation's offspring and lets
the online surrogate (core/surrogate.py) pick which ``pop_size`` pay the
exact evaluation. ``engine='gradient'`` (``run_gradient_search``) trains
a family of gated designs in one run (core/grad_gates.py) and re-scores
its snapped genomes through the exact path. ``full_adc_baseline`` gives
the paper's Table 5 "Baseline" column.

Genome layout per individual (C input channels, N-bit ADC):
  [ C * 2^N mask bits | 4 bits decimal-point position (dp in [-8, 7])
    | fault-tolerance genes, with a FaultTolSpec
    | feature genes, with a frontend ]

Sensor -> feature -> ADC -> classifier co-search: a config with
``frontend`` (a ``timeseries.feature.FeatureSpec``) appends a
subsample-grid index and a 2-bit allocation gene per feature channel
after the dp bits, and the data dict stacks one featurized variant per
subsample factor ((V, M, C) instead of (M, C)). Every engine searches
the joint space: the batched one quantizes the whole variant stack in
one launch per split (``ops.adc_quantize_variants``) and each lane then
gathers its own variant, the reference one gathers and then quantizes.
A frontend and the Monte-Carlo objective exclude each other, as in the
reference.

The sharded engine (``engine='sharded'``,
``evaluate_population_sharded``) splits each generation's unique genomes
over a ``launch.mesh.Mesh`` by ``distributed/sharding.population_axes``.
Each shard trains its slice through ``_fixed_lanes`` on its own device,
padded to ``cfg.pop_size`` lanes like any other batch, so the sharded
fitness equals the batched engine's bit for bit; the price is a full
QAT chunk per shard. The dataset and the Monte-Carlo draw block are
copied once per distinct mesh device per search and never sliced
(common random numbers stay common across shards). When no rule divides
the unique count, one shard runs on the mesh's first device. The batched
engine is this engine on a mesh of one entry.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import manager
from repro_torch.core import adc, area, grad_gates, nsga2
from repro_torch.core import nonideal as nonideal_lib
from repro_torch.core import surrogate as surrogate_lib
from repro_torch.core.nonideal import NonIdealSpec
from repro_torch.core.spec import AdcSpec, Range, normalize_range
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding
from repro_torch.faulttol import calibrate as faulttol_cal
from repro_torch.faulttol import redundancy as ft_redundancy
from repro_torch.faulttol.spec import FaultTolSpec
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import svm as svm_lib
from repro_torch.optim import adamw
from repro_torch.timeseries import feature as feature_lib
from repro_torch.timeseries.feature import ALLOC_BITS, FULL_ALLOC, FeatureSpec

DP_BITS = 4


@dataclass(frozen=True)
class SearchConfig:
    bits: int = 4
    pop_size: int = 32
    generations: int = 16
    train_steps: int = 300
    lr: float = 5e-2
    weight_bits: int = 8
    min_levels: int = 2
    seed: int = 0
    mode: str = "tree"            # circuit-faithful pruned-ADC semantics
    design: str = "ours"          # area model used in the fitness
    model: str = "mlp"            # 'mlp' | 'svm'
    # 'batched' | 'sharded' | 'reference' | 'gradient'
    engine: str = "batched"
    # exact-duplicate genome dedup before QAT (identical individuals in a
    # generation share one lane; fitness bit-identical either way)
    dedup: bool = True
    # surrogate-screened NSGA-II: > 1 oversamples each generation's
    # offspring by this factor and keeps the pop_size candidates a tiny
    # online-trained fitness predictor ranks best; 1 leaves the
    # evolutionary stream as it is
    screen_factor: int = 1
    surrogate_steps: int = 64     # predictor train steps per observation
    surrogate_hidden: int = 32
    # gradient engine: lane count (0 -> 4 * pop_size), the log-spaced
    # area-weight sweep across lanes, the gate temperature anneal, the
    # soft value table's sharpness, and the per-chunk snapshot count
    # (also the checkpoint granularity)
    grad_points: int = 0
    grad_train_steps: int = 0     # gate-train budget; 0 -> 8 * train_steps
    grad_lambda_lo: float = 3e-2
    grad_lambda_hi: float = 10.0
    grad_tau0: float = 4.0
    grad_tau1: float = 0.25
    grad_beta: float = 2.0
    grad_snapshots: int = 4
    # surrogate-screened exact polish after the re-score: each round
    # flips every single gene of the elite (Pareto set plus the
    # grad_polish_beam most accurate rows), the surrogate ranks the
    # unseen neighbours (accuracy predicted, area exact), and the best
    # grad_polish_evals go through the exact evaluation
    grad_polish_rounds: int = 2
    grad_polish_beam: int = 4
    grad_polish_evals: int = 192
    # analog range: scalar or per-channel tuple
    vmin: Range = 0.0
    vmax: Range = 1.0
    # robustness-aware search: with a NonIdealSpec and mc_samples > 0 the
    # fitness grows a third minimized column over the MC instances
    nonideal: Optional[NonIdealSpec] = None
    mc_samples: int = 0
    robust_objective: str = "expected"    # 'expected' | 'worst' | 'yield'
    # the 'yield' column counts instances within yield_margin of the
    # ideal accuracy (minimized as 1 - yield)
    yield_margin: float = 0.01
    # fault-tolerant search: redundancy/repair genes, routed through the
    # calibrated-table MC entry; needs the robustness objective
    faulttol: Optional[FaultTolSpec] = None
    # sensor -> feature -> ADC -> classifier co-search: a FeatureSpec
    # appends feature genes to the genome and switches the data contract
    # to stacked featurized variants (V, M, C_feat)
    frontend: Optional[FeatureSpec] = None

    def __post_init__(self):
        object.__setattr__(self, "vmin", normalize_range(self.vmin))
        object.__setattr__(self, "vmax", normalize_range(self.vmax))
        if self.engine not in ("batched", "sharded", "reference",
                               "gradient"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.screen_factor < 1:
            raise ValueError(f"screen_factor must be >= 1, got "
                             f"{self.screen_factor}")
        if self.grad_lambda_lo <= 0 or self.grad_lambda_hi <= 0:
            raise ValueError("grad_lambda_lo/hi must be > 0 (log-spaced "
                             "sweep)")
        if self.grad_polish_rounds < 0 or self.grad_polish_beam < 1 \
                or self.grad_polish_evals < 1:
            raise ValueError("grad_polish_rounds must be >= 0 and "
                             "grad_polish_beam/evals >= 1")
        nonideal_lib.robust_objective_name(self.robust_objective)
        if self.mc_samples < 0:
            raise ValueError(f"mc_samples must be >= 0, got "
                             f"{self.mc_samples}")
        if self.frontend is not None and self.mc_samples > 0:
            raise ValueError(
                "the feature-frontend co-search and the Monte-Carlo "
                "robustness objective are mutually exclusive: the MC "
                "kernel family consumes flat (M, C) test batches, not "
                "the co-search's stacked (V, M, C) variant data")
        if not 0.0 <= self.yield_margin < 1.0:
            raise ValueError(f"yield_margin must be in [0, 1), got "
                             f"{self.yield_margin}")
        if self.faulttol is not None and not self.wants_robustness:
            raise ValueError(
                "fault-tolerant search needs the Monte-Carlo robustness "
                "objective (a NonIdealSpec and mc_samples > 0): "
                "redundancy genes only matter under the perturbed "
                "instance stream")
        if self.model not in ("mlp", "svm"):
            raise ValueError(f"unknown model {self.model!r}")
        if self.pop_size < 1:
            raise ValueError(f"pop_size must be >= 1, got {self.pop_size}")

    @property
    def wants_robustness(self) -> bool:
        """True when the search optimizes the third (robustness)
        objective."""
        return self.nonideal is not None and self.mc_samples > 0

    @property
    def n_objectives(self) -> int:
        return 3 if self.wants_robustness else 2

    @property
    def adc_spec(self) -> AdcSpec:
        """The ADC design point this search optimizes around."""
        return AdcSpec(bits=self.bits, mode=self.mode, vmin=self.vmin,
                       vmax=self.vmax)

    @classmethod
    def for_spec(cls, spec: AdcSpec, **kw) -> "SearchConfig":
        """Build a config around an AdcSpec (the api entry path)."""
        return cls(bits=spec.bits, mode=spec.mode, vmin=spec.vmin,
                   vmax=spec.vmax, **kw)


def genome_len(channels: int, bits: int,
               faulttol: Optional[FaultTolSpec] = None, *,
               frontend: Optional[FeatureSpec] = None) -> int:
    """Genome length: masks and dp, then the feature genes of a
    ``frontend``, then the fault-tolerance genes (the reference's
    ``genome_len(channels, bits, frontend, faulttol)``; here ``faulttol``
    stays third and ``frontend`` is keyword-only)."""
    base = channels * 2 ** bits + DP_BITS
    base += frontend.gene_bits if frontend is not None else 0
    return base + (faulttol.gene_bits(channels)
                   if faulttol is not None else 0)


def _faulttol_genes(genomes, channels: int, bits: int, ft: FaultTolSpec):
    """(..., G) genomes -> (tmr (..., C), spares (..., C), cal (...))
    int32: the fault-tolerance genes after the dp bits."""
    base = channels * 2 ** bits + DP_BITS
    g = np.asarray(genomes, np.uint8)
    return ft_redundancy.decode_genes(
        g[..., base:base + ft.gene_bits(channels)], channels, ft)


def decode_population_faulttol(genomes, channels: int, bits: int,
                               min_levels: int, faulttol: FaultTolSpec):
    """FT decode on the CPU: (P, G) -> (masks (P, C, 2^N) with the spare
    levels applied after repair (``adc.add_levels``), dps (P,) float32,
    tmr (P, C), spares (P, C), cal (P,)). The spare-augmented mask is
    the one the fitness quantizes through and the area walk prices."""
    masks, dps = decode_population(genomes, channels, bits, min_levels)
    tmr, spares, cal = _faulttol_genes(genomes, channels, bits, faulttol)
    return adc.add_levels(masks, spares), dps, tmr, spares, cal


def decode_genome_faulttol(genome, channels: int, bits: int,
                           min_levels: int, faulttol: FaultTolSpec):
    """Single-genome FT decode -> (mask, dp, tmr, spares, cal)."""
    masks, dps, tmr, spares, cal = decode_population_faulttol(
        np.asarray(genome)[None], channels, bits, min_levels, faulttol)
    return masks[0], dps[0], tmr[0], spares[0], cal[0]


def _frontend_genes(genomes, channels: int, bits: int,
                    frontend: FeatureSpec
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P, G) genomes -> (sub (P,) int32 indices into frontend.sub_grid,
    alloc (P, C) int32 in [0, FULL_ALLOC]), on the CPU. Feature genes sit
    after the dp bits, LSB first: the layout feature.encode_genes
    writes."""
    g = torch.as_tensor(np.asarray(genomes, np.uint8))
    base = channels * 2 ** bits + DP_BITS
    sb = frontend.sub_bits
    if sb:
        subb = g[:, base:base + sb].to(torch.int64)
        sub = (subb * (2 ** torch.arange(sb))[None, :]).sum(-1)
    else:
        sub = torch.zeros(g.shape[0], dtype=torch.int64)
    ab = g[:, base + sb:base + sb + channels * ALLOC_BITS].to(torch.int64)
    ab = ab.reshape(-1, channels, ALLOC_BITS)
    alloc = (ab * (2 ** torch.arange(ALLOC_BITS))[None, None, :]).sum(-1)
    return sub.to(torch.int32), alloc.to(torch.int32)


def _alloc_masks(masks: torch.Tensor, alloc: torch.Tensor, bits: int,
                 min_levels: int) -> torch.Tensor:
    """Apply the per-channel resolution-allocation ladder to repaired
    masks (P, C, 2^N): alloc a in [1, FULL_ALLOC] keeps every
    2^(FULL_ALLOC - a)-th level (then repairs again, so min_levels still
    holds); a = 0 turns the channel off, a one-hot level-0 mask (a
    constant input, zero comparators). The off override comes after the
    repair, which would otherwise re-enable levels on a dead channel."""
    n = 2 ** bits
    idx = torch.arange(n)
    stride = torch.pow(2, FULL_ALLOC - alloc.clamp(1, FULL_ALLOC))
    allowed = (idx[None, None, :] % stride[..., None]) == 0     # (P, C, n)
    laddered = adc.repair_mask(masks * allowed.to(torch.int32), min_levels)
    onehot0 = torch.zeros(n, dtype=torch.int32)
    onehot0[0] = 1
    return torch.where((alloc == 0)[..., None], onehot0[None, None, :],
                       laddered)


def decode_population_cosearch(genomes, channels: int, bits: int,
                               min_levels: int, frontend: FeatureSpec):
    """Co-search decode on the CPU: (P, G) -> (masks (P, C, 2^N) with the
    allocation ladder applied, dps (P,) float32, sub (P,) variant
    indices, alloc (P, C))."""
    masks, dps = decode_population(genomes, channels, bits, min_levels)
    sub, alloc = _frontend_genes(genomes, channels, bits, frontend)
    return _alloc_masks(masks, alloc, bits, min_levels), dps, sub, alloc


def decode_genome_cosearch(genome, channels: int, bits: int,
                           min_levels: int, frontend: FeatureSpec):
    """Single-genome co-search decode -> (mask, dp, sub, alloc)."""
    masks, dps, sub, alloc = decode_population_cosearch(
        np.asarray(genome)[None], channels, bits, min_levels, frontend)
    return masks[0], dps[0], sub[0], alloc[0]


def _decode_masks(genomes, channels: int, cfg: "SearchConfig"):
    """(masks, dps, tmr, cal, sub, alloc) of a (P, G) batch under
    ``cfg``: the FT decode (spare-applied masks) with a FaultTolSpec, the
    co-search decode (alloc-applied masks) with a frontend, else the
    plain one; tmr/cal None without a FaultTolSpec, sub/alloc None
    without a frontend."""
    if cfg.frontend is not None:
        masks, dps, sub, alloc = decode_population_cosearch(
            genomes, channels, cfg.bits, cfg.min_levels, cfg.frontend)
        return masks, dps, None, None, sub, alloc
    if cfg.faulttol is not None:
        masks, dps, tmr, _, cal = decode_population_faulttol(
            genomes, channels, cfg.bits, cfg.min_levels, cfg.faulttol)
        return masks, dps, tmr, cal, None, None
    masks, dps = decode_population(genomes, channels, cfg.bits,
                                   cfg.min_levels)
    return masks, dps, None, None, None, None


def decode_population(genomes, channels: int, bits: int,
                      min_levels: int = 2
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P, G) uint8 genomes -> (masks (P, C, 2^N) int32, dp (P,) float32),
    on the CPU. Pure reshape and arithmetic; ``repair_mask`` is batched
    over the population axis."""
    g = torch.as_tensor(np.asarray(genomes, np.uint8))
    p = g.shape[0]
    n = 2 ** bits
    masks = g[:, : channels * n].reshape(p, channels, n).to(torch.int32)
    masks = adc.repair_mask(masks, min_levels)
    dpb = g[:, channels * n: channels * n + DP_BITS].to(torch.int64)
    dps = (dpb * (2 ** torch.arange(DP_BITS))[None, :]).sum(-1) - 8
    return masks, dps.to(torch.float32)


def decode_genome(genome, channels: int, bits: int, min_levels: int = 2
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """genome (G,) uint8 -> (mask (C, 2^N) int32, dp 0-d float32)."""
    masks, dps = decode_population(np.asarray(genome)[None], channels, bits,
                                   min_levels)
    return masks[0], dps[0]


# ------------------------------------------------------------- QAT inner loop
def _init_model(sizes, cfg: SearchConfig):
    """Initial params for one individual, on the CPU: every individual
    starts from the same seed (the genome only controls the ADC and dp).
    Params are in the reference's layout: MLP [(W1, b1), (W2, b2)], SVM
    (W, b)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    if cfg.model == "svm":
        return svm_lib.init_svm(gen, sizes[0], sizes[-1])
    return mlp_lib.init_mlp(gen, sizes)


def _tile(params, pop: int, device):
    """P copies of one individual's params, stacked on a leading axis."""
    tile = lambda a: torch.tensor(  # noqa: E731
        np.asarray(a, np.float32)).to(device)[None].repeat(
            (pop,) + (1,) * np.ndim(a))
    if isinstance(params, tuple):                       # SVM (W, b)
        return tuple(tile(a) for a in params)
    return [(tile(w), tile(b)) for w, b in params]


def _stacked_init(pop: int, sizes, cfg: SearchConfig, device):
    """P copies of the shared initial params on ``device``."""
    return _tile(_init_model(sizes, cfg), pop, device)


def stacked_init_from_numpy(params_np, pop: int, device=None):
    """The carry of initial weights from the reference: its
    ``_init_model`` params as numpy arrays (MLP: a list of (W, b) pairs;
    SVM: a (W, b) tuple) -> the port's (P, ...) initial stacks, so that
    both packages train from one start point."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    if hasattr(params_np[0], "shape"):                  # SVM (W, b)
        return _tile(tuple(params_np), pop, dev)
    return _tile([tuple(layer) for layer in params_np], pop, dev)


def _population_model(model: str, params) -> torch.nn.Module:
    if model == "svm":
        return svm_lib.PopulationSVM(params)
    return mlp_lib.PopulationMLP(params)


def _train_from_quantized(xq_tr, xq_te, y_tr, y_te, dps, params, sizes,
                          cfg: SearchConfig, return_params: bool = False):
    """QAT P lanes from their already-quantized inputs (xq_* (P, M, C),
    dps (P,), params stacked over P): returns (P,) float32 test
    accuracies, or ``(accuracies, trained params)`` with
    ``return_params``. ``cfg.weight_bits`` flows into both the loss and
    the accuracy, so the fitness is measured on the quantized forward the
    exported artifact bakes. The loss is the sum of the lane losses, so
    the gradient of lane p's parameters is lane p's own."""
    model = _population_model(cfg.model, params)
    leaves = model.leaves()
    target = (y_tr if cfg.model == "svm"
              else torch.nn.functional.one_hot(y_tr, sizes[-1]).float())
    opt = adamw.init(leaves)
    for _ in range(cfg.train_steps):
        loss = model.loss(xq_tr, target, dps, cfg.weight_bits)
        grads = torch.autograd.grad(loss.sum(), leaves)
        adamw.update_(leaves, grads, opt, lr=cfg.lr)
    with torch.no_grad():
        acc = model.accuracy(xq_te, y_te, dps, cfg.weight_bits)
    if return_params:
        return acc, model.params
    return acc


def mc_accuracies(model: str, params, dps, xq_mc: torch.Tensor, y,
                  weight_bits: int = 8) -> torch.Tensor:
    """(L, S) per-lane, per-instance test accuracies: lane l's params
    (stacked over L; quantized with its ``dps[l]`` unless ``dps`` is
    None, as baked export weights already are) score each of its S
    perturbed views ``xq_mc[l, s]`` (L, S, M, C). The forward is the
    batch-shape independent one of ``models.mlp.accuracy``, so a lane's
    result does not depend on L or S, and at zero sigma it is its ideal
    accuracy bit for bit. The search and deploy.evaluate_robustness both
    score through here."""
    acc = svm_lib.accuracy if model == "svm" else mlp_lib.accuracy
    with torch.no_grad():
        return acc(params, xq_mc, y, dps, weight_bits)


def _mc_operands(masks, tmr, cal, cfg: SearchConfig, draws, device):
    """The Monte-Carlo operand tuple of a (P, C, 2^N) mask batch (or one
    (C, 2^N) mask): calibrated-table operands with a FaultTolSpec, the
    nominal ones otherwise."""
    spec = cfg.adc_spec
    if cfg.faulttol is not None:
        return faulttol_cal.mc_operands_ft(spec, cfg.nonideal, masks, tmr,
                                           cal, draws, device)
    return nonideal_lib.mc_operands(spec, cfg.nonideal, masks, draws=draws,
                                    device=device)


def _train_and_score(genomes: np.ndarray, params0, data: Dict, sizes,
                     cfg: SearchConfig, return_params: bool = False,
                     draws=None) -> Dict:
    """(P, G) genomes -> ``{'acc': (P,) test accuracies}`` as one batched
    program on ``data``'s device; ``return_params=True`` adds the trained
    parameter stacks under ``'params'``. The input quantization runs
    before the QAT, one population-quantizer launch per split (through
    the spare-augmented masks with a FaultTolSpec; over the whole
    (V, M, C) variant stack with a frontend, each lane then gathering
    the variant its subsample gene picks). A robustness config
    with ``draws`` adds ``'mc_accs'``, the raw (P, S) per-instance
    accuracies: one launch of the MC population entry (the
    calibrated-table one with a FaultTolSpec) on the test split, and
    ``mc_accuracies`` re-scoring each view."""
    spec = cfg.adc_spec
    masks, dps, tmr, cal, sub, _ = _decode_masks(genomes, sizes[0], cfg)
    dev = data["x_train"].device
    masks, dps = masks.to(dev), dps.to(dev)
    if sub is not None:
        # quantize-then-gather: the lane's variant is picked after the
        # whole stack went through the banks, so the gather sees the
        # padded chunk's lanes exactly as the quantizer laid them out
        lane = torch.arange(len(sub), device=dev)
        sub = sub.to(dev, torch.int64)
        xq_tr = ops.adc_quantize_variants(data["x_train"], masks,
                                          spec=spec)[lane, sub]
        xq_te = ops.adc_quantize_variants(data["x_test"], masks,
                                          spec=spec)[lane, sub]
    else:
        xq_tr = ops.adc_quantize_population(data["x_train"], masks,
                                            spec=spec)
        xq_te = ops.adc_quantize_population(data["x_test"], masks,
                                            spec=spec)
    robust = cfg.wants_robustness and draws is not None
    out = _train_from_quantized(xq_tr, xq_te, data["y_train"],
                                data["y_test"], dps, params0, sizes, cfg,
                                return_params or robust)
    acc, params = out if (return_params or robust) else (out, None)
    result = {"acc": acc}
    if robust:
        mc = _mc_operands(masks, tmr, cal, cfg, draws, dev)
        entry = (ops.mc_eval_cal_population if cfg.faulttol is not None
                 else ops.mc_eval_population)
        xq_mc = entry(data["x_test"], *mc, spec=spec)       # (P, S, M, C)
        result["mc_accs"] = mc_accuracies(cfg.model, params, dps, xq_mc,
                                          data["y_test"], cfg.weight_bits)
    if return_params:
        result["params"] = params
    return result


def _to_numpy(params):
    conv = lambda t: t.detach().cpu().numpy()  # noqa: E731
    if isinstance(params, tuple):
        return tuple(conv(t) for t in params)
    return [(conv(w), conv(b)) for w, b in params]


def _take(params, n: int):
    if isinstance(params, tuple):
        return tuple(a[:n] for a in params)
    return [(w[:n], b[:n]) for w, b in params]


def _concat(chunks):
    if isinstance(chunks[0], tuple):
        return tuple(np.concatenate(parts) for parts in zip(*chunks))
    return [(np.concatenate([c[i][0] for c in chunks]),
             np.concatenate([c[i][1] for c in chunks]))
            for i in range(len(chunks[0]))]


def _fixed_lanes(genomes: np.ndarray, data: Dict, sizes, cfg: SearchConfig,
                 init_params=None, return_params: bool = False,
                 draws=None) -> Dict:
    """Train any number of genomes at the fixed lane count
    ``cfg.pop_size`` (module docstring, lane purity): each chunk of at
    most ``pop_size`` genomes is padded by repeating its first genome.
    Returns numpy ``{'acc': (B,) float32}``, plus ``'mc_accs'`` (B, S)
    for a robustness config with ``draws``, plus ``'params'`` (each leaf
    (B, ...)) with ``return_params``."""
    genomes = np.asarray(genomes, np.uint8)
    lanes = cfg.pop_size
    dev = data["x_train"].device
    cols: Dict[str, list] = {}
    params = []
    for start in range(0, len(genomes), lanes):
        chunk = genomes[start:start + lanes]
        k = len(chunk)
        if k < lanes:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[:1], lanes - k, axis=0)])
        params0 = (_stacked_init(lanes, sizes, cfg, dev)
                   if init_params is None
                   else stacked_init_from_numpy(init_params, lanes, dev))
        out = _train_and_score(chunk, params0, data, sizes, cfg,
                               return_params, draws)
        for key in ("acc", "mc_accs"):
            if key in out:
                cols.setdefault(key, []).append(out[key][:k].cpu().numpy())
        if return_params:
            params.append(_to_numpy(_take(out["params"], k)))
    result = {k: np.concatenate(v) for k, v in cols.items()}
    if return_params:
        result["params"] = _concat(params)
    return result


def device_data(data: Dict, device: DeviceLike = None) -> Dict:
    """The dataset dict as tensors on ``device`` (x float32, y int64),
    moved once per search, not once per generation."""
    dev = resolve_device(device)
    out = {}
    for k, v in data.items():
        t = torch.as_tensor(np.asarray(v))
        t = t.float() if k.startswith("x") else t.long()
        out[k] = t.to(dev).contiguous()
    return out


def _as_device_data(data: Dict, device: DeviceLike) -> Dict:
    """``data`` unchanged if it already holds tensors (``device_data``),
    else moved to ``device``."""
    if isinstance(data.get("x_train"), torch.Tensor):
        return data
    return device_data(data, device)


def train_pareto_front(genomes: np.ndarray, data: Dict, sizes,
                       cfg: SearchConfig, *, device: DeviceLike = None,
                       init_params=None):
    """Re-train the given (typically Pareto-front) genomes and keep what
    the search-time fitness threw away: the trained parameter stacks.

    Returns ``(accs (K,) f64, params, masks (K, C, 2^N) i32, dps (K,)
    f32)`` with every ``params`` leaf a numpy (K, ...) stack; with a
    FaultTolSpec the masks carry the spare levels, with a frontend the
    allocation ladder. Each lane is a pure function of (genome, data,
    cfg) at the fixed lane count, so the accuracies reproduce the
    search-time fitness bit for bit."""
    genomes = np.asarray(genomes, np.uint8)
    data = _as_device_data(data, device)
    out = _fixed_lanes(genomes, data, sizes, cfg, init_params,
                       return_params=True)
    masks, dps, *_ = _decode_masks(genomes, sizes[0], cfg)
    return (np.asarray(out["acc"], np.float64), out["params"],
            masks.numpy(), dps.numpy())


# ------------------------------------------------------------------- fitness
def population_areas(genomes: np.ndarray, channels: int, cfg: SearchConfig
                     ) -> np.ndarray:
    """(P, G) genomes -> (P,) normalized ADC areas (vs the full flash
    bank): mask decode and repair, then the exact-integer design-rule walk
    in numpy per mask. With a FaultTolSpec: the spare-augmented masks
    plus the exact voter/calibration surcharge (``area.faulttol_tc``) on
    the same budget axis. With a frontend: the alloc-applied masks plus
    the exact front-end count of (subsample, alloc), normalized by the
    full flash bank plus the full-rate, all-features front end."""
    g = np.asarray(genomes, np.uint8)
    masks, _, tmr, cal, sub, alloc = _decode_masks(g, channels, cfg)
    masks = masks.numpy()
    fe = cfg.frontend
    if fe is not None:
        denom = max(area.flash_full_tc(cfg.bits) * channels
                    + feature_lib.frontend_full_tc(fe), 1)
        tc = [area.system_tc(m, cfg.design)
              + feature_lib.frontend_tc(fe, fe.sub_grid[int(s)], a)
              for m, s, a in zip(masks, sub.numpy(), alloc.numpy())]
        return np.array(tc, np.float64) / denom
    flash_full = max(area.flash_full_tc(cfg.bits) * channels, 1)
    if cfg.faulttol is not None:
        tc = [area.system_tc(m, cfg.design)
              + area.faulttol_tc(m, t, bool(cv))
              for m, t, cv in zip(masks, tmr.numpy(), cal.numpy())]
    else:
        tc = [area.system_tc(m, cfg.design) for m in masks]
    return np.array(tc, np.float64) / flash_full


def search_draws(cfg: SearchConfig, channels: int,
                 device: DeviceLike = None):
    """The search's Monte-Carlo draw block, on ``device`` (default the
    CPU): one stream per run, fixed across generations and common to
    every individual, a pure function of ``cfg.nonideal.seed``. None
    without a robustness objective; a FaultTolSpec draws the 3-replica
    ``RedundantDraws``. ``deploy.evaluate_robustness`` re-derives the
    same stream from the same spec."""
    if not cfg.wants_robustness:
        return None
    dev = None if device is None else torch.device(device)
    if cfg.faulttol is not None:
        return ft_redundancy.draw_redundant(cfg.bits, channels,
                                            cfg.mc_samples, cfg.nonideal,
                                            dev)
    return nonideal_lib.draw(cfg.bits, channels, cfg.mc_samples,
                             cfg.nonideal, dev)


def _as_search_draws(draws, cfg: SearchConfig, channels: int, device):
    """``draws`` (None: the config's own stream; or tensors or numpy
    arrays in the field order, such as the reference's draws) on
    ``device``, typed for the config (``RedundantDraws`` with a
    FaultTolSpec)."""
    if not cfg.wants_robustness:
        return None
    if draws is None:
        return search_draws(cfg, channels, device)
    if cfg.faulttol is not None:
        return ft_redundancy.as_redundant_draws(draws, device)
    return nonideal_lib.as_draws(draws, device, cls=nonideal_lib.Draws)


def _fitness(genomes, out: Dict, channels: int,
             cfg: SearchConfig) -> np.ndarray:
    """The fitness matrix from an evaluation's raw columns: [1 - acc,
    area] plus, with ``'mc_accs'``, the host-side f64 robustness
    column."""
    cols = [1.0 - np.asarray(out["acc"]),
            population_areas(genomes, channels, cfg)]
    if "mc_accs" in out:
        cols.append(nonideal_lib.robust_objective(
            np.asarray(out["acc"]), np.asarray(out["mc_accs"]),
            cfg.robust_objective, margin=cfg.yield_margin))
    return np.stack(cols, axis=1)


def _eval_dedup(genomes: np.ndarray, cfg: SearchConfig, core) -> Dict:
    """Exact-duplicate genome dedup around a population evaluation:
    ``core`` maps a (B, G) uint8 batch to a dict of (B, ...) arrays.
    Duplicates share one QAT lane and the results scatter back through
    the inverse index. Bit-identical to evaluating the full population,
    because every lane is a pure function of its own genome. The unique
    set is not padded to the reference's power-of-two bucket
    (``_dedup_bucket``, which bounds its recompiles): ``_fixed_lanes``
    already runs every batch at the one lane count ``cfg.pop_size``."""
    genomes = np.asarray(genomes, np.uint8)
    if not cfg.dedup or len(genomes) <= 1:
        return core(genomes)
    uniq, inverse = np.unique(genomes, axis=0, return_inverse=True)
    if len(uniq) == len(genomes):
        return core(genomes)
    out = core(uniq)
    inverse = np.asarray(inverse).reshape(-1)
    return {k: np.asarray(v)[inverse] for k, v in out.items()}


def evaluate_population(genomes: np.ndarray, data: Dict, sizes,
                        cfg: SearchConfig, *, device: DeviceLike = None,
                        init_params=None, draws=None) -> np.ndarray:
    """Batched engine. Full fitness: [1 - accuracy, normalized ADC area]
    plus, for a robustness config, the Monte-Carlo column (all
    minimized), exact-duplicate genomes sharing one QAT lane
    (``cfg.dedup``). ``init_params`` (numpy, the reference's layout)
    replaces the seeded initial weights, ``draws`` (numpy or tensors)
    the config's own draw stream. It is the sharded engine on a mesh of
    one entry, the data's device."""
    data = _as_device_data(data, device)
    return evaluate_population_sharded(
        genomes, data, sizes, cfg, _one_device_mesh(data["x_train"].device),
        init_params=init_params, draws=draws)


def evaluate_population_acc(genomes: np.ndarray, data: Dict, sizes,
                            cfg: SearchConfig, *,
                            device: DeviceLike = None,
                            init_params=None) -> np.ndarray:
    """(P, G) genomes -> (P,) float32 test accuracies, each genome's own
    QAT lane at the fixed lane count (``_fixed_lanes``), no dedup."""
    data = _as_device_data(data, device)
    return _fixed_lanes(genomes, data, sizes, cfg, init_params)["acc"]


def _eval_one(genome, data: Dict, sizes, cfg: SearchConfig,
              init_params=None, draws=None) -> Dict:
    """QAT one individual end to end (decode -> quantize -> train), one
    lane: the paper-faithful sequential path. The quantization is the
    module form (core/adc.adc_quantize) with ``ste=False``: inputs are
    data, so no gradient flows to them. With a robustness config and
    ``draws`` the single-design MC entry (``ops.mc_eval``, or
    ``ops.mc_eval_cal`` with a FaultTolSpec) gives ``'mc_accs'`` (S,).
    With a frontend the subsample gene picks the genome's variant before
    the quantization (gather-then-quantize: the quantizer is elementwise,
    so this equals the batched engine's quantize-then-gather bit for
    bit). Returns numpy ``{'acc': float32, ...}``."""
    genome = np.asarray(genome)[None]
    masks, dps, tmr, cal, sub, _ = _decode_masks(genome, sizes[0], cfg)
    dev = data["x_train"].device
    mask, dp = masks[0].to(dev), dps.to(dev)
    x_tr, x_te = data["x_train"], data["x_test"]
    if sub is not None:
        x_tr, x_te = x_tr[int(sub[0])], x_te[int(sub[0])]
    kw = dict(bits=cfg.bits, vmin=cfg.vmin, vmax=cfg.vmax, mode=cfg.mode,
              ste=False)
    xq_tr = adc.adc_quantize(x_tr, mask, **kw)[None]
    xq_te = adc.adc_quantize(x_te, mask, **kw)[None]
    params0 = (_stacked_init(1, sizes, cfg, dev) if init_params is None
               else stacked_init_from_numpy(init_params, 1, dev))
    robust = cfg.wants_robustness and draws is not None
    out = _train_from_quantized(xq_tr, xq_te, data["y_train"],
                                data["y_test"], dp, params0, sizes, cfg,
                                return_params=robust)
    if not robust:
        return {"acc": out.cpu().numpy()[0]}
    acc, params = out
    mc = _mc_operands(mask, None if tmr is None else tmr[0],
                      None if cal is None else cal[0], cfg, draws, dev)
    entry = ops.mc_eval_cal if cfg.faulttol is not None else ops.mc_eval
    xq_mc = entry(data["x_test"], *mc, spec=cfg.adc_spec)       # (S, M, C)
    mc_accs = mc_accuracies(cfg.model, params, dp, xq_mc[None],
                            data["y_test"], cfg.weight_bits)
    return {"acc": acc.cpu().numpy()[0], "mc_accs": mc_accs[0].cpu().numpy()}


def evaluate_population_reference(genomes: np.ndarray, data: Dict, sizes,
                                  cfg: SearchConfig, *,
                                  device: DeviceLike = None,
                                  init_params=None, draws=None
                                  ) -> np.ndarray:
    """Per-individual reference path (the paper's pymoo-style loop): the
    same fitness as ``evaluate_population``, robustness column included,
    one QAT and one single-design MC launch per individual."""
    data = _as_device_data(data, device)
    draws = _as_search_draws(draws, cfg, sizes[0], data["x_test"].device)
    rows = [_eval_one(g, data, sizes, cfg, init_params, draws)
            for g in np.asarray(genomes, np.uint8)]
    out = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    out["acc"] = out["acc"].astype(np.float64)
    return _fitness(genomes, out, sizes[0], cfg)


# ------------------------------------------------------------ sharded engine
def default_search_mesh(device: DeviceLike = None) -> mesh_lib.Mesh:
    """Every visible device of ``device``'s type on a (n, 1) ('data',
    'model') mesh: all CUDA cards by default (raising without one), one
    CPU entry for ``device='cpu'``. GA individuals are embarrassingly
    parallel, so every device takes population slices; a caller with a
    2D mesh passes it in and ``population_axes`` folds both axes into
    the split."""
    devs = mesh_lib.visible_devices(device)
    return mesh_lib.make_mesh((len(devs), 1), ("data", "model"),
                              devices=devs)


def _one_device_mesh(device) -> mesh_lib.Mesh:
    """The batched engine's mesh: one ('data', 'model') entry."""
    return mesh_lib.make_mesh((1, 1), ("data", "model"), devices=[device])


def search_mesh(engine: str, device: DeviceLike = None,
                mesh: Optional[mesh_lib.Mesh] = None
                ) -> Optional[mesh_lib.Mesh]:
    """The sharded engine's mesh: ``mesh``, or
    ``default_search_mesh(device)``. None for every other engine, which
    ignores ``mesh``."""
    if engine != "sharded":
        return None
    return default_search_mesh(device) if mesh is None else mesh


def search_device(engine: str, device: DeviceLike = None,
                  mesh: Optional[mesh_lib.Mesh] = None) -> torch.device:
    """Where a search's data, NSGA-II bookkeeping, surrogate and
    ``train_pareto_front`` run: the sharded engine's mesh's first device
    (``mesh_lib.work_device``: a ``device`` beside an explicit mesh must
    be that device), else ``device``."""
    if engine != "sharded":
        return resolve_device(device)
    if mesh is None:
        return default_search_mesh(device).first_device
    return mesh_lib.work_device(device, mesh)


def _mesh_replicas(data: Dict, draws, cfg: SearchConfig, channels: int,
                   mesh: mesh_lib.Mesh) -> Dict:
    """``{device: (data, draws)}`` for each distinct device of ``mesh``:
    the dataset and the search's draw block (``draws``, or the config's
    own stream) on the mesh's first device, copied once to every other
    device. Both replicate whole: common random numbers must be common
    across shards."""
    first = mesh.first_device
    base = _as_device_data(data, first)
    base_draws = _as_search_draws(draws, cfg, channels, first)
    replicas: Dict = {}
    for dev in mesh.devices.reshape(-1):
        if dev not in replicas:
            replicas[dev] = (
                {k: t.to(dev) for k, t in base.items()},
                _as_search_draws(base_draws, cfg, channels, dev))
    return replicas


def _evaluate_sharded(genomes: np.ndarray, replicas: Dict, sizes,
                      cfg: SearchConfig, mesh: mesh_lib.Mesh,
                      init_params=None) -> np.ndarray:
    """The sharded engine on placed ``replicas`` (``_mesh_replicas``):
    dedup, then the unique genomes split over
    ``sharding.population_axes``; shard k trains its slice through
    ``_fixed_lanes`` on its device (padded to ``cfg.pop_size`` lanes),
    the shards run in mesh order and their columns gather in shard
    order. No dividing rule: one batched evaluation on the first
    device."""
    def core(g):
        parts = []
        for dev, sl in sharding.shard_plan(
                mesh, sharding.population_axes(mesh, len(g)), len(g)):
            dev_data, dev_draws = replicas[dev]
            parts.append(_fixed_lanes(g[sl], dev_data, sizes, cfg,
                                      init_params, draws=dev_draws))
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    out = _eval_dedup(genomes, cfg, core)
    return _fitness(genomes, out, sizes[0], cfg)


def evaluate_population_sharded(genomes: np.ndarray, data: Dict, sizes,
                                cfg: SearchConfig,
                                mesh: Optional[mesh_lib.Mesh] = None, *,
                                init_params=None, draws=None
                                ) -> np.ndarray:
    """Sharded engine: the population split over ``mesh`` (default
    ``default_search_mesh()``, every CUDA card); the batched engine
    (``evaluate_population``) is this on a mesh of one entry, and each
    shard pads to the same lane count, so the two agree bit for bit.
    Exact-duplicate dedup runs before the split; a unique count no rule
    divides runs as one shard on the mesh's first device.
    ``init_params`` and ``draws`` as in ``evaluate_population``."""
    mesh = default_search_mesh() if mesh is None else mesh
    replicas = _mesh_replicas(data, draws, cfg, sizes[0], mesh)
    return _evaluate_sharded(genomes, replicas, sizes, cfg, mesh,
                             init_params)


def make_eval_fn(data: Dict, sizes, cfg: SearchConfig, *,
                 device: DeviceLike = None, init_params=None,
                 mesh: Optional[mesh_lib.Mesh] = None
                 ) -> Callable[[np.ndarray], np.ndarray]:
    """The (P, G) -> (P, n_objectives) fitness function ``nsga2.evolve``
    consumes, dispatched on ``cfg.engine``. The dataset, and the MC draw
    block of a robustness config, move to the device once here, not once
    per generation; for the sharded engine, once to each distinct device
    of ``mesh`` (default ``default_search_mesh(device)``). The batched
    engine is the sharded one on a mesh of one entry."""
    if cfg.engine == "gradient":
        raise ValueError("the gradient engine is not a per-generation "
                         "eval_fn: run it through run_search / "
                         "run_gradient_search")
    if cfg.engine == "reference":
        dev_data = _as_device_data(data, device)
        draws = search_draws(cfg, sizes[0], dev_data["x_test"].device)
        return lambda pop: evaluate_population_reference(
            pop, dev_data, sizes, cfg, init_params=init_params, draws=draws)
    m = search_mesh(cfg.engine, device, mesh)
    if m is None:
        data = _as_device_data(data, device)
        m = _one_device_mesh(data["x_train"].device)
    replicas = _mesh_replicas(data, None, cfg, sizes[0], m)
    return lambda pop: _evaluate_sharded(pop, replicas, sizes, cfg, m,
                                         init_params)


# --------------------------------------------------- search-state checkpoint
def search_state_tree(state: nsga2.EvolveState,
                      surrogate_state=None) -> Dict[str, np.ndarray]:
    """EvolveState -> the flat tree the checkpoint manager persists, in
    the reference's keys and dtypes: genomes (uint8), the fitness matrix
    (float64), the numpy Generator's bit_generator state (JSON packed to
    uint8: PCG64's words exceed int64) and the completed-generation
    counter (int64). A screened search adds the surrogate's leaves as
    ``surrogate_{i}``, so a resumed run screens with the same
    predictor."""
    tree = {
        "genomes": np.asarray(state.pop, np.uint8),
        "fitness": np.asarray(state.fit, np.float64),
        "rng_state": manager.pack_json(state.rng.bit_generator.state),
        "generation": np.asarray(state.generation, np.int64),
    }
    if surrogate_state is not None:
        for i, leaf in enumerate(surrogate_lib.leaves(surrogate_state)):
            tree[f"surrogate_{i}"] = leaf
    return tree


def restore_search_state(ckpt, step: int, pop_size: int, glen: int,
                         n_obj: int = 2, surrogate_like=None):
    """Inverse of ``search_state_tree``: the EvolveState saved at
    ``step``, or with ``surrogate_like`` (a surrogate state on the
    device the search runs on) ``(EvolveState, restored surrogate)``.
    Refuses a checkpoint whose genomes or fitness do not fit the current
    config (``n_obj`` is 3 for a robustness search)."""
    tree = ckpt.restore_flat(step)
    if tuple(tree["genomes"].shape) != (pop_size, glen):
        raise ValueError(
            f"checkpoint at step {step} holds genomes of shape "
            f"{tree['genomes'].shape}, but the current config expects "
            f"({pop_size}, {glen}): resuming with changed --pop/--bits/"
            f"dataset would silently corrupt the search")
    if tuple(tree["fitness"].shape) != (pop_size, n_obj):
        raise ValueError(
            f"checkpoint at step {step} holds a fitness of shape "
            f"{tree['fitness'].shape}, but the current config expects "
            f"({pop_size}, {n_obj})")
    rng = np.random.default_rng()
    rng.bit_generator.state = manager.unpack_json(tree["rng_state"])
    state = nsga2.EvolveState(np.asarray(tree["genomes"], np.uint8),
                              np.asarray(tree["fitness"], np.float64),
                              int(tree["generation"]), rng)
    if surrogate_like is None:
        return state
    count = len(surrogate_lib.leaves(surrogate_like))
    missing = [i for i in range(count) if f"surrogate_{i}" not in tree]
    if missing:
        raise ValueError(f"checkpoint at step {step} holds no surrogate "
                         f"state: it was not written by a screened "
                         f"search (screen_factor > 1)")
    restored = surrogate_lib.state_from_numpy(
        [tree[f"surrogate_{i}"] for i in range(count)],
        surrogate_like.device)
    return state, restored


def _validate_frontend(data: Dict, sizes, cfg: SearchConfig) -> None:
    """Co-search data contract: sizes[0] counts FEATURE channels and the
    x arrays stack one featurized variant per sub_grid factor."""
    fe = cfg.frontend
    if fe is None:
        return
    if fe.feature_channels != sizes[0]:
        raise ValueError(
            f"frontend produces {fe.feature_channels} feature channels "
            f"({fe.channels} raw x {len(fe.features)} features) but "
            f"sizes[0] is {sizes[0]}")
    xt = tuple(np.shape(data["x_train"]))
    if len(xt) != 3 or xt[0] != len(fe.sub_grid):
        raise ValueError(
            f"co-search data must stack one featurized variant per "
            f"sub_grid factor — expected x_train of shape "
            f"(V={len(fe.sub_grid)}, M, {fe.feature_channels}), got "
            f"{xt} (build it with timeseries.feature.stack_variants)")


def _decoder(channels: int, cfg: SearchConfig):
    """genome -> its decode (mask, dp[, tmr, spares, cal] or
    [, sub, alloc])."""
    if cfg.frontend is not None:
        return lambda gg: decode_genome_cosearch(
            gg, channels, cfg.bits, cfg.min_levels, cfg.frontend)
    if cfg.faulttol is not None:
        return lambda gg: decode_genome_faulttol(
            gg, channels, cfg.bits, cfg.min_levels, cfg.faulttol)
    return lambda gg: decode_genome(gg, channels, cfg.bits, cfg.min_levels)


def run_search(data: Dict, sizes, cfg: SearchConfig,
               log: Optional[Callable] = None, ckpt=None,
               resume: bool = False, return_trained: bool = False,
               init: Optional[np.ndarray] = None, *,
               device: DeviceLike = None, init_params=None,
               mesh: Optional[mesh_lib.Mesh] = None):
    """Full in-training optimization on ``device`` (default ``cuda``).
    Returns (pareto_genomes, pareto_fit, decode) where fit columns are
    [1-acc, normalized area] (plus the robustness column for a
    robustness config); with ``return_trained=True`` a fourth element
    carries the final front's trained state, ``train_pareto_front``'s
    (accs, params, masks, dps), which ``core/deploy.export_front``
    consumes.

    ``ckpt`` (a ``checkpoint.manager.CheckpointManager``) saves the
    search state after the initial evaluation and after every
    generation; with ``resume=True`` the latest step restarts the run,
    and a killed-and-resumed search equals an uninterrupted one bit for
    bit.

    ``cfg.engine == 'gradient'`` routes to ``run_gradient_search`` (the
    same return contract, no generations). ``cfg.screen_factor > 1``
    turns on surrogate-screened offspring oversampling.

    ``cfg.engine == 'sharded'`` evaluates each generation over ``mesh``
    (default ``default_search_mesh(device)``); everything else (NSGA-II,
    the surrogate, ``train_pareto_front``) runs on the mesh's first
    device. Other engines ignore ``mesh``.

    ``init`` seeds the initial population ((pop_size, G) uint8) instead
    of the random draw, e.g. an ADC-only front lifted into the co-search
    space (``timeseries.cosearch.embed_adc_only``)."""
    if cfg.engine == "gradient":
        return run_gradient_search(data, sizes, cfg, log=log, ckpt=ckpt,
                                   resume=resume,
                                   return_trained=return_trained,
                                   device=device, init_params=init_params)
    c = sizes[0]
    cfg.adc_spec.validate_channels(c)
    _validate_frontend(data, sizes, cfg)
    device = search_device(cfg.engine, device, mesh)
    mesh = search_mesh(cfg.engine, device, mesh)
    dev_data = device_data(data, device)
    g = genome_len(c, cfg.bits, cfg.faulttol, frontend=cfg.frontend)
    screened = cfg.screen_factor > 1
    sur = [surrogate_lib.init(g, cfg.n_objectives,
                              hidden=cfg.surrogate_hidden, seed=cfg.seed,
                              device=dev_data["x_train"].device)
           if screened else None]
    state = None
    if ckpt is not None and resume:
        step = ckpt.latest_step()
        if step is not None:
            restored = restore_search_state(
                ckpt, step, cfg.pop_size, g, n_obj=cfg.n_objectives,
                surrogate_like=sur[0])
            if screened:
                state, sur[0] = restored
            else:
                state = restored
    on_gen = None
    if ckpt is not None:
        on_gen = lambda st: ckpt.save(  # noqa: E731
            st.generation, search_state_tree(st, sur[0]))
    screen_fn = on_eval = None
    if screened:
        def on_eval(genomes, fitness):
            sur[0] = surrogate_lib.observe(sur[0], genomes, fitness,
                                           steps=cfg.surrogate_steps)

        def screen_fn(cands):
            return surrogate_lib.screen(sur[0], cands, cfg.pop_size)
    pop, fit = nsga2.evolve(
        make_eval_fn(dev_data, sizes, cfg, init_params=init_params,
                     mesh=mesh), g,
        pop_size=cfg.pop_size, generations=cfg.generations, seed=cfg.seed,
        init=init, log=log, state=state, on_generation=on_gen,
        offspring_factor=cfg.screen_factor, screen_fn=screen_fn,
        on_evaluated=on_eval)
    pg, pf = nsga2.pareto_front(pop, fit)
    if return_trained:
        return pg, pf, _decoder(c, cfg), train_pareto_front(
            pg, dev_data, sizes, cfg, init_params=init_params)
    return pg, pf, _decoder(c, cfg)


def _dp_code(dp: float) -> np.ndarray:
    """The 4 dp genes (LSB first) of an integer decimal position."""
    return (np.int64(int(dp) + 8) >> np.arange(DP_BITS)) & 1


def run_gradient_search(data: Dict, sizes, cfg: SearchConfig,
                        log: Optional[Callable] = None, ckpt=None,
                        resume: bool = False, return_trained: bool = False,
                        progress: Optional[Callable[[str], None]] = None, *,
                        device: DeviceLike = None, init_params=None):
    """The gradient engine on ``device`` (default ``cuda``): one gate
    train (``grad_gates.train_gate_family``) sweeps an area-weight family
    of lanes along the accuracy/area front and snapshots each lane's
    snapped genome after every chunk; every snapshot is re-scored at
    each ``grad_gates.DP_INIT_GRID`` decimal position, with two anchors
    (the full design, and the full design at dp = -3), through the
    exact fitness path (``evaluate_population``: ``_fixed_lanes``, chunks
    of ``pop_size`` lanes). So the returned fitness keeps the
    pure-function-of-genome contract: re-training any returned genome
    reproduces it bit for bit. Then ``cfg.grad_polish_rounds`` rounds of
    surrogate-screened polish: every one-gene flip of the elite (the
    Pareto set plus the ``grad_polish_beam`` most accurate rows) that
    was not evaluated yet is ranked by the online surrogate (accuracy
    predicted, area exact) and the best ``grad_polish_evals`` pay an
    exact evaluation. Same return shape as ``run_search``;
    ``ckpt``/``resume`` checkpoint the gate train's chunks. With a
    FaultTolSpec the redundancy genes start zeroed and the anchors stay
    plain full-ADC designs; the exact polish flips them from there. With
    a frontend the gate train runs on the full-rate variant (index 0)
    without the frontend, the snapshots take full allocation and the
    subsample grid cycled over their rows, and the anchors embed the
    full-rate, full-allocation front end; the polish flips the feature
    genes from there."""
    c = sizes[0]
    cfg.adc_spec.validate_channels(c)
    _validate_frontend(data, sizes, cfg)
    fe, ft = cfg.frontend, cfg.faulttol
    g = genome_len(c, cfg.bits, ft, frontend=fe)
    dp_lo = c * 2 ** cfg.bits                       # the dp genes start here
    dev_data = _as_device_data(data, device)
    draws = search_draws(cfg, c, dev_data["x_test"].device)
    evaluate = lambda genomes: evaluate_population(  # noqa: E731
        genomes, dev_data, sizes, cfg, init_params=init_params, draws=draws)
    # 4 lanes per requested front point: the λ sweep, the dp grid and the
    # density strata each need room along their axis
    lanes = cfg.grad_points if cfg.grad_points > 0 else 4 * cfg.pop_size
    gate_cfg, gate_data = cfg, dev_data
    if fe is not None:
        # the relaxation differentiates masks, not the combinatorial
        # feature genes: train the gates on the full-rate variant
        gate_cfg = dataclasses.replace(cfg, frontend=None)
        gate_data = dict(dev_data, x_train=dev_data["x_train"][0],
                         x_test=dev_data["x_test"][0])
    snaps, _ = grad_gates.train_gate_family(
        gate_data, tuple(sizes), gate_cfg, lanes=lanes, ckpt=ckpt,
        resume=resume, progress=progress)
    snaps = np.asarray(snaps, np.uint8)
    if fe is not None:
        ext = np.ones((len(snaps), g - dp_lo - DP_BITS), np.uint8)
        subs = np.arange(len(snaps)) % len(fe.sub_grid)
        ext[:, :fe.sub_bits] = (subs[:, None] >> np.arange(fe.sub_bits)) & 1
        snaps = np.concatenate([snaps, ext], axis=1)
    elif ft is not None:
        snaps = np.concatenate(
            [snaps, np.zeros((len(snaps), ft.gene_bits(c)), np.uint8)],
            axis=1)
    # the dp is combinatorial (the gate train does not move it), so each
    # snapped mask re-scores at every grid dp
    variants = []
    for dpv in grad_gates.DP_INIT_GRID:
        v = snaps.copy()
        v[:, dp_lo:dp_lo + DP_BITS] = _dp_code(dpv)
        variants.append(v)
    anchors = np.ones((2, g), np.uint8)
    anchors[1, dp_lo:dp_lo + DP_BITS] = _dp_code(-3)
    if fe is not None:
        # sub index 0; the all-ones alloc genes already mean FULL_ALLOC
        anchors[:, dp_lo + DP_BITS:dp_lo + DP_BITS + fe.sub_bits] = 0
    elif ft is not None:
        anchors[:, dp_lo + DP_BITS:] = 0          # no redundancy overhead
    pool = np.unique(np.concatenate(variants + [anchors]), axis=0)
    fit = evaluate(pool)
    if progress is not None:
        progress(f"exact re-score: {len(pool)} unique genomes")
    seen_g, seen_f = pool, fit
    sur = None
    if cfg.grad_polish_rounds > 0:
        sur = surrogate_lib.init(g, cfg.n_objectives,
                                 hidden=cfg.surrogate_hidden, seed=cfg.seed,
                                 device=dev_data["x_train"].device)
        sur = surrogate_lib.observe(sur, seen_g, seen_f,
                                    steps=cfg.surrogate_steps)
    # polish flips every gene but the dp's: dp stays on the re-scored grid
    flip_pos = np.concatenate([np.arange(dp_lo),
                               np.arange(dp_lo + DP_BITS, g)])
    for rnd in range(cfg.grad_polish_rounds):
        front_g, _ = nsga2.pareto_front(seen_g, seen_f)
        elite = seen_g[np.argsort(seen_f[:, 0],
                                  kind="stable")[:cfg.grad_polish_beam]]
        beam = np.unique(np.concatenate([np.unique(front_g, axis=0),
                                         elite]), axis=0)
        flips = np.repeat(beam, len(flip_pos), axis=0)
        j = np.tile(flip_pos, len(beam))
        flips[np.arange(len(flips)), j] ^= 1
        cand = np.unique(flips, axis=0)
        # unseen neighbours only: every exact evaluation is spent once
        comb = np.concatenate([seen_g, cand])
        _, first = np.unique(comb, axis=0, return_index=True)
        cand = comb[np.sort(first[first >= len(seen_g)])]
        if not len(cand):
            break
        if len(cand) > cfg.grad_polish_evals:
            keep = surrogate_lib.screen(
                sur, cand, cfg.grad_polish_evals,
                override_cols={1: population_areas(cand, c, cfg)})
            cand = cand[np.sort(np.asarray(keep))]
        cfit = evaluate(cand)
        if progress is not None:
            progress(f"polish round {rnd + 1}/{cfg.grad_polish_rounds}: "
                     f"{len(cand)} exact evals")
        seen_g = np.concatenate([seen_g, cand])
        seen_f = np.concatenate([seen_f, cfit])
        sur = surrogate_lib.observe(sur, cand, cfit,
                                    steps=cfg.surrogate_steps)
    if log is not None:
        log(0, seen_g, seen_f)
    pg, pf = nsga2.pareto_front(seen_g, seen_f)
    if return_trained:
        return pg, pf, _decoder(c, cfg), train_pareto_front(
            pg, dev_data, sizes, cfg, init_params=init_params)
    return pg, pf, _decoder(c, cfg)


def full_adc_baseline(data: Dict, sizes, cfg: SearchConfig, *,
                      device: DeviceLike = None,
                      init_params=None) -> Dict[str, float]:
    """The paper's Table 5 "Baseline" column: the full (unpruned) ADC at
    dp = -3 with QAT, through the exact fitness path (FaultTolSpec genes
    zeroed: no redundancy; a frontend at full rate and full
    allocation), plus the three full-design areas in
    transistors (flash, the binary baseline and the proposed design)."""
    c = sizes[0]
    g = genome_len(c, cfg.bits, cfg.faulttol, frontend=cfg.frontend)
    dp_lo = c * 2 ** cfg.bits
    genome = np.ones((1, g), np.uint8)
    genome[0, dp_lo:dp_lo + DP_BITS] = _dp_code(-3)
    if cfg.frontend is not None:
        # full-rate (sub index 0), full-allocation front end
        genome[0, dp_lo + DP_BITS:
               dp_lo + DP_BITS + cfg.frontend.sub_bits] = 0
    elif cfg.faulttol is not None:
        genome[0, dp_lo + DP_BITS:] = 0
    fit = evaluate_population(genome, data, sizes, cfg, device=device,
                              init_params=init_params)
    return {
        "accuracy": 1.0 - float(fit[0, 0]),
        "area_flash_tc": area.flash_full_tc(cfg.bits) * c,
        "area_binary_baseline_tc": area.baseline_binary_tc(cfg.bits) * c,
        "area_binary_ours_tc": area.ours_full_tc(cfg.bits) * c,
    }
