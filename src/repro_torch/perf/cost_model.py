"""Per-entry cost model and roofline estimate, priced from the hand
kernels. Counterpart of ``repro/perf/cost_model.py``.

Every one of the ten non-attention entries gets closed-form byte and
operation counts as a function of its ``Workload``. The counts follow
the CUDA bodies (kernels/csrc/*.cu), not the reference's: the TPU
BlockSpecs re-stream x per individual, while each hand kernel reads
every operand once and writes every output once, so

* the quantizer (``adc_quantize{,_population}``) moves
  ``4 (M C + P C 2^N + 2 C + P M C)`` bytes and does 5 operations an
  output (subtract, multiply, floor, two clamps);
* the bank kernels (``bespoke_*``, ``classifier_bank_*``) move
  ``4 (M F + D M O + D R + 2 F)`` bytes, R a design's resident operands
  (table, weights, biases), and do ``2 D M (F H + H O)`` (SVM ``2 D M F
  O``) multiply-add operations, all of them the matmul share
  ``dot_flops``, equal to the reference's for the same ``Workload``;
* the Monte-Carlo kernel (``mc_eval*``) moves ``4 (M C + 2 P S C 2^N +
  V + 2 S C + P S M C)`` bytes, V the values (C 2^N, calibrated P S C
  2^N), and does ``3 + 2 * 2^N`` operations an output (the position's
  subtract and multiply, two compares a leaf, one add).

These are the counts ``chip_smoke.py`` prints as each kernel's bound
(``bound``). The machine row is the H100's: its published HBM rate and
float32 rate outside the tensor cores (NVIDIA data sheet, SXM part, at
700 W); ``roofline_estimate`` adds the launch and wave overhead that
makes an estimate depend on the tile, and its ``estimated_s`` only orders
candidate tiles: it is no bound. Consumers: the autotuner
(perf/autotune.py: ``heuristic_block_m``, the candidates' waves), the
property tests (tests/test_torch_perf.py), and ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import envelope
from repro_torch.perf.workload import Workload

F32 = 4  # bytes
_QUANTIZE_OPS = 5      # subtract, multiply, floor, clamp low, clamp high
_MC_BASE_OPS = 3       # the position's subtract and multiply, the add
_MC_LEAF_OPS = 2       # two compares a leaf


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Peak rates of one backend, the roofline's ceilings, and the two
    overhead terms of a launch: ``launch_s``, the fixed cost of a launch
    that moves next to nothing (the launch, one load round trip, the
    stores' drain), and ``wave_s``, each further wave of blocks."""
    name: str
    peak_flops: float        # float32 FLOP/s outside the tensor cores
    hbm_bw: float            # bytes/s of device memory
    launch_s: float          # seconds a launch costs at the least
    wave_s: float            # seconds each wave of blocks beyond the first


MACHINE_MODELS: Dict[str, MachineModel] = {
    # NVIDIA H100 SXM data sheet (700 W): 3.35 TB/s HBM3, 67 TFLOP/s
    # float32. launch_s: the launch-and-drain floor of the short bank and
    # quantizer calls, 2.8 us above their bound (tools/adc_bank_ab.py).
    # wave_s: the slope of the population quantizer's device time over its
    # waves across its candidate spans at P=16, M=1488, C=21, 1.24 us a
    # wave of 264 blocks (chip_smoke.py, phase autotune). Both measured on
    # an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md names the runs).
    "cuda": MachineModel("nvidia-h100-sxm", 67e12, 3.35e12, 2.8e-6, 1.24e-6),
    # a coarse single-socket host row, so estimates stay finite off the
    # card (and honest about being estimates)
    "cpu": MachineModel("cpu-host", 2e11, 50e9, 5.0e-6, 0.0),
}


def machine_model(backend: str = "cuda", device=None) -> MachineModel:
    """The machine row for ``backend`` ('cuda', the port's default, or
    'cpu'), or for ``device`` (a torch.device or its name), whose type
    picks the row; a CUDA device names it after
    ``torch.cuda.get_device_name``. Unknown backends get the cpu row.
    The lookup never probes for a card."""
    if device is not None:
        dev = torch.device(device)
        mm = MACHINE_MODELS.get(dev.type, MACHINE_MODELS["cpu"])
        if dev.type == "cuda":
            mm = dataclasses.replace(mm, name=torch.cuda.get_device_name(dev))
        return mm
    return MACHINE_MODELS.get(backend, MACHINE_MODELS["cpu"])


@dataclasses.dataclass(frozen=True)
class Cost:
    """Cost of one launch. ``flops`` counts every operation, ``dot_flops``
    the matmul share alone; ``smem_bytes`` is a block's dynamic shared
    memory and ``blocks`` the blocks the launch runs, at the tile."""
    flops: float
    dot_flops: float
    hbm_bytes: float
    smem_bytes: int
    blocks: int

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)

    def to_meta(self) -> Dict:
        d = dataclasses.asdict(self)
        d["arithmetic_intensity"] = self.arithmetic_intensity
        return d


def family(entry: str) -> str:
    """The kernel family of an entry: 'quantize', 'mc' or 'bank'."""
    if entry in ("adc_quantize", "adc_quantize_population"):
        return "quantize"
    if entry.startswith("mc_eval"):
        return "mc"
    if entry in ("bespoke_mlp", "bespoke_svm", "classifier_bank_mlp",
                 "classifier_bank_svm"):
        return "bank"
    raise ValueError(f"no cost rule for kernel entry {entry!r}")


def _kind(w: Workload) -> str:
    return "mlp" if w.entry.endswith("mlp") else "svm"


def geometry(w: Workload, block_m: Optional[int] = None):
    """The kernel's launch geometry for ``w`` at tile ``block_m`` (None:
    the heuristic), from kernels/envelope.py's mirrors of the CUDA
    ``geometry_of``; raises ValueError for a tile the kernel refuses."""
    fam, n = family(w.entry), w.levels
    if fam == "quantize":
        return envelope.quantize_geometry(w.p, w.m, w.c, n, block_m)
    if fam == "mc":
        return envelope.mc_geometry(w.p, w.s, w.m, w.c, n, block_m)
    return envelope.bank_geometry(_kind(w), w.d, w.m, w.c, n, w.h, w.o,
                                  block_m)


def heuristic_block_m(w: Workload) -> int:
    """The rows of the kernel's own tile for ``w`` (its geometry with
    ``block_m=None``): the bank's rows, the Monte-Carlo chunk's rows, and
    for the quantizer the whole rows of its span (span // C, at least 1;
    the span need not be a whole number of rows)."""
    g = geometry(w)
    fam = family(w.entry)
    if fam == "quantize":
        return max(1, g.span // w.c)
    if fam == "mc":
        return g.chunk_rows
    return g.rows


def wave_blocks(w: Workload) -> int:
    """The blocks one wave of the entry's kernel holds on an H100: the
    blocks its heuristic aims to fill the card with (two quantizer or
    Monte-Carlo blocks an SM, one bank block an SM)."""
    return {"quantize": envelope.Q_MIN_BLOCKS, "mc": envelope.MC_MIN_BLOCKS,
            "bank": envelope.BANK_MIN_BLOCKS}[family(w.entry)]


def cost(w: Workload, block_m: Optional[int] = None) -> Cost:
    """Bytes and operations of one launch of ``w.entry`` (see the module
    docstring), with the shared memory and blocks of tile ``block_m``
    (None: the heuristic). Counts are positive and never shrink as M, P,
    S or D grow."""
    fam, n, c, m = family(w.entry), w.levels, w.c, w.m
    g = geometry(w, block_m)
    blocks = int(g.grid_x) * int(g.grid_y)
    if fam == "quantize":
        p = w.p
        return Cost(float(_QUANTIZE_OPS * p * m * c), 0.0,
                    float(F32 * (m * c + p * c * n + 2 * c + p * m * c)),
                    g.smem_bytes, blocks)
    if fam == "mc":
        p, s = w.p, w.s
        tab = p * s * c * n
        values = tab if "_cal" in w.entry else c * n
        return Cost(float(p * s * m * c * (_MC_BASE_OPS + _MC_LEAF_OPS * n)),
                    0.0,
                    float(F32 * (m * c + 2 * tab + values + 2 * s * c
                                 + p * s * m * c)),
                    g.smem_bytes, blocks)
    d, h, o = w.d, w.h, w.o
    if _kind(w) == "mlp":
        resident = c * n + c * h + h + h * o + o
        dot = 2.0 * d * m * (c * h + h * o)
    else:
        resident = c * n + c * o + o
        dot = 2.0 * d * m * c * o
    return Cost(dot, dot, float(F32 * (m * c + d * m * o + d * resident
                                       + 2 * c)),
                g.smem_bytes, blocks)


def bound(w: Workload, machine: Optional[MachineModel] = None) -> Dict:
    """The least time the card could take for ``w``: the larger of its
    bytes over the memory rate and its operations over the float32 peak,
    with which of the two bounds it."""
    mm = machine if machine is not None else machine_model()
    cst = cost(w)
    t_bytes = cst.hbm_bytes / mm.hbm_bw
    t_ops = cst.flops / mm.peak_flops
    return {"bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": cst.hbm_bytes, "flops": cst.flops}


def roofline_estimate(w: Workload, block_m: Optional[int] = None,
                      machine: Optional[MachineModel] = None,
                      backend: str = "cuda", device=None) -> Dict:
    """Roofline record of one launch at tile ``block_m`` (None: the
    heuristic), in the reference's record shape (compute_s / memory_s /
    collective_s / dominant / roofline_fraction / estimated_s): the bound
    is ``max(compute_s, memory_s)``; ``overhead_s`` is the machine's
    launch term plus its wave term for each wave of blocks beyond the
    first; ``estimated_s`` = bound + overhead orders candidate tiles and
    is never reported as a bound. One card, so the collective term is
    zero."""
    mm = machine if machine is not None else machine_model(backend, device)
    cst = cost(w, block_m)
    compute_s = cst.flops / mm.peak_flops
    memory_s = cst.hbm_bytes / mm.hbm_bw
    waves = math.ceil(cst.blocks / wave_blocks(w))
    overhead_s = mm.launch_s + max(0, waves - 1) * mm.wave_s
    bound_s = max(compute_s, memory_s)
    dominant = "compute" if compute_s >= memory_s else "memory"
    if overhead_s > bound_s:
        dominant = "overhead"
    return {
        "entry": w.entry, "workload": w.to_meta(),
        "block_m": block_m if block_m else heuristic_block_m(w),
        "machine": mm.name,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": 0.0, "overhead_s": overhead_s,
        "bound_s": bound_s,
        "bound_by": "bytes" if memory_s >= compute_s else "operations",
        "dominant": dominant, "waves": waves,
        "model_flops_global": cst.flops,
        "useful_flops_ratio": 1.0,
        "roofline_fraction": min(compute_s / max(bound_s + overhead_s,
                                                 1e-30), 1.0),
        "arithmetic_intensity": cst.arithmetic_intensity,
        "estimated_s": bound_s + overhead_s,
        "cost": cst.to_meta(),
    }
