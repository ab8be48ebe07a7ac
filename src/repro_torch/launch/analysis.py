"""Roofline analysis of the LM's steps. Counterpart of
``repro/launch/analysis.py``.

The reference derives a step's three roofline terms from the post-SPMD
HLO of the compiled step:

  compute term    = FLOPs per device / peak FLOP/s
  memory term     = HBM traffic bytes per device / HBM rate
  collective term = collective bytes per device / link rate

The port runs eagerly and produces no HLO, so ``hlo_stats`` (the
reference's HLO text parser, ``:298``) is not ported. Its counterpart is
``count_step``, which runs the port's own step and counts it op by op:

* ``flops``: every aten op's FLOPs by ``torch.utils.flop_counter``'s
  formulas (the matrix products; elementwise ops count 0, as in the
  reference's dot-only count), plus each hand kernel's analytic count;
* ``traffic_bytes``: 2 x the output bytes of every aten op that is not a
  view, an alias or an allocation: the reference's "write + one read"
  (``:346``); an in-place update of some rows (``index_copy_``,
  ``index_put_``) counts its update, as the reference's
  dynamic-update-slice does; a copy between devices (the host's
  constants moved to the card) is counted apart, in ``transfers``. Every
  eager op round-trips device memory, so for the port this is close to
  what the card moves;
* ``dot_ops``: the matrix-product calls; ``top_traffic``: the op names
  that move the most.

A hand kernel's call (``kernels/dispatch.kernel_unit``) is one unit,
priced analytically, and the aten ops run inside it are left out on every
route: the plain version's on the CPU, the output allocations on the card
and on meta. So the same step counts the same on cuda, cpu and meta, and
on meta (``launch/dryrun.py``) at sizes no card holds. Attention (rows 11
and 11b) is priced as ``chip_smoke.py`` prices the kernels'
bounds (``attention_fwd_cost``, ``attention_bwd_cost``): 4 dh FLOPs a
visible (query, key) pair a head forward, 10 dh backward (the gradient's
five products); q, k, v and the output read or written once (plus dq,
dk, dv and the output's cotangent backward). Meta tensors carry no
positions, so the visible pairs come from the shapes and the mask's
parameters (causal, window), positions assumed contiguous
(``visible_pairs``), on every device. M-RoPE's vision grid, whose tokens
share a time step and see each other both ways (ROADMAP C), is counted
as causal. Rows 1-10 are priced by ``perf/cost_model.py``.

The port recomputes each layer in the backward (``cfg.remat == "full"``),
and the count includes the recomputation: ``useful_flops_ratio`` =
model FLOPs / counted FLOPs, as in the reference.

Machine rows (``Machine``): ``V5E``, the reference's TPU v5e constants
(``PEAK_FLOPS``, ``HBM_BW``, ``LINK_BW``, kept for the parity tests), and
``H100``, the port's card. Both are data-sheet figures, no measurement.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import dispatch
from repro_torch.perf import cost_model
from repro_torch.perf.workload import Workload


@dataclasses.dataclass(frozen=True)
class Machine:
    """A roofline's three ceilings: peak FLOP/s of the step's product
    type, device memory bytes/s and bytes/s a link direction."""
    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float


# the reference's TPU v5e: 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s a link
V5E = Machine("tpu-v5e", 197e12, 819e9, 50e9)
PEAK_FLOPS, HBM_BW, LINK_BW = V5E.peak_flops, V5E.hbm_bw, V5E.link_bw
# NVIDIA H100 SXM (700 W) data sheet: 989 TFLOP/s dense bf16 on the tensor
# cores, 3.35 TB/s HBM3 (perf/cost_model.py's row), NVLink 4 at 450 GB/s
# a direction. Data-sheet figures, not measurements.
H100 = Machine("nvidia-h100-sxm", 989e12,
               cost_model.MACHINE_MODELS["cuda"].hbm_bw, 450e9)


# ------------------------------------------------------------ attention
def visible_pairs(s: int, sk: int, *, causal: bool, window: int) -> int:
    """(query, key) pairs one (batch row, head) leaves unmasked, positions
    assumed contiguous: keys at 0..sk-1, the s queries at the last s of
    them (sk - s..sk - 1). A key is visible to a query at p when p - key
    >= 0 (causal) and p - key < window (window > 0)."""
    p = np.arange(sk - s, sk, dtype=np.int64)
    hi = np.minimum(p, sk - 1) if causal else np.full_like(p, sk - 1)
    lo = np.maximum(p - window + 1, 0) if window else np.zeros_like(p)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def attention_fwd_cost(b: int, s: int, sk: int, h: int, kv: int, dh: int,
                       itemsize: int, pairs: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention call: 2 FLOPs a multiply-add of
    q.k and of p.v over the ``pairs`` visible pairs of each (row, head);
    q, k, v and the two position vectors read once, the output written
    once."""
    flops = 4.0 * b * h * dh * pairs
    nbytes = (2.0 * b * s * h * dh + 2.0 * b * sk * kv * dh) * itemsize \
        + 4.0 * (s + sk)
    return flops, nbytes


def attention_bwd_cost(b: int, s: int, sk: int, h: int, kv: int, dh: int,
                       itemsize: int, pairs: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention gradient: the five products of dh
    multiply-adds a visible pair (q.k recomputed, do.v, and the dq, dk, dv
    products); q, k, v, the output's cotangent and the positions read
    once, dq, dk and dv written once."""
    flops = 10.0 * b * h * dh * pairs
    nbytes = (3.0 * b * s * h * dh + 4.0 * b * sk * kv * dh) * itemsize \
        + 4.0 * (s + sk)
    return flops, nbytes


def unit_cost(entry: str, shapes: Dict) -> Tuple[float, float]:
    """(FLOPs, bytes) of one hand-kernel call ``entry`` at the shapes its
    wrapper reports (``dispatch.kernel_unit``)."""
    if entry in ("flash_attention", "flash_attention_bwd"):
        sh = shapes
        pairs = visible_pairs(sh["s"], sh["sk"], causal=sh["causal"],
                              window=sh["window"])
        fn = attention_fwd_cost if entry == "flash_attention" \
            else attention_bwd_cost
        return fn(sh["b"], sh["s"], sh["sk"], sh["h"], sh["kv"], sh["dh"],
                  sh["itemsize"], pairs)
    name = dispatch.PERF_ENTRY[entry]
    n = shapes["n"]
    if n < 2 or n & (n - 1) or min(v for k, v in shapes.items()
                                   if k not in ("n", "h")) < 1:
        return 0.0, 0.0                 # an empty call, or no Workload
    dims = dict(shapes, c=shapes.get("c", shapes.get("f")))
    w = Workload(name, m=dims["m"], c=dims["c"], bits=n.bit_length() - 1,
                 **{k: dims[k] for k in ("p", "d", "s", "h", "o")
                    if k in dims})
    cst = cost_model.cost(w)
    return cst.flops, cst.hbm_bytes


# ------------------------------------------------------------ the counter
@dataclasses.dataclass
class StepStats:
    """The counterpart of the reference's ``HloStats``: its fields and its
    ``to_dict`` keys, plus what the counter sees beyond HLO:
    ``kernel_units`` (entry -> calls, FLOPs, bytes of the hand-kernel
    calls), ``ops`` (aten op -> [calls, traffic bytes]) and ``transfers``
    ([calls, bytes] of copies between devices: the host's constants moved
    to the card, no device-memory round trip). The collective
    fields stay 0 from ``count_step``: an eager single-device step has no
    collective; the dry run adds the gradient sync's."""
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_ops: int = 0
    dot_ops: int = 0
    top_traffic: List = dataclasses.field(default_factory=list)
    top_collectives: List = dataclasses.field(default_factory=list)
    kernel_units: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    ops: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    transfers: List[float] = dataclasses.field(
        default_factory=lambda: [0, 0.0])

    def to_dict(self):
        return {"flops": self.flops, "traffic_bytes": self.traffic_bytes,
                "collective_bytes": self.collective_bytes,
                "collectives": dict(self.collectives),
                "collective_ops": self.collective_ops,
                "dot_ops": self.dot_ops,
                "top_traffic": self.top_traffic,
                "top_collectives": self.top_collectives,
                "kernel_units": self.kernel_units, "ops": self.ops,
                "transfers": self.transfers}

    def scaled(self, work: float, calls: float = 1.0) -> "StepStats":
        """These stats with the work (FLOPs, bytes) times ``work`` and the
        call counts times ``calls``."""
        return StepStats(
            self.flops * work, self.traffic_bytes * work,
            self.collective_bytes * work,
            defaultdict(float, {k: v * work
                                for k, v in self.collectives.items()}),
            round(self.collective_ops * calls), round(self.dot_ops * calls),
            [[v * work, lbl] for v, lbl in self.top_traffic],
            [[v * work, lbl] for v, lbl in self.top_collectives],
            {k: {"calls": u["calls"] * calls, "flops": u["flops"] * work,
                 "bytes": u["bytes"] * work}
             for k, u in self.kernel_units.items()},
            {k: [c * calls, b * work] for k, (c, b) in self.ops.items()},
            [self.transfers[0] * calls, self.transfers[1] * work])

    def __add__(self, other: "StepStats") -> "StepStats":
        units = {k: dict(u) for k, u in self.kernel_units.items()}
        for k, u in other.kernel_units.items():
            mine = units.setdefault(k, {"calls": 0, "flops": 0.0,
                                        "bytes": 0.0})
            for f in ("calls", "flops", "bytes"):
                mine[f] += u[f]
        ops = {k: list(v) for k, v in self.ops.items()}
        for k, (c, b) in other.ops.items():
            mine = ops.setdefault(k, [0, 0.0])
            mine[0] += c
            mine[1] += b
        coll = defaultdict(float, self.collectives)
        for k, v in other.collectives.items():
            coll[k] += v
        out = StepStats(self.flops + other.flops,
                        self.traffic_bytes + other.traffic_bytes,
                        self.collective_bytes + other.collective_bytes,
                        coll, self.collective_ops + other.collective_ops,
                        self.dot_ops + other.dot_ops, [],
                        self.top_collectives + other.top_collectives,
                        units, ops,
                        [a + b for a, b in zip(self.transfers,
                                               other.transfers)])
        out.top_traffic = _top(units, ops)
        return out


# in-place updates of a slice of their output: the update operand moves,
# not the whole buffer (the reference's dynamic-update-slice rule)
_UPDATES = {"aten.index_copy_": 3, "aten.index_put_": 2}
# allocations and aliases the dispatcher does not mark as views: no bytes
_NO_TRAFFIC = {"aten.empty", "aten.empty_like", "aten.empty_strided",
               "aten.new_empty", "aten.new_empty_strided",
               "aten._unsafe_view", "aten.set_", "aten.resize_",
               "aten._local_scalar_dense"}


def _top(units, ops, top_k: int = 12) -> List:
    items = [(b, f"{name} x{c}") for name, (c, b) in ops.items()]
    items += [(u["bytes"], f"unit {name} x{u['calls']}")
              for name, u in units.items()]
    items.sort(key=lambda kv: -kv[0])
    return [[v, lbl] for v, lbl in items[:top_k]]


class _Counter(TorchDispatchMode):
    """The dispatch mode behind ``count_step`` (see the module
    docstring). ``depth`` > 0 while a hand kernel's unit runs: its ops
    are not counted."""

    def __init__(self):
        super().__init__()
        self.depth = 0
        self.flops = 0.0
        self.dot_ops = 0
        self.units: Dict[str, Dict[str, float]] = {}
        self.ops: Dict[str, List[float]] = {}
        self.transfers = [0, 0.0]

    def unit(self, entry: str, shapes: Dict) -> None:
        if self.depth:
            return                       # a unit inside a unit: its own
        flops, nbytes = unit_cost(entry, shapes)
        u = self.units.setdefault(entry, {"calls": 0, "flops": 0.0,
                                          "bytes": 0.0})
        u["calls"] += 1
        u["flops"] += flops
        u["bytes"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.depth:
            return out
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
            self.dot_ops += 1
        name = str(packet)
        if func.is_view or name in _NO_TRAFFIC:
            return out
        moved = args[_UPDATES[name]] if name in _UPDATES else out
        nbytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(moved)
                     if isinstance(t, torch.Tensor))
        if name in ("aten._to_copy", "aten.copy_") and any(
                t.device != out.device for t in tree_leaves(args)
                if isinstance(t, torch.Tensor)):
            self.transfers[0] += 1           # between devices, e.g. the
            self.transfers[1] += nbytes      # host's constants to the card
            return out
        rec = self.ops.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += 2.0 * nbytes           # write + ~one read
        return out


def count_step(fn, *args, **kwargs) -> Tuple[StepStats, object]:
    """Run ``fn(*args, **kwargs)`` once and count it: (``StepStats``,
    ``fn``'s result). The same step counts the same on cuda, cpu and
    meta (see the module docstring)."""
    counter = _Counter()
    with dispatch.counting(counter), counter:
        result = fn(*args, **kwargs)
    unit_flops = sum(u["flops"] for u in counter.units.values())
    unit_bytes = sum(u["bytes"] for u in counter.units.values())
    st = StepStats(flops=counter.flops + unit_flops,
                   traffic_bytes=sum(b for _, b in counter.ops.values())
                   + unit_bytes,
                   dot_ops=counter.dot_ops, kernel_units=counter.units,
                   ops=counter.ops, transfers=counter.transfers)
    st.top_traffic = _top(counter.units, counter.ops)
    return st, result


# -------------------------------------------------------------- roofline
def roofline(stats, *, chips: int, model_flops_global: float,
             ideal_bytes_per_dev: float = 0.0,
             machine: Machine = H100) -> Dict[str, float]:
    """The reference's roofline record (``:364``) of per-device ``stats``
    (a ``StepStats`` or the reference's ``HloStats``) on ``machine``."""
    compute_s = stats.flops / machine.peak_flops
    memory_s = stats.traffic_bytes / machine.hbm_bw
    coll_s = stats.collective_bytes / machine.link_bw
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", coll_s), key=lambda kv: kv[1])[0]
    bound = max(compute_s, memory_s, coll_s)
    useful = model_flops_global / max(stats.flops * chips, 1.0)
    mfu = (model_flops_global / chips / machine.peak_flops) / max(bound,
                                                                 1e-30)
    out = {"compute_s": compute_s, "memory_s": memory_s,
           "collective_s": coll_s, "dominant": dominant,
           "model_flops_global": model_flops_global,
           "useful_flops_ratio": min(useful, 1.0),
           "roofline_fraction": min(mfu, 1.0)}
    if ideal_bytes_per_dev:
        # memory-dominated cells score achieved bandwidth: the unavoidable
        # traffic over the traffic the step does
        out["ideal_bytes_per_dev"] = ideal_bytes_per_dev
        out["bandwidth_fraction"] = min(
            ideal_bytes_per_dev / max(stats.traffic_bytes, 1.0), 1.0)
        out["score"] = (out["bandwidth_fraction"] if dominant == "memory"
                        else out["roofline_fraction"])
    return out


def ideal_bytes(cfg, shape, chips: int, n_microbatches: int = 1) -> float:
    """Unavoidable per-device HBM traffic per step (the reference's
    documented lower bound):
      train:   params re-read fwd+bwd per microbatch (2 x n_mb) + optimizer
               update (read m,v,params + write all: ~3x(params+opt)),
      prefill: params once + 2L activation writes/reads,
      decode:  params(active) + the KV/SSM cache, each streamed once.
    """
    pb = {"float32": 4, "bfloat16": 2}.get(cfg.param_dtype, 4)
    ob = {"float32": 4, "bfloat16": 2}.get(cfg.opt_state_dtype, 4)
    n_total = cfg.param_counts()["total"]
    n_active = cfg.param_counts()["active"]
    params_b = n_total * pb / chips
    opt_b = 2 * n_total * ob / chips
    act_b = (shape.global_batch * shape.seq_len * cfg.d_model
             * 2 * 2 * cfg.num_layers / chips)
    if shape.kind == "train":
        return params_b * 2 * n_microbatches + 3 * (params_b + opt_b) + act_b
    if shape.kind == "prefill":
        return params_b + act_b
    cache_b = 0.0
    if cfg.num_kv_heads:
        clen = min(shape.seq_len, cfg.window) if cfg.attn_type == "sliding" \
            else shape.seq_len
        cache_b = (cfg.num_layers * shape.global_batch * clen
                   * cfg.num_kv_heads * cfg.resolved_head_dim * 2 * 2) / chips
    if cfg.ssm is not None:
        from repro_torch.models import ssm as ssm_lib
        dm = ssm_lib.dims(cfg.d_model, cfg.ssm)
        cache_b += (cfg.num_layers * shape.global_batch * dm["nheads"]
                    * cfg.ssm.state_dim * cfg.ssm.head_dim * 4) / chips
    return n_active * pb / chips + cache_b


def model_flops(cfg, shape) -> float:
    """Analytic model FLOPs: 6 N D train (N active params, D tokens),
    2 N D for an inference forward; decode counts the one new token."""
    n_active = cfg.param_counts()["active"]
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    return 2.0 * n_active * shape.global_batch       # decode: 1 token/seq


def unit_calls(stats: StepStats) -> Dict[str, int]:
    """{entry: calls} of the hand-kernel units a count saw."""
    return {k: int(u["calls"]) for k, u in stats.kernel_units.items()}

