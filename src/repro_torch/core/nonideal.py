"""Hardware non-ideality model for pruned binary-search ADCs. Counterpart
of ``repro/core/nonideal.py``.

Three non-idealities, frozen in ``NonIdealSpec``:

* per-comparator input-referred offset, ``sigma_offset`` in LSBs;
* per-channel reference-ladder drift, ``sigma_range`` as a fraction of
  the channel's full scale (both endpoints);
* stuck-at-0/1 faults, ``fault_rate`` per surviving comparator (the
  direction a fair coin).

A perturbed binary-search tree still maps every input to exactly one
kept leaf, and the inputs reaching leaf ``k`` form an interval.
``instance_bounds`` compiles mask + draws into per-instance interval
tables ``(lb, ub)`` in code units, the ``u = (x - vmin_row) * scale_row``
domain of every kernel, and the Monte-Carlo kernels
(kernels/mc_eval.py) select ``values[c, k]`` for the k with
``lb <= u < ub``. With every knob at zero the intervals are the exact
integer code boundaries, so zero-sigma Monte-Carlo equals the ideal
quantizer bit for bit.

The draw stream. ``draw`` is a pure function of (seed, bits, channels,
samples): one ``torch.Generator`` on the CPU seeded with
``NonIdealSpec.seed`` draws, in this order, ``eps`` (standard normal,
``torch.randn``), ``fault_u`` (uniform in [0, 1), ``torch.rand``),
``stuck_hi`` (``torch.rand(...) < 0.5``) and ``drift`` (``torch.randn``),
then the block moves to the device. The stream is the same on the CPU
and on the card, and differs from the reference's ``jax.random`` one;
every function that takes ``Draws`` also takes numpy arrays, so tests
inject the reference's draws. As in the reference, instance ``k`` of an
S-sample stream is reproduced only by drawing S samples and slicing.

Rounding. Every float32 step below is its own PyTorch operation, rounded
once: ``t = mid + sigma * eps`` is a multiply and then an add, never an
``addcmul``, ``lerp`` or compiled kernel that could contract them into
one fused multiply-add. The operands therefore equal the reference's
eager (un-jitted) ``mc_operands`` bit for bit, on the CPU and on the
card. (The reference's jitted search fuses that multiply-add, so its
in-search tables can differ from its eager ones by an ulp.)

The host-side reductions (``mc_mean_accuracy``, ``yield_fraction``,
``robust_objective``) are numpy copies: float64, exact for float32
instance accuracies, so the search fitness and the deployed report
compute the same number from the same instance accuracies.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

ROBUST_OBJECTIVES = ("expected", "worst", "yield")


@dataclasses.dataclass(frozen=True)
class NonIdealSpec:
    """Frozen description of one hardware non-ideality regime.

    sigma_offset: per-comparator input-referred offset sigma, in LSBs.
    sigma_range: per-channel reference-ladder drift sigma, as a fraction
        of the channel's full scale (applied to both endpoints).
    fault_rate: stuck-at-0/1 probability per surviving comparator.
    seed: Monte-Carlo draw stream identity.
    """
    sigma_offset: float = 0.0
    sigma_range: float = 0.0
    fault_rate: float = 0.0
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "sigma_offset", float(self.sigma_offset))
        object.__setattr__(self, "sigma_range", float(self.sigma_range))
        object.__setattr__(self, "fault_rate", float(self.fault_rate))
        object.__setattr__(self, "seed", int(self.seed))
        if self.sigma_offset < 0 or self.sigma_range < 0:
            raise ValueError(f"sigmas must be >= 0, got "
                             f"sigma_offset={self.sigma_offset} "
                             f"sigma_range={self.sigma_range}")
        if not 0.0 <= self.fault_rate <= 1.0:
            raise ValueError(f"fault_rate must be in [0, 1], got "
                             f"{self.fault_rate}")

    @property
    def ideal(self) -> bool:
        """True when every knob is zero."""
        return (self.sigma_offset == 0.0 and self.sigma_range == 0.0
                and self.fault_rate == 0.0)

    def replace(self, **kw) -> "NonIdealSpec":
        return dataclasses.replace(self, **kw)

    def to_meta(self) -> dict:
        return {"sigma_offset": self.sigma_offset,
                "sigma_range": self.sigma_range,
                "fault_rate": self.fault_rate, "seed": self.seed}

    @classmethod
    def from_meta(cls, meta: dict) -> "NonIdealSpec":
        return cls(sigma_offset=float(meta["sigma_offset"]),
                   sigma_range=float(meta["sigma_range"]),
                   fault_rate=float(meta["fault_rate"]),
                   seed=int(meta.get("seed", 0)))

    def describe(self) -> str:
        return (f"sigma_offset={self.sigma_offset}LSB "
                f"sigma_range={self.sigma_range}FS "
                f"fault_rate={self.fault_rate} seed={self.seed}")


class Draws(NamedTuple):
    """The raw Monte-Carlo randomness for S instances, independent of any
    mask: common random numbers across a population.

    eps: (S, C, 2^N - 1) standard-normal threshold offsets, one per tree
        node (flat heap order: node (d, i) at index 2^d - 1 + i).
    fault_u: (S, C, 2^N - 1) uniforms; a node faults when < fault_rate.
    stuck_hi: (S, C, 2^N - 1) bools; a faulted node sticks at 1 (always
        takes the upper half) when True, at 0 otherwise.
    drift: (S, C, 2) standard normals for the two range endpoints.
    """
    eps: torch.Tensor
    fault_u: torch.Tensor
    stuck_hi: torch.Tensor
    drift: torch.Tensor

    @property
    def samples(self) -> int:
        return self.eps.shape[-3]


def to_tensor(a, device=None, dtype=None) -> torch.Tensor:
    """A tensor, numpy array or nested list as a tensor on ``device``
    (default: where a tensor lies, else the CPU) in ``dtype`` (default:
    its own)."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.array(a))
    return t.to(device=t.device if device is None else device,
                dtype=t.dtype if dtype is None else dtype)


def as_draws(draws, device=None, cls=None):
    """``draws`` (a ``Draws``, or any 4-tuple of arrays or tensors in its
    field order, such as the reference's draws as numpy) as a ``cls``
    (default: ``Draws``, or the type of a ``Draws`` given) of tensors on
    ``device`` (default: where ``eps`` lies, the CPU for numpy):
    eps/fault_u/drift float32, stuck_hi bool."""
    if cls is None:
        cls = type(draws) if isinstance(draws, Draws) else Draws
    eps = draws[0]
    dev = (torch.device(device) if device is not None
           else eps.device if isinstance(eps, torch.Tensor)
           else torch.device("cpu"))
    f32 = torch.float32
    return cls(to_tensor(draws[0], dev, f32), to_tensor(draws[1], dev, f32),
               to_tensor(draws[2], dev, torch.bool),
               to_tensor(draws[3], dev, f32))


def draw(bits: int, channels: int, samples: int, nonideal: NonIdealSpec,
         device=None) -> Draws:
    """The full randomness block for ``samples`` MC instances: a pure
    function of ``nonideal.seed`` and the shapes (module docstring, the
    draw stream), on ``device`` (default the CPU)."""
    return Draws(*draw_stream(bits, channels, samples, nonideal, (), device))


def draw_stream(bits, channels, samples, nonideal, node_tail, device):
    """The documented stream: eps, fault_u, stuck_hi, drift from one CPU
    generator seeded with ``nonideal.seed``; node arrays are
    (S, C, 2^N - 1, *node_tail)."""
    if samples < 1:
        raise ValueError(f"need >= 1 MC sample, got {samples}")
    gen = torch.Generator().manual_seed(int(nonideal.seed))
    shape = (samples, channels, 2 ** bits - 1) + tuple(node_tail)
    eps = torch.randn(shape, generator=gen, dtype=torch.float32)
    fault_u = torch.rand(shape, generator=gen, dtype=torch.float32)
    stuck_hi = torch.rand(shape, generator=gen, dtype=torch.float32) < 0.5
    drift = torch.randn((samples, channels, 2), generator=gen,
                        dtype=torch.float32)
    dev = torch.device("cpu") if device is None else torch.device(device)
    return tuple(t.to(dev) for t in (eps, fault_u, stuck_hi, drift))


def _f32(v: float, device) -> torch.Tensor:
    """A python number as a float32 0-d tensor, rounded once, as the
    reference's weakly typed scalars are."""
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def instance_bounds(mask, bits: int, draws, nonideal: NonIdealSpec
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compile mask + draws into per-instance interval tables.

    mask: (C, 2^N) or population-batched (P, C, 2^N) {0,1}. Returns
    ``(lb, ub)`` float32 of shape (S, C, 2^N) / (P, S, C, 2^N) on the
    draws' device: input ``u`` (code units) reaches kept leaf ``k`` of
    instance ``s`` iff ``lb[..., s, c, k] <= u < ub[..., s, c, k]``.
    Unreachable leaves get (+inf, -inf). Draws whose node arrays carry a
    leading design axis ((P, S, C, 2^N - 1), the fault-tolerant fold)
    broadcast against it."""
    draws = as_draws(draws)
    dev = draws.eps.device
    m = to_tensor(mask, dev, torch.int32)
    n = 2 ** bits
    if m.shape[-1] != n:
        raise ValueError(f"mask last dim {m.shape[-1]} != 2^bits {n}")
    cs = torch.cat([torch.zeros(m.shape[:-1] + (1,), dtype=torch.int32,
                                device=dev),
                    torch.cumsum(m, dim=-1, dtype=torch.int32)], dim=-1)
    codes = np.arange(n)
    sigma = _f32(nonideal.sigma_offset, dev)
    frate = _f32(nonideal.fault_rate, dev)
    ex = lambda a: a.unsqueeze(-3)  # noqa: E731  (..., C, n) -> (..., 1, C, n)
    bshape = torch.broadcast_shapes(ex(m).shape,
                                    tuple(draws.eps.shape[:-1]) + (n,))
    L = torch.full(bshape, -torch.inf, dtype=torch.float32, device=dev)
    U = torch.full(bshape, torch.inf, dtype=torch.float32, device=dev)
    empty = torch.zeros(bshape, dtype=torch.bool, device=dev)
    for d in range(bits):
        seg = n >> d
        anc_lo = (codes // seg) * seg                 # ancestor segment start
        mid = anc_lo + seg // 2
        right = torch.as_tensor((codes % seg) >= seg // 2, device=dev)
        at = lambda idx: cs[..., torch.as_tensor(idx, device=dev)]  # noqa
        la = (at(mid) - at(anc_lo)) > 0               # (..., C, n)
        ra = (at(anc_lo + seg) - at(mid)) > 0
        alive = la & ra
        node = torch.as_tensor((2 ** d - 1) + codes // seg, device=dev)
        pick = lambda a: a[..., node]  # noqa: E731
        # one multiply, then one add: each rounded once (module docstring)
        offset = sigma * pick(draws.eps)
        t = torch.as_tensor(mid, dtype=torch.float32, device=dev) + offset
        faulty = ex(alive) & (pick(draws.fault_u) < frate)
        healthy = ex(alive) & ~faulty
        L = torch.where(healthy & right, torch.maximum(L, t), L)
        U = torch.where(healthy & ~right, torch.minimum(U, t), U)
        # a stuck comparator always takes its stuck half; a bypassed
        # (dead) node always takes its surviving half: leaves on the
        # other side become unreachable
        empty = empty | (faulty & (pick(draws.stuck_hi) != right))
        empty = empty | ex((~alive) & ((la & right) | (ra & ~right)
                                       | (~la & ~ra)))
    lb = torch.where(empty, torch.inf, L)
    ub = torch.where(empty, -torch.inf, U)
    return lb, ub


def instance_rows(spec, channels: int, draws, nonideal: NonIdealSpec
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-instance reference-ladder code math: the canonical f64-derived
    ``(vmin_row, scale_row)`` of ``spec`` with per-(instance, channel)
    endpoint drift applied. Returns float32 ``(lo (S, C), scale (S, C))``
    on the draws' device. With ``sigma_range == 0`` both rows equal the
    ideal rows bitwise (the drift terms are exact zeros)."""
    drift = as_draws(draws).drift
    dev = drift.device
    lo, scale = (torch.from_numpy(a).to(dev)
                 for a in spec.range_rows(channels))      # (1, C)
    span = _f32(2 ** spec.bits, dev) / scale              # full scale
    sr = _f32(nonideal.sigma_range, dev)
    d_lo = sr * drift[..., 0] * span                      # (S, C)
    d_hi = sr * drift[..., 1] * span
    lo_s = lo + d_lo
    scale_s = scale * (span / (span + (d_hi - d_lo)))
    return lo_s, scale_s


def level_value_rows(spec, channels: int, device=None) -> torch.Tensor:
    """The (C, 2^N) per-channel reconstruction ladder the MC kernels
    select from: ``AdcSpec.level_values`` as explicit channel rows (the
    digital back end is unperturbed)."""
    values = spec.level_values(channels).to(torch.float32)
    if values.ndim == 1:
        values = values[None, :].expand(channels, values.shape[0])
    return values.contiguous().to(device)


def mc_operands(spec, nonideal: NonIdealSpec, mask, draws=None,
                samples: Optional[int] = None, device=None):
    """Compile (spec, nonideal, mask) into the MC kernels' operand tuple
    ``(lb, ub, values, lo, scale)``, the argument order of the
    ``ops.mc_eval*`` entries, contiguous float32 on ``device`` (default:
    the draws', else the CPU). Pass ``draws`` to reuse a stream;
    otherwise ``samples`` fresh draws come from ``nonideal.seed``."""
    channels = np.shape(mask)[-2]
    if draws is None:
        if samples is None:
            raise ValueError("pass draws= or samples=")
        draws = draw(spec.bits, channels, samples, nonideal, device)
    else:
        draws = as_draws(draws, device)
    lb, ub = instance_bounds(mask, spec.bits, draws, nonideal)
    lo, scale = instance_rows(spec, channels, draws, nonideal)
    values = level_value_rows(spec, channels, lb.device)
    return tuple(t.contiguous() for t in (lb, ub, values, lo, scale))


def mc_quantize(x: torch.Tensor, mask, spec, nonideal: NonIdealSpec, *,
                draws=None, samples: Optional[int] = None) -> torch.Tensor:
    """Quantize one shared (M, C) sample batch through S Monte-Carlo
    perturbed instances of the pruned design(s): (S, M, C) for a (C, 2^N)
    mask, (P, S, M, C) for a (P, C, 2^N) population; the MC kernel on a
    CUDA tensor, its plain version on a CPU tensor."""
    spec.validate_channels(np.shape(mask)[-2])
    ops_ = mc_operands(spec, nonideal, mask, draws=draws, samples=samples,
                       device=x.device)
    if len(np.shape(mask)) == 3:
        return ops.mc_eval_population(x, *ops_, spec=spec)
    return ops.mc_eval(x, *ops_, spec=spec)


def robust_objective_name(kind: str) -> str:
    if kind not in ROBUST_OBJECTIVES:
        raise ValueError(f"robust_objective must be one of "
                         f"{ROBUST_OBJECTIVES}, got {kind!r}")
    return kind


def mc_mean_accuracy(mc_accs: np.ndarray) -> np.ndarray:
    """Mean accuracy over the MC instance axis, reduced on the host in
    f64: the sum of float32 values is exact and the division correctly
    rounded, so the mean is order-independent and, for S identical
    instances, exactly the instance value."""
    mc = np.asarray(mc_accs, np.float64)
    return mc.sum(axis=-1) / mc.shape[-1]


def yield_fraction(accs: np.ndarray, mc_accs: np.ndarray,
                   margin: float) -> np.ndarray:
    """yield@margin: the fraction of MC instances whose accuracy stays
    within ``margin`` of the design's ideal accuracy, reduced on the host
    in f64. accs: (...,) ideal accuracies; mc_accs: (..., S)."""
    accs = np.asarray(accs, np.float64)
    mc = np.asarray(mc_accs, np.float64)
    ok = mc >= (accs[..., None] - float(margin))
    return ok.sum(axis=-1, dtype=np.float64) / mc.shape[-1]


def robust_objective(accs: np.ndarray, mc_accs: np.ndarray,
                     kind: str, *, margin: float = 0.01) -> np.ndarray:
    """The minimized robustness fitness column, reduced on the host in
    f64. accs: (P,) ideal accuracies; mc_accs: (P, S) per-instance MC
    accuracies. 'expected': ``acc - mean_s(acc_s)``; 'worst':
    ``1 - min_s(acc_s)``; 'yield': ``1 - yield@margin``."""
    robust_objective_name(kind)
    accs = np.asarray(accs, np.float64)
    mc = np.asarray(mc_accs, np.float64)
    if kind == "worst":
        return 1.0 - mc.min(axis=-1)
    if kind == "yield":
        return 1.0 - yield_fraction(accs, mc, margin)
    return accs - mc_mean_accuracy(mc)
