"""The kernel-or-plain decision for every ported entry, the entry
registry, and the tuned tile policy. Counterpart of
``repro/kernels/dispatch.py``, with the port's routing rules:

1. a tensor on the CPU -> the plain PyTorch version (kernels/ref.py);
2. a CUDA tensor inside the Hopper envelope -> the hand-written kernel;
3. a CUDA tensor outside the envelope -> ``ValueError`` naming the limit.

There is no third route: a CUDA tensor never falls back to the plain
version or to the CPU.

Kernel-path resolutions also pick the tile (the ``block_m`` of the
reference's Pallas entries; here the bank kernels' rows, the quantizer's
span, the Monte-Carlo kernel's chunk, kernels/envelope.py): a **tuned
policy**, by default the autotuned table next to this module
(``tuned_tables.json``, written by perf/autotune.py), is consulted
first; where it has no entry for the (entry, shape class), where its
tile does not fit this call's shape, or where the table is missing,
corrupt or stale, the kernel's own heuristic applies (``block_m=None``).
The choice and its provenance (``block_m_source``: 'tuned' |
'heuristic') ride on the ``Resolution``, and each resolution is logged:
INFO the first time a distinct (entry, path, tile) is seen, DEBUG after.
A tile decides which block computes which rows, never an output's bits.

``entries()`` / ``get(name)`` give each of the ten non-attention entries
(the perf layer's names, ``perf/workload.ENTRIES``) with its kernel and
plain callables, both ``fn(x, tables, *weights, spec=...)``, the kernel
one also taking ``block_m``.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import envelope, ref
from repro_torch.perf.workload import Workload

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Resolution:
    """The routing decision for one call, JSON-able. ``block_m`` is the
    tuned tile on a kernel path (None: the kernel's own heuristic);
    ``block_m_source`` says where it came from ('tuned' | 'heuristic',
    None on the plain path and for attention)."""
    entry: str
    path: str                       # 'kernel' | 'plain'
    device: str
    reason: str
    route: str = ""                 # which kernel, where an entry has two
    block_m: Optional[int] = None
    block_m_source: Optional[str] = None

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


# ------------------------------------------------------------ tuned policy
# policy(entry_name, Workload) -> Optional[int]. Default: lazily load the
# committed tuned_tables.json via perf/autotune.load_policy (which
# validates version, backend and card, and degrades to None on any
# problem). Tiles resolved per (entry, shape) are kept until the policy
# changes.
_TUNED_POLICY: Optional[Callable] = None
_TUNED_LOADED = False
_TILES: Dict[tuple, Tuple[Optional[int], str]] = {}
_LOGGED: set = set()


def set_tuned_policy(policy: Optional[Callable]) -> None:
    """Install ``policy(entry, workload) -> Optional[int]`` as the tuned
    tile source (None disables tuning; the heuristic then always
    applies). Overrides the default table-file lookup."""
    global _TUNED_POLICY, _TUNED_LOADED
    _TUNED_POLICY = policy
    _TUNED_LOADED = True
    _TILES.clear()


def reset_tuned_policy() -> None:
    """Forget any installed or cached policy; the next resolution re-reads
    the default table file."""
    global _TUNED_POLICY, _TUNED_LOADED
    _TUNED_POLICY = None
    _TUNED_LOADED = False
    _TILES.clear()


def _tuned_policy() -> Optional[Callable]:
    global _TUNED_POLICY, _TUNED_LOADED
    if not _TUNED_LOADED:
        from repro_torch.perf import autotune
        _TUNED_POLICY = autotune.load_policy()
        _TUNED_LOADED = True
    return _TUNED_POLICY


def tuned_block_m(name: str, workload: Optional[Workload]
                  ) -> Tuple[Optional[int], str]:
    """The (block_m, source) pair a kernel-path resolution stamps: the
    tuned table's choice when it has one for this (entry, shape class),
    else (None, 'heuristic'), the kernel then applying its own
    heuristic."""
    if workload is not None:
        policy = _tuned_policy()
        if policy is not None:
            bm = policy(name, workload)
            if bm is not None:
                return int(bm), "tuned"
    return None, "heuristic"


def _tile(key: tuple, workload: Callable[[], Optional[Workload]],
          fits: Callable[[int], bool]) -> Tuple[Optional[int], str]:
    """``tuned_block_m`` for one call's shape, kept per ``key``; a tuned
    tile that this exact shape cannot take (``fits``: a shape class
    spans several M and D) resolves to the heuristic."""
    got = _TILES.get(key)
    if got is None:
        bm, src = tuned_block_m(key[0], workload())
        if bm is not None and not fits(bm):
            bm, src = None, "heuristic"
        if len(_TILES) > 4096:
            _TILES.clear()
        got = _TILES[key] = (bm, src)
    return got


def _log(res: Resolution) -> None:
    key = (res.entry, res.path, res.route, res.block_m, res.block_m_source)
    level = logging.DEBUG if key in _LOGGED else logging.INFO
    _LOGGED.add(key)
    if not log.isEnabledFor(level):
        return
    tile = ("" if res.block_m_source is None
            else f"[block_m={res.block_m or 'auto'}:{res.block_m_source}]")
    log.log(level, "dispatch %s -> %s%s%s (%s)", res.entry, res.path,
            f"[{res.route}]" if res.route else "", tile, res.reason)


def _route(entry: str, x, why,
           tile: Optional[Callable[[], Tuple[Optional[int], str]]] = None
           ) -> Resolution:
    """The three rules, with ``why()`` naming the envelope limit a CUDA
    call breaks (None inside the envelope) and ``tile()`` the kernel
    path's (block_m, source). Reads only ``x.device``."""
    dev = str(x.device)
    if x.device.type == "cpu":
        res = Resolution(entry, "plain", dev, "CPU tensor: plain version")
    else:
        if x.device.type != "cuda":
            raise ValueError(f"{entry}: unsupported device {x.device}")
        reason = why()
        if reason is not None:
            raise ValueError(f"{entry}: outside the Hopper kernel envelope: "
                             f"{reason}")
        bm, src = tile() if tile is not None else (None, None)
        res = Resolution(entry, "kernel", dev,
                         "CUDA tensor inside the Hopper envelope",
                         block_m=bm, block_m_source=src)
    _log(res)
    return res


def _bits(n: int) -> Optional[int]:
    """log2 of a table's level count, None where it is no power of two
    above 1 (such a call carries no workload)."""
    return n.bit_length() - 1 if n >= 2 and n & (n - 1) == 0 else None


def resolve(entry: str, kind: str, x, tables, weights) -> Resolution:
    """Decide how a bank entry runs on (x, tables, *weights): shapes are
    read from the bank operands (tables (D, F, 2^N); MLP weights
    (D, F, H)...(D, O), SVM weights (D, F, O), (D, O))."""
    d, f, n = tables.shape
    m = x.shape[0]
    h = weights[0].shape[2] if kind == "mlp" else 0
    o = weights[-1].shape[-1]
    name = PERF_ENTRY[entry]

    def workload():
        bits = _bits(n)
        if bits is None or min(m, f, d, o) < 1:
            return None
        return Workload(name, m=m, c=f, bits=bits, d=d, h=h, o=o)

    def fits(bm):
        return envelope.bank_tile_error(
            kind, *_bank_layout(kind, d, m, f, n, h, o), f, n, h, o,
            bm) is None

    return _route(entry, x,
                  lambda: envelope.outside_envelope(kind, f, n, h, o, d),
                  lambda: _tile((name, d, m, f, n, h, o), workload, fits))


def _bank_layout(kind, d, m, f, n, h, o) -> Tuple[bool, int]:
    """(padded, group) of the heuristic bank launch, which a tile keeps."""
    g = envelope.bank_geometry(kind, d, m, f, n, h, o)
    return bool(g.padded), g.group


def resolve_quantize(entry: str, x, tables) -> Resolution:
    """Decide how the population quantizer runs on x (M, C) and tables
    (P, C, 2^N)."""
    p, c, n = tables.shape
    m = x.shape[0]
    name = PERF_ENTRY[entry]

    def workload():
        bits = _bits(n)
        if bits is None or min(m, c, p) < 1:
            return None
        return Workload(name, m=m, c=c, bits=bits,
                        p=p if name == "adc_quantize_population" else 1)

    return _route(entry, x,
                  lambda: envelope.outside_quantize_envelope(c, n, p),
                  lambda: _tile((name, p, m, c, n), workload,
                                lambda bm: envelope.quantize_tile_error(c, bm)
                                is None))


def resolve_mc(entry: str, x, lb) -> Resolution:
    """Decide how a Monte-Carlo entry runs on x (M, C) and interval
    tables lb (..., S, C, 2^N)."""
    m = x.shape[0]
    c, n = lb.shape[-2], lb.shape[-1]
    p, s = (1, lb.shape[0]) if lb.ndim == 3 else tuple(lb.shape[:2])
    name = PERF_ENTRY[entry]

    def workload():
        bits = _bits(n)
        if bits is None or min(m, c, p, s) < 1:
            return None
        return Workload(name, m=m, c=c, bits=bits, p=p, s=s)

    return _route(entry, x, lambda: envelope.outside_mc_envelope(c, n),
                  lambda: _tile((name, p, s, m, c, n), workload,
                                lambda bm: envelope.mc_tile_error(c, bm)
                                is None))


def resolve_flash(entry: str, q: torch.Tensor) -> Resolution:
    """Decide how flash attention runs on q (B, S, H, dh). A CUDA call
    takes one of two kernels (``route``), by ``envelope.flash_route``:
    'tensor_core' (csrc/flash_attention_tc.cu) for bf16 at a head width
    of the repo's attention configs, 'cuda_core' (csrc/flash_attention.cu)
    for float32 and for bf16 at any other width; each is held to its own
    envelope. A CPU tensor takes the plain version (route 'plain').
    Attention has no tile knob (the reference's perf layer does not
    cover it)."""
    b, _, h, dh = q.shape
    route = envelope.flash_route(q.dtype == torch.bfloat16, dh)

    def why():
        if route == "tensor_core":
            return envelope.outside_flash_tc_envelope(b, h, dh)
        return envelope.outside_flash_envelope(b, h, dh)

    res = _route(entry, q, why)
    return dataclasses.replace(
        res, route=route if res.path == "kernel" else "plain")


def resolve_flash_bwd(entry: str, q: torch.Tensor) -> Resolution:
    """Decide how the flash-attention backward runs on q (B, S, H, dh).
    A CUDA call takes one of two kernels (``route``), by
    ``envelope.flash_bwd_route``: 'tensor_core'
    (csrc/flash_attention_bwd_tc.cu) for bf16 at head widths 64, 96, 112
    and 128, 'cuda_core' (csrc/flash_attention_bwd.cu) for float32 and for
    bf16 at any other width; each is held to its own envelope. A CPU
    tensor takes the plain autograd (route 'plain')."""
    b, s, h, dh = q.shape
    route = envelope.flash_bwd_route(q.dtype == torch.bfloat16, dh)

    def why():
        if route == "tensor_core":
            return envelope.outside_flash_bwd_tc_envelope(b, h, dh)
        return envelope.outside_flash_bwd_envelope(b, s, h, dh)

    res = _route(entry, q, why)
    return dataclasses.replace(
        res, route=route if res.path == "kernel" else "plain")


# --------------------------------------------------------------- registry
@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One registered hot path, stated once: the perf layer's ``name``,
    the wrapper's launch-counter key, and the kernel and plain callables
    ``fn(x, tables, *weights, spec=...)`` (``kernel`` also takes
    ``block_m``; on a CPU tensor it runs the plain version, as every
    wrapper does)."""
    name: str
    counter: str
    kernel: Callable
    plain: Callable


_REGISTRY: Dict[str, KernelEntry] = {}


def register(entry: KernelEntry) -> KernelEntry:
    if entry.name in _REGISTRY:
        raise ValueError(f"kernel entry {entry.name!r} already registered")
    _REGISTRY[entry.name] = entry
    return entry


def get(name: str) -> KernelEntry:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"no kernel entry {name!r}; registered: "
                         f"{entries()}") from None


def entries() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# The wrapper modules import this one, so the kernel callables import them
# when called.
def _quantize_kernel(single: bool):
    def kernel(x, t, *, spec, block_m=None):
        from repro_torch.kernels import adc_quantize
        fn = (adc_quantize.adc_quantize if single
              else adc_quantize.adc_quantize_population)
        return fn(x, t, spec=spec, block_m=block_m)
    return kernel


def _bank_kernel(kind: str, single: bool):
    def kernel(x, t, *weights, spec, block_m=None):
        from repro_torch.kernels import qmlp
        fn = getattr(qmlp, f"bespoke_{kind}" + ("" if single else "_bank"))
        return fn(x, t, *weights, spec=spec, block_m=block_m)
    return kernel


def _mc_kernel(counter: str):
    def kernel(x, lb, ub, values, lo, scale, *, spec=None, block_m=None):
        from repro_torch.kernels import mc_eval
        return getattr(mc_eval, counter)(x, lb, ub, values, lo, scale,
                                         block_m=block_m)
    return kernel


def _mc_plain(fn):
    return lambda x, lb, ub, values, lo, scale, *, spec=None: fn(
        x, lb, ub, values, lo, scale)


register(KernelEntry(
    "adc_quantize", "adc_quantize", _quantize_kernel(True),
    lambda x, t, *, spec: ref.adc_quantize_ref(x, t, spec.bits, spec.vmin,
                                               spec.vmax)))
register(KernelEntry(
    "adc_quantize_population", "adc_quantize_population",
    _quantize_kernel(False),
    lambda x, t, *, spec: ref.adc_quantize_ref_population(
        x, t, spec.bits, spec.vmin, spec.vmax)))
register(KernelEntry(
    "bespoke_mlp", "bespoke_mlp", _bank_kernel("mlp", True),
    lambda x, t, w1, b1, w2, b2, *, spec: ref.bespoke_mlp_ref(
        x, t, spec.bits, w1, b1, w2, b2, spec.vmin, spec.vmax)))
register(KernelEntry(
    "bespoke_svm", "bespoke_svm", _bank_kernel("svm", True),
    lambda x, t, w, b, *, spec: ref.bespoke_svm_ref(
        x, t, spec.bits, w, b, spec.vmin, spec.vmax)))
register(KernelEntry(
    "classifier_bank_mlp", "qmlp_mlp_bank", _bank_kernel("mlp", False),
    lambda x, t, w1, b1, w2, b2, *, spec: ref.bespoke_mlp_bank_ref(
        x, t, spec.bits, w1, b1, w2, b2, spec.vmin, spec.vmax)))
register(KernelEntry(
    "classifier_bank_svm", "qmlp_svm_bank", _bank_kernel("svm", False),
    lambda x, t, w, b, *, spec: ref.bespoke_svm_bank_ref(
        x, t, spec.bits, w, b, spec.vmin, spec.vmax)))
# Monte-Carlo entries: tables is the lb interval table; ub, values, lo and
# scale ride as the remaining operands (core/nonideal.mc_operands builds
# them in this order); the spec takes no part (the code math is baked in)
for _name, _counter, _plain in (
        ("mc_eval", "mc_adc_eval", ref.mc_adc_eval_ref),
        ("mc_eval_population", "mc_adc_eval_population",
         ref.mc_adc_eval_ref_population),
        ("mc_eval_cal", "mc_adc_eval_cal", ref.mc_adc_eval_cal_ref),
        ("mc_eval_cal_population", "mc_adc_eval_cal_population",
         ref.mc_adc_eval_cal_ref_population)):
    register(KernelEntry(_name, _counter, _mc_kernel(_counter),
                         _mc_plain(_plain)))
del _name, _counter, _plain

# the wrappers' launch-counter names -> the perf layer's entry names
PERF_ENTRY = {e.counter: e.name for e in _REGISTRY.values()}
