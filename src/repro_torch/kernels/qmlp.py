"""Wrappers of the fused ADC + classifier bank kernels
(csrc/qmlp_bank.cu). Counterpart of ``repro/kernels/qmlp.py``.

* ``bespoke_mlp_bank`` / ``bespoke_svm_bank``: D deployed designs against
  one shared sample batch, (M, F) -> (D, M, O) logits, in one launch.
* ``bespoke_mlp`` / ``bespoke_svm``: one design, the D=1 call of the bank
  kernels, (M, F) -> (M, O).

A CPU tensor runs the plain version (kernels/ref.py). A CUDA tensor
launches the kernel or raises: the wrapper checks device, dtype, shape and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream, raises if the launch reports an error, and adds one to
the count of the entry called (``launches["qmlp_mlp_bank"]``, or
``launches["bespoke_mlp"]`` for the D=1 call, and the same for the SVM).
There is no fallback. A meta tensor (the dry run) returns an empty
(D, M, O) output and launches nothing; every call is one
``dispatch.kernel_unit``.

The tile (``block_m``, the rows a block takes; envelope.bank_geometry)
is the caller's where given, else the tuned table's for the call's
shape class (kernels/dispatch.py), else the kernel's heuristic. A tile
the kernel cannot take raises ValueError naming the limit, on any
device. No tile changes a bit of the logits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.spec import AdcSpec
from repro_torch.kernels import _build, dispatch, envelope, ref
from repro_torch.kernels.adc_quantize import range_rows

# kernel launches since the last reset_launches(); only the launch sites
# below add to them
launches = {"qmlp_mlp_bank": 0, "qmlp_svm_bank": 0, "bespoke_mlp": 0,
            "bespoke_svm": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("qmlp_bank")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    i64 = ctypes.c_longlong
    lib.qmlp_mlp_bank.argtypes = [ptr] * 9 + [i64] + [i32] * 5 + [i64, ptr]
    lib.qmlp_mlp_bank.restype = i32
    lib.qmlp_svm_bank.argtypes = [ptr] * 7 + [i64] + [i32] * 4 + [i64, ptr]
    lib.qmlp_svm_bank.restype = i32
    lib.qmlp_error_string.argtypes = [i32]
    lib.qmlp_error_string.restype = ctypes.c_char_p
    lib.qmlp_bank_geometry.argtypes = [i32, i64] + [i32] * 5 + [i64, ptr]
    lib.qmlp_bank_geometry.restype = i32
    return lib


def geometry(kind: str, d: int, m: int, f: int, n: int, h: int,
             o: int, block_m: Optional[int] = None) -> Tuple[int, ...]:
    """The launch geometry the built kernel takes for a bank call at tile
    ``block_m`` (None: the heuristic), in the order of
    ``envelope.BankGeometry`` (``h`` is ignored for an SVM). A tile the
    kernel refuses raises ValueError with the kernel's reason."""
    got = (ctypes.c_longlong * 12)()
    err = _lib().qmlp_bank_geometry(int(kind == "mlp"), m, f, n,
                                    h if kind == "mlp" else 0, o, d,
                                    block_m or 0, got)
    if err != 0:
        raise ValueError(_lib().qmlp_error_string(err).decode())
    return tuple(got)


def _check_shapes(kind: str, spec: AdcSpec, x, tables, weights
                  ) -> Tuple[int, ...]:
    """(D, M, F, 2^N, H, O) of a bank call, or ValueError."""
    if x.ndim != 2 or tables.ndim != 3:
        raise ValueError(f"need x (M, F) and tables (D, F, 2^N); got "
                         f"{tuple(x.shape)} and {tuple(tables.shape)}")
    m, f = x.shape
    d, tf, n = tables.shape
    if tf != f:
        raise ValueError(f"tables have {tf} channels, x has {f}")
    if n != spec.levels:
        raise ValueError(f"tables have {n} levels, the spec {spec.levels}")
    if kind == "mlp":
        w1, b1, w2, b2 = weights
        h, o = w1.shape[-1], w2.shape[-1]
        want = {"w1": (d, f, h), "b1": (d, h), "w2": (d, h, o), "b2": (d, o)}
    else:
        w, b = weights
        h, o = 0, w.shape[-1]
        want = {"w": (d, f, o), "b": (d, o)}
    for (label, shape), t in zip(want.items(), weights):
        if tuple(t.shape) != shape:
            raise ValueError(f"{label} must be {shape}, got {tuple(t.shape)}")
    return d, m, f, n, h, o


def _check_operands(name: str, x: torch.Tensor, operands: Sequence) -> None:
    for i, t in enumerate((x, *operands)):
        if t.device != x.device:
            raise ValueError(f"{name}: operand {i} is on {t.device}, "
                             f"x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: operand {i} is {t.dtype}, "
                            f"needs float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand {i} is not contiguous")


def _launch(entry: str, fn, x: torch.Tensor, operands: Sequence,
            dims: Sequence[int], out: torch.Tensor) -> torch.Tensor:
    """One launch; ``dims`` end with the tile (0: the heuristic)."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), *(t.data_ptr() for t in operands),
                 out.data_ptr(), *dims, stream)
    if err != 0:
        msg = _lib().qmlp_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: error {err} ({msg})")
    _build.count_launch(launches, entry)
    return out


def _rows(spec: AdcSpec, f: int, x: torch.Tensor, rows):
    spec.validate_channels(f)
    return range_rows(spec, f, x.device) if rows is None else rows


def _tile(kind: str, block_m: Optional[int], res, dims) -> int:
    """The tile a launch takes: the caller's ``block_m`` (checked against
    the kernel's limits, on any device), else the resolution's; 0 is the
    heuristic."""
    if block_m is not None:
        d, m, f, n, h, o = dims
        if min(d, m, f, n, o) > 0:           # raises on any device
            envelope.bank_geometry(kind, d, m, f, n, h, o, block_m)
        return block_m
    return res.block_m or 0


def _mlp_bank(entry: str, x: torch.Tensor, tables: torch.Tensor, w1, b1, w2,
              b2, spec: AdcSpec, rows, block_m=None) -> torch.Tensor:
    weights = (w1, b1, w2, b2)
    dims = _check_shapes("mlp", spec, x, tables, weights)
    d, m, f, n, h, o = dims
    res = dispatch.resolve(entry, "mlp", x, tables, weights)
    tile = _tile("mlp", block_m, res, dims)
    with dispatch.kernel_unit(entry, d=d, m=m, f=f, n=n, h=h, o=o):
        if res.path == "plain":
            spec.validate_channels(f)
            return ref.bespoke_mlp_bank_ref(x, tables, spec.bits, w1, b1, w2,
                                            b2, spec.vmin, spec.vmax)
        if res.path == "meta":
            return torch.empty((d, m, o), dtype=torch.float32,
                               device=x.device)
        lo, scale = _rows(spec, f, x, rows)
        operands = (tables, lo, scale, w1, b1, w2, b2)
        _check_operands(entry, x, operands)
        out = torch.empty((d, m, o), dtype=torch.float32, device=x.device)
        if m == 0 or d == 0:
            return out
        return _launch(entry, _lib().qmlp_mlp_bank, x, operands,
                       (m, f, n, h, o, d, tile), out)


def _svm_bank(entry: str, x: torch.Tensor, tables: torch.Tensor, w, b,
              spec: AdcSpec, rows, block_m=None) -> torch.Tensor:
    weights = (w, b)
    dims = _check_shapes("svm", spec, x, tables, weights)
    d, m, f, n, _, o = dims
    res = dispatch.resolve(entry, "svm", x, tables, weights)
    tile = _tile("svm", block_m, res, dims)
    with dispatch.kernel_unit(entry, d=d, m=m, f=f, n=n, h=0, o=o):
        if res.path == "plain":
            spec.validate_channels(f)
            return ref.bespoke_svm_bank_ref(x, tables, spec.bits, w, b,
                                            spec.vmin, spec.vmax)
        if res.path == "meta":
            return torch.empty((d, m, o), dtype=torch.float32,
                               device=x.device)
        lo, scale = _rows(spec, f, x, rows)
        operands = (tables, lo, scale, w, b)
        _check_operands(entry, x, operands)
        out = torch.empty((d, m, o), dtype=torch.float32, device=x.device)
        if m == 0 or d == 0:
            return out
        return _launch(entry, _lib().qmlp_svm_bank, x, operands,
                       (m, f, n, o, d, tile), out)


def bespoke_mlp_bank(x: torch.Tensor, tables: torch.Tensor, w1, b1, w2, b2,
                     *, spec: AdcSpec,
                     rows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     block_m: Optional[int] = None) -> torch.Tensor:
    """Shared x (M, F); tables (D, F, 2^N), w1 (D, F, H), b1 (D, H),
    w2 (D, H, O), b2 (D, O). Returns (D, M, O) float32. ``rows`` are the
    (F,) ``(vmin, scale)`` range rows on x's device when the caller holds
    them already (core/deploy.make_bank_fn); by default they are built
    from ``spec``. ``block_m``: the tile (None: tuned, else heuristic)."""
    return _mlp_bank("qmlp_mlp_bank", x, tables, w1, b1, w2, b2, spec, rows,
                     block_m)


def bespoke_svm_bank(x: torch.Tensor, tables: torch.Tensor, w, b, *,
                     spec: AdcSpec,
                     rows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     block_m: Optional[int] = None) -> torch.Tensor:
    """Shared x (M, F); tables (D, F, 2^N), w (D, F, O), b (D, O).
    Returns (D, M, O) float32."""
    return _svm_bank("qmlp_svm_bank", x, tables, w, b, spec, rows, block_m)


def bespoke_mlp(x, table, w1, b1, w2, b2, *, spec: AdcSpec, rows=None,
                block_m: Optional[int] = None):
    """One design: x (M, F), table (F, 2^N), w1 (F, H), b1 (H), w2 (H, O),
    b2 (O) -> (M, O). The D=1 call of the MLP bank kernel."""
    return _mlp_bank("bespoke_mlp", x, table[None], w1[None], b1[None],
                     w2[None], b2[None], spec, rows, block_m)[0]


def bespoke_svm(x, table, w, b, *, spec: AdcSpec, rows=None,
                block_m: Optional[int] = None):
    """One design: x (M, F), table (F, 2^N), w (F, O), b (O) -> (M, O).
    The D=1 call of the SVM bank kernel."""
    return _svm_bank("bespoke_svm", x, table[None], w[None], b[None], spec,
                     rows, block_m)[0]
