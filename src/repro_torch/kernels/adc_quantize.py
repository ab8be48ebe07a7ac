"""Wrapper of the population ADC quantizer kernel (csrc/adc_quantize.cu).
Counterpart of ``repro/kernels/adc_quantize.py``.

* ``adc_quantize_population``: one shared sample batch x (M, C) through P
  baked value tables (P, C, 2^N) -> (P, M, C), in one launch.
* ``adc_quantize``: one table (C, 2^N), the P=1 call, (M, C) -> (M, C).

A CPU tensor runs the plain version (kernels/ref.py). A CUDA tensor
launches the kernel or raises: the wrapper checks device, dtype, shape and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream, raises if the launch reports an error, and adds one to
the count of the entry called (``launches["adc_quantize_population"]``
or, for the P=1 call, ``launches["adc_quantize"]``). There is no
fallback. A meta tensor (the dry run) returns an empty (P, M, C) output
and launches nothing; every call is one ``dispatch.kernel_unit``.

The range rows a call needs are built once per (bits, vmin, vmax, C,
device) and kept (``range_rows``): building them copies two host arrays
to the card, and each copy waits for the stream.

The tile (``block_m`` sample rows: a span of block_m * C elements,
envelope.quantize_geometry) is the caller's where given, else the tuned
table's for the call's shape class (kernels/dispatch.py), else the
kernel's heuristic. A tile the kernel cannot take raises ValueError
naming the limit, on any device. No tile changes a bit of the output.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.adc import range_rows_tensors
from repro_torch.core.spec import AdcSpec
from repro_torch.kernels import _build, dispatch, envelope, ref

ENTRY = "adc_quantize_population"

# kernel launches since the last reset_launches(), per entry; only the
# launch site below adds to them
launches = {ENTRY: 0, "adc_quantize": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("adc_quantize")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    i64 = ctypes.c_longlong
    lib.adc_quantize_population.argtypes = [ptr] * 5 + [i64] + [i32] * 3 \
        + [i64, ptr]
    lib.adc_quantize_population.restype = i32
    lib.adcq_error_string.argtypes = [i32]
    lib.adcq_error_string.restype = ctypes.c_char_p
    lib.adc_quantize_geometry.argtypes = [i64] + [i32] * 3 + [i64, ptr]
    lib.adc_quantize_geometry.restype = i32
    return lib


def geometry(p: int, m: int, c: int, n: int,
             block_m: Optional[int] = None) -> Tuple[int, ...]:
    """The launch geometry the built kernel takes for a call at tile
    ``block_m`` (None: the heuristic), in the order of
    ``envelope.QuantizeGeometry``. A tile the kernel refuses raises
    ValueError with the kernel's reason."""
    got = (ctypes.c_longlong * 8)()
    err = _lib().adc_quantize_geometry(m, c, n, p, block_m or 0, got)
    if err != 0:
        raise ValueError(_lib().adcq_error_string(err).decode())
    return tuple(got)


@functools.lru_cache(maxsize=64)
def _range_rows(bits: int, vmin, vmax, c: int, device: torch.device):
    return range_rows_tensors(bits, vmin, vmax, c, device)


def range_rows(spec: AdcSpec, c: int, device) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """The (C,) ``(vmin, scale)`` range rows of ``spec`` on ``device``,
    equal to ``core.adc.range_rows_tensors``'s, built once per (bits,
    vmin, vmax, C, device) and shared by every later call: callers must
    not write to them."""
    return _range_rows(spec.bits, spec.vmin, spec.vmax, c,
                       torch.device(device))


def _check(spec: AdcSpec, x: torch.Tensor, tables: torch.Tensor
           ) -> Tuple[int, int, int, int]:
    """(P, M, C, 2^N) of a call, or ValueError."""
    if x.ndim != 2 or tables.ndim != 3:
        raise ValueError(f"need x (M, C) and tables (P, C, 2^N); got "
                         f"{tuple(x.shape)} and {tuple(tables.shape)}")
    m, c = x.shape
    p, tc, n = tables.shape
    if tc != c:
        raise ValueError(f"tables have {tc} channels, x has {c}")
    if n != spec.levels:
        raise ValueError(f"tables have {n} levels, the spec {spec.levels}")
    spec.validate_channels(c)
    return p, m, c, n


def _run(entry: str, x: torch.Tensor, tables: torch.Tensor, spec: AdcSpec,
         rows, block_m: Optional[int]) -> torch.Tensor:
    p, m, c, n = _check(spec, x, tables)
    res = dispatch.resolve_quantize(entry, x, tables)
    if block_m is not None and min(p, m, c) > 0:  # raises on any device
        envelope.quantize_geometry(p, m, c, n, block_m)
    tile = block_m if block_m is not None else res.block_m or 0
    with dispatch.kernel_unit(entry, p=p, m=m, c=c, n=n):
        if res.path == "plain":
            return ref.adc_quantize_ref_population(x, tables, spec.bits,
                                                   spec.vmin, spec.vmax)
        if res.path == "meta":
            return torch.empty((p, m, c), dtype=torch.float32,
                               device=x.device)
        lo, scale = (rows if rows is not None
                     else range_rows(spec, c, x.device))
        for i, t in enumerate((x, tables, lo, scale)):
            if t.device != x.device:
                raise ValueError(f"{entry}: operand {i} is on {t.device}, "
                                 f"x on {x.device}")
            if t.dtype != torch.float32:
                raise TypeError(f"{entry}: operand {i} is {t.dtype}, needs "
                                f"float32")
            if not t.is_contiguous():
                raise ValueError(f"{entry}: operand {i} is not contiguous")
        out = torch.empty((p, m, c), dtype=torch.float32, device=x.device)
        if m == 0 or p == 0:
            return out
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _lib().adc_quantize_population(
                x.data_ptr(), tables.data_ptr(), lo.data_ptr(),
                scale.data_ptr(), out.data_ptr(), m, c, n, p, tile, stream)
        if err != 0:
            msg = _lib().adcq_error_string(err).decode()
            raise RuntimeError(f"{entry} launch failed: error {err} "
                               f"({msg})")
        _build.count_launch(launches, entry)
        return out


def adc_quantize_population(
        x: torch.Tensor, tables: torch.Tensor, *, spec: AdcSpec,
        rows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        block_m: Optional[int] = None) -> torch.Tensor:
    """Shared x (M, C); tables (P, C, 2^N). Returns (P, M, C) float32:
    ``out[p, m, c] = tables[p, c, code(x[m, c])]``. ``rows`` are the (C,)
    ``(vmin, scale)`` range rows on x's device when the caller holds them
    already; by default they are built from ``spec`` (once, see
    ``range_rows``). ``block_m``: the tile (None: tuned, else
    heuristic)."""
    return _run(ENTRY, x, tables, spec, rows, block_m)


def adc_quantize(x: torch.Tensor, table: torch.Tensor, *, spec: AdcSpec,
                 rows=None, block_m: Optional[int] = None) -> torch.Tensor:
    """One bank: x (M, C), table (C, 2^N) -> (M, C). The P=1 call of the
    population kernel."""
    return _run("adc_quantize", x, table[None], spec, rows, block_m)[0]
