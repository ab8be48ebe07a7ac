"""Wrappers of the Monte-Carlo non-ideal ADC kernel (csrc/mc_eval.cu).
Counterpart of ``repro/kernels/mc_eval.py``: four entries, one kernel.

* ``mc_adc_eval_population``: x (M, C) through S perturbed instances of
  P designs: lb/ub (P, S, C, 2^N), values (C, 2^N) nominal ladder,
  lo/scale (S, C) drifted rows shared across designs -> (P, S, M, C).
* ``mc_adc_eval``: one design, lb/ub (S, C, 2^N) -> (S, M, C), the P=1
  call of the same kernel.
* ``mc_adc_eval_cal_population`` / ``mc_adc_eval_cal``: calibrated
  tables, values per design and instance, (P, S, C, 2^N) / (S, C, 2^N).

Each entry counts its own launches. A CPU tensor runs the plain version
(kernels/ref.py). A CUDA tensor launches the kernel or raises: the
wrapper checks device, dtype, shape and contiguity, allocates the output
with ``torch.empty``, launches on the current stream, raises if the
launch reports an error, and adds one to ``launches[<entry>]``. There is
no fallback. A meta tensor (the dry run) returns an empty output and
launches nothing; every call is one ``dispatch.kernel_unit``.

The tile (``block_m``: the rows of a block's chunk of M,
envelope.mc_geometry) is the caller's where given, else the tuned
table's for the call's shape class (kernels/dispatch.py), else the
kernel's heuristic. A tile the kernel cannot take raises ValueError
naming the limit, on any device. No tile changes a bit of the output.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, dispatch, envelope, ref

ENTRIES = ("mc_adc_eval", "mc_adc_eval_population", "mc_adc_eval_cal",
           "mc_adc_eval_cal_population")
_PLAIN = {"mc_adc_eval": ref.mc_adc_eval_ref,
          "mc_adc_eval_population": ref.mc_adc_eval_ref_population,
          "mc_adc_eval_cal": ref.mc_adc_eval_cal_ref,
          "mc_adc_eval_cal_population": ref.mc_adc_eval_cal_ref_population}

# kernel launches since the last reset_launches(), per entry; only the
# launch site below adds to them
launches = {e: 0 for e in ENTRIES}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mc_eval")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    i64 = ctypes.c_longlong
    lib.mc_eval.argtypes = [ptr] * 7 + [i64] + [i32] * 5 + [i64, ptr]
    lib.mc_eval.restype = i32
    lib.mc_eval_error_string.argtypes = [i32]
    lib.mc_eval_error_string.restype = ctypes.c_char_p
    lib.mc_eval_geometry.argtypes = [i64] + [i32] * 4 + [i64, ptr]
    lib.mc_eval_geometry.restype = i32
    return lib


def geometry(p: int, s: int, m: int, c: int, n: int,
             block_m: Optional[int] = None) -> Tuple[int, ...]:
    """The launch geometry the built kernel takes for a call at tile
    ``block_m`` (None: the heuristic), in the order of
    ``envelope.McGeometry``. A tile the kernel refuses raises ValueError
    with the kernel's reason."""
    got = (ctypes.c_longlong * 8)()
    err = _lib().mc_eval_geometry(m, c, n, p, s, block_m or 0, got)
    if err != 0:
        raise ValueError(_lib().mc_eval_error_string(err).decode())
    return tuple(got)


def _check(entry: str, x, lb, ub, values, lo, scale
           ) -> Tuple[int, int, int, int, int]:
    """(P, S, M, C, 2^N) of a call (P=1 for the single-design entries),
    or ValueError."""
    single = not entry.endswith("_population")
    cal = "_cal" in entry
    lead = 3 if single else 4
    if x.ndim != 2 or lb.ndim != lead:
        want = "(S, C, 2^N)" if single else "(P, S, C, 2^N)"
        raise ValueError(f"{entry}: need x (M, C) and lb {want}; got "
                         f"{tuple(x.shape)} and {tuple(lb.shape)}")
    m, c = x.shape
    p, s = (1, lb.shape[0]) if single else lb.shape[:2]
    n = lb.shape[-1]
    if lb.shape[-2] != c:
        raise ValueError(f"{entry}: lb has {lb.shape[-2]} channels, x has "
                         f"{c}")
    want_vals = tuple(lb.shape) if cal else (c, n)
    for label, t, shape in (("ub", ub, tuple(lb.shape)),
                            ("values", values, want_vals),
                            ("lo", lo, (s, c)), ("scale", scale, (s, c))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{entry}: {label} must be {shape}, got "
                             f"{tuple(t.shape)}")
    return p, s, m, c, n


def _run(entry: str, x: torch.Tensor, lb, ub, values, lo, scale,
         block_m: Optional[int]) -> torch.Tensor:
    p, s, m, c, n = _check(entry, x, lb, ub, values, lo, scale)
    res = dispatch.resolve_mc(entry, x, lb)
    if block_m is not None and c > 0:           # raises on any device
        envelope.mc_geometry(p, s, m, c, n, block_m)
    tile = block_m if block_m is not None else res.block_m or 0
    with dispatch.kernel_unit(entry, p=p, s=s, m=m, c=c, n=n):
        if res.path == "plain":
            return _PLAIN[entry](x, lb, ub, values, lo, scale)
        if res.path == "meta":
            return torch.empty((s, m, c) if lb.ndim == 3 else (p, s, m, c),
                               dtype=torch.float32, device=x.device)
        operands = (x, lb, ub, values, lo, scale)
        for i, t in enumerate(operands):
            if t.device != x.device:
                raise ValueError(f"{entry}: operand {i} is on {t.device}, "
                                 f"x on {x.device}")
            if t.dtype != torch.float32:
                raise TypeError(f"{entry}: operand {i} is {t.dtype}, needs "
                                f"float32")
            if not t.is_contiguous():
                raise ValueError(f"{entry}: operand {i} is not contiguous")
        shape = (s, m, c) if lb.ndim == 3 else (p, s, m, c)
        out = torch.empty(shape, dtype=torch.float32, device=x.device)
        if m == 0 or s == 0 or p == 0 or c == 0:
            return out
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _lib().mc_eval(
                x.data_ptr(), lb.data_ptr(), ub.data_ptr(),
                values.data_ptr(), lo.data_ptr(), scale.data_ptr(),
                out.data_ptr(), m, c, n, p, s, int("_cal" in entry), tile,
                stream)
        if err != 0:
            msg = _lib().mc_eval_error_string(err).decode()
            raise RuntimeError(f"{entry} launch failed: error {err} "
                               f"({msg})")
        _build.count_launch(launches, entry)
        return out


def mc_adc_eval(x, lb, ub, values, lo, scale, *,
                block_m: Optional[int] = None) -> torch.Tensor:
    """One design: x (M, C); lb/ub (S, C, 2^N); values (C, 2^N);
    lo/scale (S, C). Returns (S, M, C)."""
    return _run("mc_adc_eval", x, lb, ub, values, lo, scale, block_m)


def mc_adc_eval_population(x, lb, ub, values, lo, scale, *,
                           block_m: Optional[int] = None) -> torch.Tensor:
    """P designs: lb/ub (P, S, C, 2^N); values (C, 2^N) and lo/scale
    (S, C) shared. Returns (P, S, M, C)."""
    return _run("mc_adc_eval_population", x, lb, ub, values, lo, scale,
                block_m)


def mc_adc_eval_cal(x, lb, ub, values, lo, scale, *,
                    block_m: Optional[int] = None) -> torch.Tensor:
    """One design, calibrated: lb/ub/values (S, C, 2^N). Returns
    (S, M, C)."""
    return _run("mc_adc_eval_cal", x, lb, ub, values, lo, scale, block_m)


def mc_adc_eval_cal_population(x, lb, ub, values, lo, scale, *,
                               block_m: Optional[int] = None) -> torch.Tensor:
    """P designs, calibrated: lb/ub/values (P, S, C, 2^N); lo/scale
    (S, C) shared. Returns (P, S, M, C)."""
    return _run("mc_adc_eval_cal_population", x, lb, ub, values, lo,
                scale, block_m)
