"""Wrapper of the hand-written flash-attention kernels. Counterpart of
``repro/kernels/flash_attention.py::flash_attention_pallas``.

``flash_attention(q, k, v, q_positions, k_positions, *, causal, window,
attn_softcap)``: q (B, S, H, dh), k/v (B, Sk, KV, dh) float32 or bfloat16,
positions (S,) / (Sk,) int32 -> (B, S, H, dh) in q's type. Causal,
sliding-window (``window > 0``) and softcapped GQA attention; a key with a
negative position is masked, a fully masked row is 0. Any S and Sk (the
Pallas kernel's ``S % q_block`` assert is a TPU tiling limit).

A CPU tensor runs the plain version (kernels/ref.py). A CUDA tensor
launches one of two kernels or raises (``dispatch.resolve_flash`` names
the route): bf16 at a head width of the repo's attention configs (64, 96,
112, 128, 256) runs the tensor-core kernel (csrc/flash_attention_tc.cu,
wgmma and TMA) and adds one to ``launches["flash_attention_tc"]``;
float32, and bf16 at any other width, run the CUDA-core kernel
(csrc/flash_attention.cu) and add one to ``launches["flash_attention"]``.
The wrapper checks device, dtype, shape and contiguity, allocates the
output with ``torch.empty``, launches on the current stream and raises if
the launch reports an error. There is no fallback. The tensor-core
kernel's TMA maps need 16-byte aligned bases: an operand whose view
starts off that alignment is copied first.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build, dispatch, ref

ENTRY = "flash_attention"             # the CUDA-core kernel's counter
TC_ENTRY = "flash_attention_tc"       # the tensor-core kernel's counter
DTYPES = (torch.float32, torch.bfloat16)

# kernel launches since the last reset_launches(), one key per route; only
# the launch sites below add to them
launches = {ENTRY: 0, TC_ENTRY: 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def total_launches() -> int:
    """Launches of either kernel since the last reset_launches()."""
    return sum(launches.values())


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention.argtypes = ([ptr] * 6 + [i32] * 6
                                    + [f32, i32, i32, f32, i32, ptr])
    lib.flash_attention.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_smem_bytes.argtypes = [i32]
    lib.flash_attention_smem_bytes.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _lib_tc() -> ctypes.CDLL:
    lib = _build.load("flash_attention_tc")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_tc.argtypes = ([ptr] * 6 + [i32] * 6
                                       + [f32, i32, i32, f32, ptr])
    lib.flash_attention_tc.restype = i32
    lib.flash_attention_tc_error_string.argtypes = [i32]
    lib.flash_attention_tc_error_string.restype = ctypes.c_char_p
    lib.flash_attention_tc_smem_bytes.argtypes = [i32]
    lib.flash_attention_tc_smem_bytes.restype = i32
    return lib


def smem_bytes(dh: int) -> int:
    """Dynamic shared memory the built CUDA-core kernel asks for at head
    width dh (0 outside 1..256)."""
    return _lib().flash_attention_smem_bytes(dh)


def tc_smem_bytes(dh: int) -> int:
    """Dynamic shared memory the built tensor-core kernel asks for at
    head width dh (negative for a width it has no instantiation for)."""
    return _lib_tc().flash_attention_tc_smem_bytes(dh)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a fresh copy when its base is not 16-byte aligned (TMA)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(q, k, v, q_positions, k_positions
           ) -> Tuple[int, int, int, int, int, int]:
    """(B, S, H, dh, Sk, KV) of a call, or ValueError."""
    if q.ndim != 4 or k.ndim != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{ENTRY}: need q (B, S, H, dh) and k, v "
                         f"(B, Sk, KV, dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, dh = q.shape
    _, sk, kvh, kdh = k.shape
    if k.shape[0] != b or kdh != dh:
        raise ValueError(f"{ENTRY}: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch or head width")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{ENTRY}: {h} query heads do not group over "
                         f"{kvh} kv heads")
    if tuple(q_positions.shape) != (s,) or tuple(k_positions.shape) != (sk,):
        raise ValueError(f"{ENTRY}: positions must be ({s},) and ({sk},); "
                         f"got {tuple(q_positions.shape)} and "
                         f"{tuple(k_positions.shape)}")
    return b, s, h, dh, sk, kvh


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, k_positions: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    attn_softcap: float = 0.0) -> torch.Tensor:
    """Attention of q over (k, v); see the module docstring."""
    b, s, h, dh, sk, kvh = _check(q, k, v, q_positions, k_positions)
    res = dispatch.resolve_flash(ENTRY, q)
    if res.path == "plain":
        return ref.flash_attention_ref(q, k, v, q_positions, k_positions,
                                       causal=causal, window=window,
                                       attn_softcap=attn_softcap)
    for label, t in (("k", k), ("v", v), ("q_positions", q_positions),
                     ("k_positions", k_positions)):
        if t.device != q.device:
            raise ValueError(f"{ENTRY}: {label} is on {t.device}, q on "
                             f"{q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{ENTRY}: q, k, v must share one of {DTYPES}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q_positions.dtype != torch.int32 or k_positions.dtype != torch.int32:
        raise TypeError(f"{ENTRY}: positions must be int32; got "
                        f"{q_positions.dtype}, {k_positions.dtype}")
    for label, t in (("q", q), ("k", k), ("v", v),
                     ("q_positions", q_positions),
                     ("k_positions", k_positions)):
        if not t.is_contiguous():
            raise ValueError(f"{ENTRY}: {label} is not contiguous")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = 1.0 / math.sqrt(dh)
    flags = (int(bool(causal)), int(window or 0), float(attn_softcap or 0.0))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if res.route == "tensor_core":
            q, k, v = (_aligned(t) for t in (q, k, v))
            lib, key = _lib_tc(), TC_ENTRY
            err = lib.flash_attention_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                q_positions.data_ptr(), k_positions.data_ptr(),
                out.data_ptr(), b, s, sk, h, kvh, dh, scale, *flags, stream)
            name = lib.flash_attention_tc_error_string
        else:
            lib, key = _lib(), ENTRY
            err = lib.flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                q_positions.data_ptr(), k_positions.data_ptr(),
                out.data_ptr(), b, s, sk, h, kvh, dh, scale, *flags,
                int(q.dtype == torch.bfloat16), stream)
            name = lib.flash_attention_error_string
    if err != 0:
        raise RuntimeError(f"{key} launch failed: error {err} "
                           f"({name(err).decode()})")
    launches[key] += 1
    return out
