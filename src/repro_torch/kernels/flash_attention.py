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
starts off that alignment is copied first. A meta tensor (the dry run,
launch/dryrun.py) takes the kernel path without a launch: the envelope
is checked and an empty output of the kernel's shape is returned. Every
call, on every route, is one ``dispatch.kernel_unit`` (``unit_shapes``),
so launch/analysis.count_step prices it and skips the ops inside; the
plain backward's gradients are made contiguous, as the kernel's are.

``flash_attention_bwd(q, k, v, dout, q_positions, k_positions, *,
causal, window, attn_softcap)`` -> (dq, dk, dv) is the gradient of that
function for the output cotangent dout. A CUDA tensor launches one of two
backward kernels, three launches each (row statistics, dk/dv, dq; float32
accumulation, no atomics, so bitwise run to run), by the route
``dispatch.resolve_flash_bwd`` names: bf16 at head widths 64, 96, 112,
128 and 256 (gemma2's) runs the tensor-core kernel
(csrc/flash_attention_bwd_tc.cu, wgmma and TMA; its operands 16-byte
aligned as the forward's) and adds one to
``launches["flash_attention_bwd_tc"]`` per call; float32 (dh 256 in
32-row tiles), and bf16 at any other width up to 256, run the CUDA-core
kernel (csrc/flash_attention_bwd.cu) and add one to
``launches["flash_attention_bwd"]``. A failed launch raises; there is no
fallback. A CPU tensor runs the plain version
(``ref.flash_attention_bwd_ref``, autograd through the plain forward).
``attention`` is the differentiable entry: the autograd Function
``FlashAttention``, whose forward is
``flash_attention`` and whose backward is ``flash_attention_bwd`` on the
saved q, k, v (the kernel recomputes what it needs of the output). The LM's
prefill and its training step both go through it (models/layers.py).
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
BWD_ENTRY = "flash_attention_bwd"     # the CUDA-core backward's counter
BWD_TC_ENTRY = "flash_attention_bwd_tc"   # the tensor-core backward's
DTYPES = (torch.float32, torch.bfloat16)

# kernel launches since the last reset_launches(), one key per route of
# the forward and of the backward; only the launch sites below add to them
launches = {ENTRY: 0, TC_ENTRY: 0, BWD_ENTRY: 0, BWD_TC_ENTRY: 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def total_launches() -> int:
    """Launches of either forward kernel since the last reset_launches()."""
    return launches[ENTRY] + launches[TC_ENTRY]


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


@functools.lru_cache(maxsize=None)
def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd.argtypes = ([ptr] * 11 + [i32] * 6
                                        + [f32, i32, i32, f32, i32, ptr])
    lib.flash_attention_bwd.restype = i32
    lib.flash_attention_bwd_error_string.argtypes = [i32]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    lib.flash_attention_bwd_smem_bytes.argtypes = [i32, i32]
    lib.flash_attention_bwd_smem_bytes.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _lib_bwd_tc() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd_tc")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd_tc.argtypes = ([ptr] * 11 + [i32] * 6
                                           + [f32, i32, i32, f32, ptr])
    lib.flash_attention_bwd_tc.restype = i32
    lib.flash_attention_bwd_tc_error_string.argtypes = [i32]
    lib.flash_attention_bwd_tc_error_string.restype = ctypes.c_char_p
    lib.flash_attention_bwd_tc_smem_bytes.argtypes = [i32, i32]
    lib.flash_attention_bwd_tc_smem_bytes.restype = i32
    return lib


def bwd_tc_smem_bytes(pass_: int, dh: int) -> int:
    """Dynamic shared memory the built tensor-core backward's pass
    ``pass_`` asks for at head width dh (negative for a width it has no
    instantiation for)."""
    return _lib_bwd_tc().flash_attention_bwd_tc_smem_bytes(pass_, dh)


def bwd_smem_bytes(pass_: int, dh: int) -> int:
    """Dynamic shared memory the built backward kernel's pass ``pass_``
    (0 row statistics, 1 dk/dv, 2 dq) asks for at head width dh."""
    return _lib_bwd().flash_attention_bwd_smem_bytes(pass_, dh)


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


def unit_shapes(q, k, causal, window) -> dict:
    """What a call reports to ``dispatch.kernel_unit``: the shapes, the
    element size and the mask's parameters (positions are not read)."""
    b, s, h, dh = q.shape
    return dict(b=b, s=s, sk=k.shape[1], h=h, kv=k.shape[2], dh=dh,
                itemsize=q.element_size(), causal=bool(causal),
                window=int(window or 0))


def _check_cuda_operands(entry: str, named) -> None:
    """Device, dtype and contiguity of a kernel call's operands, named:
    ``named`` is [(label, tensor)], the float operands first (they must
    share one of DTYPES), then the two int32 position vectors."""
    first = named[0][1]
    for label, t in named[1:]:
        if t.device != first.device:
            raise ValueError(f"{entry}: {label} is on {t.device}, "
                             f"{named[0][0]} on {first.device}")
    floats, pos = named[:-2], named[-2:]
    if first.dtype not in DTYPES or any(t.dtype != first.dtype
                                        for _, t in floats):
        raise TypeError(f"{entry}: {', '.join(n for n, _ in floats)} must "
                        f"share one of {DTYPES}; got "
                        f"{', '.join(str(t.dtype) for _, t in floats)}")
    if any(t.dtype != torch.int32 for _, t in pos):
        raise TypeError(f"{entry}: positions must be int32; got "
                        f"{pos[0][1].dtype}, {pos[1][1].dtype}")
    for label, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{entry}: {label} is not contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, k_positions: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    attn_softcap: float = 0.0) -> torch.Tensor:
    """Attention of q over (k, v); see the module docstring."""
    _check(q, k, v, q_positions, k_positions)
    res = dispatch.resolve_flash(ENTRY, q)
    with dispatch.kernel_unit(ENTRY, **unit_shapes(q, k, causal, window)):
        if res.path == "plain":
            return ref.flash_attention_ref(
                q, k, v, q_positions, k_positions, causal=causal,
                window=window, attn_softcap=attn_softcap)
        if res.path == "meta":
            return torch.empty_like(q)
        return _launch(res.route, q, k, v, q_positions, k_positions,
                       causal=causal, window=window,
                       attn_softcap=attn_softcap)


def _launch(route, q, k, v, q_positions, k_positions, *, causal, window,
            attn_softcap):
    """One forward call on the kernel of ``route``, counted on its key."""
    b, s, h, dh = q.shape
    _, sk, kvh, _ = k.shape
    _check_cuda_operands(ENTRY, [("q", q), ("k", k), ("v", v),
                                 ("q_positions", q_positions),
                                 ("k_positions", k_positions)])
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = 1.0 / math.sqrt(dh)
    flags = (int(bool(causal)), int(window or 0), float(attn_softcap or 0.0))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "tensor_core":
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
    _build.count_launch(launches, key)
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, q_positions: torch.Tensor,
                        k_positions: torch.Tensor, *, causal: bool = True,
                        window: int = 0, attn_softcap: float = 0.0):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v) for the output
    cotangent ``dout`` (B, S, H, dh). See the module docstring."""
    _check(q, k, v, q_positions, k_positions)
    if tuple(dout.shape) != tuple(q.shape):
        raise ValueError(f"{BWD_ENTRY}: dout {tuple(dout.shape)} is not q's "
                         f"shape {tuple(q.shape)}")
    res = dispatch.resolve_flash_bwd(BWD_ENTRY, q)
    with dispatch.kernel_unit(BWD_ENTRY, **unit_shapes(q, k, causal,
                                                       window)):
        if res.path == "plain":
            # contiguous, as the kernels' outputs are, so the ops after
            # the call are the same on every route
            return tuple(t.contiguous() for t in ref.flash_attention_bwd_ref(
                q, k, v, dout, q_positions, k_positions, causal=causal,
                window=window, attn_softcap=attn_softcap))
        if res.path == "meta":
            return tuple(torch.empty_like(t) for t in (q, k, v))
        _check_cuda_operands(BWD_ENTRY, [
            ("q", q), ("k", k), ("v", v), ("dout", dout),
            ("q_positions", q_positions), ("k_positions", k_positions)])
        return _launch_bwd(res.route, q, k, v, dout, q_positions,
                           k_positions, causal=causal, window=window,
                           attn_softcap=attn_softcap)


def _launch_bwd(route, q, k, v, dout, q_positions, k_positions, *, causal,
                window, attn_softcap):
    """One backward call on CUDA operands that passed the checks, on the
    kernel of ``route`` ('tensor_core' or 'cuda_core'), counted on its
    key. ``flash_attention_bwd`` passes the route dispatch names."""
    b, s, h, dh = q.shape
    _, sk, kvh, _ = k.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        # no query or no key: nothing attends, every gradient is 0
        return dq.zero_(), dk.zero_(), dv.zero_()
    stats = torch.empty((2, b, h, s), dtype=torch.float32, device=q.device)
    args = (b, s, sk, h, kvh, dh, 1.0 / math.sqrt(dh), int(bool(causal)),
            int(window or 0), float(attn_softcap or 0.0))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "tensor_core":
            q, k, v, dout = (_aligned(t) for t in (q, k, v, dout))
            lib, key = _lib_bwd_tc(), BWD_TC_ENTRY
            fn, name = (lib.flash_attention_bwd_tc,
                        lib.flash_attention_bwd_tc_error_string)
            extra = ()
        else:
            lib, key = _lib_bwd(), BWD_ENTRY
            fn, name = (lib.flash_attention_bwd,
                        lib.flash_attention_bwd_error_string)
            extra = (int(q.dtype == torch.bfloat16),)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 q_positions.data_ptr(), k_positions.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 stats[0].data_ptr(), stats[1].data_ptr(), *args, *extra,
                 stream)
    if err != 0:
        raise RuntimeError(f"{key} launch failed: error {err} "
                           f"({name(err).decode()})")
    _build.count_launch(launches, key)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with the hand-written backward: forward
    ``flash_attention``, backward ``flash_attention_bwd`` on the saved q,
    k and v. On CPU tensors both are the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, k_positions, causal, window,
                attn_softcap):
        out = flash_attention(q, k, v, q_positions, k_positions,
                              causal=causal, window=window,
                              attn_softcap=attn_softcap)
        ctx.save_for_backward(q, k, v, q_positions, k_positions)
        ctx.flags = dict(causal=causal, window=window,
                         attn_softcap=attn_softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qpos, kpos = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, dout.contiguous(), qpos,
                                         kpos, **ctx.flags)
        return dq, dk, dv, None, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_positions: torch.Tensor, k_positions: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              attn_softcap: float = 0.0) -> torch.Tensor:
    """``flash_attention``, differentiable through ``FlashAttention``."""
    return FlashAttention.apply(q, k, v, q_positions, k_positions,
                                bool(causal), int(window or 0),
                                float(attn_softcap or 0.0))
