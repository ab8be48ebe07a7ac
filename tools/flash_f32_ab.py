#!/usr/bin/env python3
"""A/B of the CUDA-core flash-attention kernel in float32 on one card.

  python3 tools/flash_f32_ab.py [--baseline OTHER.cu] [--prefill]

Builds the repo's ``src/repro_torch/kernels/csrc/flash_attention.cu``
and, with ``--baseline``, another copy of that source (for example a
parent commit's, unpacked with ``git archive`` into a directory that
.gitignore lists) with the repo's nvcc flags, one nvcc each, in parallel,
into ``build/flash_ab/``, and prints each build's ptxas registers and
spills. Each library is put behind ``kernels.flash_attention`` in turn
(the wrapper, its checks and its launch counter unchanged) and:

- held against the plain version on float32 calls at the configs' widths
  (musicgen-medium's prefill call B 4, S 2048, H = KV 24, dh 64; ragged
  S = Sk = 2049; llama4's H 40, KV 8, dh 128, S 2047; phi3's dh 96,
  S 1030; gemma2's H 8, KV 4, dh 256, window 1024, softcap 50, S 4096),
  rtol = atol = 2e-5, on q, k ~ N(0, 1.5^2), v ~ N(1, 1);
- timed at musicgen's call in turns (baseline, new, new, baseline): CUDA
  events over 20 calls, and torch.profiler's device time per launch;
- with ``--prefill``, the warm float32 prefill of musicgen-medium at its
  full published width (48 layers, random seeded weights, 4 x 2048
  tokens, ``models.serving.prefill``) timed in the same turns, the host
  clock around a synchronised call, the faster of two;
- with ``--profile``, the repo's source built again with
  ``-DFLASH_PROFILE``: one launch at musicgen's call, and the share of
  each phase of the tile loop in the warps' clock64 counts (classifying
  tiles, the wait and barrier, issuing the copies, the score loop, the
  softmax, p^T and P.V) beside the prologue;
- with ``--fma-ceiling``, what float32 FMAs reach on this card in the
  kernel's own arrangement: 256 threads a block, an 8 x 8 tile of
  accumulators a thread, fed from registers, or from shared memory by the
  score loop's LDS.128 pattern (4 loads a 64 FMAs), one and eight blocks
  an SM.

The card's nvidia-smi name and power limit are printed first; the last
line is one JSON object with every number. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

TOL = dict(rtol=2e-5, atol=2e-5)
# (label, B, S, H, KV, dh, window, softcap)
CASES = [("musicgen prefill", 4, 2048, 24, 24, 64, 0, 0.0),
         ("ragged S=Sk=2049", 4, 2049, 24, 24, 64, 0, 0.0),
         ("llama4 widths", 1, 2047, 40, 8, 128, 0, 0.0),
         ("phi3 widths", 1, 1030, 32, 32, 96, 0, 0.0),
         ("gemma2 widths", 1, 4096, 8, 4, 256, 1024, 50.0)]


def lib_path(tag: str, src: Path, flags=()) -> Path:
    """Where the build of ``src`` (the repo's nvcc flags, then ``flags``)
    goes."""
    from repro_torch.kernels import _build
    text = src.read_bytes()
    digest = hashlib.sha256(
        text + " ".join(_build.NVCC_FLAGS + tuple(flags)).encode())
    out = (REPO / "build" / "flash_ab"
           / f"lib{tag}-{digest.hexdigest()[:16]}.so")
    out.parent.mkdir(parents=True, exist_ok=True)
    return out


def build_all(sources):
    from repro_torch.kernels import _build
    procs = {}
    for tag, (src, flags) in sources.items():
        lib = lib_path(tag, src, flags)
        procs[tag] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for tag, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{tag}: nvcc exited {proc.returncode}\n{log}")
        libs[tag] = (lib, log)
    return libs


FMA_CEILING_CU = r"""
#include <cuda_runtime.h>
extern "C" {
__global__ void __launch_bounds__(256, 1)
from_registers(float* out, int iters, float a) {
  float q[8], k[8], s[8][8];
  for (int i = 0; i < 8; ++i) {
    q[i] = threadIdx.x * 1e-3f + i;
    k[i] = 0.5f * i;
    for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = fmaf(q[i], k[j], s[i][j]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      q[i] = fmaf(q[i], a, 1.0f);
      k[i] = fmaf(k[i], a, 0.5f);
    }
  }
  float t = 0.0f;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) t += s[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}
__global__ void __launch_bounds__(256, 1)
from_shared(float* out, int iters, float) {
  extern __shared__ float sm[];
  for (int e = threadIdx.x; e < 64 * 260 + 64 * 68; e += 256)
    sm[e] = e * 1e-4f;
  __syncthreads();
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const float* qr = sm + 8 * ty;
  const float* kr = sm + 64 * 260 + 4 * tx;
  float s[8][8];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
  for (int it = 0; it < iters; ++it) {
    for (int d0 = 0; d0 < 64; d0 += 8) {
#pragma unroll
      for (int d = d0; d < d0 + 8; ++d) {
        const float4 qa = *reinterpret_cast<const float4*>(qr + d * 260);
        const float4 qb = *reinterpret_cast<const float4*>(qr + d * 260 + 4);
        const float4 ka = *reinterpret_cast<const float4*>(kr + d * 68);
        const float4 kc = *reinterpret_cast<const float4*>(kr + d * 68 + 32);
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
  }
  float t = 0.0f;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) t += s[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}
int fma_run(int shared, float* out, int blocks, int iters) {
  const int smem = 150000;  // one block an SM
  void* k = shared ? (void*)from_shared : (void*)from_registers;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (shared) from_shared<<<blocks, 256, smem>>>(out, iters, 0.999f);
  else from_registers<<<blocks, 256, smem>>>(out, iters, 0.999f);
  return (int)cudaGetLastError();
}
}
"""
# FMAs a thread does per iteration of each microbenchmark
FMA_PER_ITER = {0: 64 + 16, 1: 64 * 64}


def load(path: Path) -> ctypes.CDLL:
    """The library with the flash_attention C interface's argtypes."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention.argtypes = ([ptr] * 6 + [i32] * 6
                                    + [f32, i32, i32, f32, i32, ptr])
    lib.flash_attention.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path,
                    help="another flash_attention.cu to hold against the "
                         "repo's")
    ap.add_argument("--prefill", action="store_true",
                    help="also time the warm float32 prefill of "
                         "musicgen-medium at full width")
    ap.add_argument("--profile", action="store_true",
                    help="per-phase clock64 counts of the repo's kernel "
                         "(a -DFLASH_PROFILE build)")
    ap.add_argument("--fma-ceiling", action="store_true",
                    help="float32 FMA rate of the kernel's 8 x 8 tile "
                         "arrangement, from registers and from shared "
                         "memory")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("flash_f32_ab: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3
    from chip_smoke import (card_line, device_kernel_ms, flash_inputs,
                            limit_share, ptxas_report, timed_ms)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    card = card_line()
    print(f"nvidia-smi: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device 0: "
          f"{torch.cuda.get_device_name(0)}")
    dev = resolve_device("cuda")
    source = REPO / "src/repro_torch/kernels/csrc/flash_attention.cu"
    sources = {"new": (source, ())}
    if args.baseline:
        sources["baseline"] = (args.baseline.resolve(), ())
    if args.profile:
        sources["profile"] = (source, ("-DFLASH_PROFILE",))
    if args.fma_ceiling:
        ceiling = REPO / "build" / "flash_ab" / "fma_ceiling.cu"
        ceiling.parent.mkdir(parents=True, exist_ok=True)
        ceiling.write_text(FMA_CEILING_CU)
        sources["fma_ceiling"] = (ceiling, ())
    t0 = time.perf_counter()
    built = build_all(sources)
    print(f"build: {time.perf_counter() - t0:.2f} s")
    libs = {}
    for tag, (path, log) in built.items():
        for name, regs, st, ld in ptxas_report(log)[0]:
            print(f"  ptxas {tag}: {name}: {regs} registers, spill stores "
                  f"{st} B, spill loads {ld} B")
        libs[tag] = (ctypes.CDLL(str(path)) if tag == "fma_ceiling"
                     else load(path))
    result = {"card": card, "checks": {}, "call_ms": {}, "device_ms": {},
              "prefill_s": {}}
    ceiling = libs.pop("fma_ceiling", None)
    if ceiling is not None:
        out = torch.empty(132 * 8 * 256, device=dev)
        for shared, iters in ((0, 20000), (1, 300)):
            for blocks in (132, 132 * 8):
                ceiling.fma_run(shared, ctypes.c_void_p(out.data_ptr()),
                                blocks, iters)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                err = ceiling.fma_run(shared, ctypes.c_void_p(out.data_ptr()),
                                      blocks, iters)
                end.record()
                torch.cuda.synchronize()
                ok_launch = err == 0
                ms = start.elapsed_time(end)
                tflops = (2 * FMA_PER_ITER[shared] * iters * 256 * blocks
                          / ms / 1e9)
                label = "shared" if shared else "registers"
                result.setdefault("fma_tflop_per_s", {})[
                    f"{label} blocks={blocks}"] = tflops
                print(f"  fma ceiling, 8 x 8 tile from {label}, {blocks} "
                      f"blocks: {tflops:.1f} TFLOP/s "
                      f"({'ok' if ok_launch else f'launch error {err}'}) "
                      f"on {card}")
    profiler = libs.pop("profile", None)

    def use(tag):
        fa._lib = lambda: libs[tag]                      # noqa: E731

    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    ok_all = True
    made = {}
    for label, b, s, h, kv, dh, win, cap in CASES:
        q, k, v = flash_inputs(torch, gen, dev, b, s, s, h, kv, dh,
                               torch.float32)
        pos = torch.arange(s, dtype=torch.int32, device=dev)
        kw = dict(causal=True, window=win, attn_softcap=cap)
        want = ref.flash_attention_ref(q, k, v, pos, pos, **kw)
        for tag in libs:
            use(tag)
            got = fa.flash_attention(q, k, v, pos, pos, **kw)
            torch.cuda.synchronize()
            share = limit_share(got, want, TOL)
            err = float((got - want).abs().max())
            ok = share <= 1.0
            ok_all &= ok
            result["checks"][f"{tag} {label}"] = {"max_abs_err": err,
                                                  "limit_share": share}
            print(f"  {tag:8s} {label:18s} dh={dh:3d} max_abs_err {err:.3e} "
                  f"({share:.3f} of the limit) {'ok' if ok else 'MISMATCH'}")
        made[label] = (q, k, v, pos, kw)
        del want

    q, k, v, pos, kw = made["musicgen prefill"]
    if profiler is not None:
        counts = (ctypes.c_ulonglong * 8)()
        profiler.flash_attention_profile.argtypes = [ctypes.c_void_p,
                                                     ctypes.c_int]
        libs["profile"] = profiler
        use("profile")
        fa.flash_attention(q, k, v, pos, pos, **kw)
        torch.cuda.synchronize()
        profiler.flash_attention_profile(counts, 1)
        fa.flash_attention(q, k, v, pos, pos, **kw)
        torch.cuda.synchronize()
        profiler.flash_attention_profile(counts, 0)
        del libs["profile"]
        names = ("classifying tiles", "copies' wait and barrier",
                 "issuing copies", "score loop", "softmax", "p^T and P.V")
        loop = sum(counts[i] for i in range(6))
        warps = counts[7]
        shares = {n: counts[i] / loop for i, n in enumerate(names)}
        result["profile"] = {"shares": shares, "warps": warps,
                             "loop_cycles_per_warp": loop / warps,
                             "prologue_cycles_per_warp": counts[6] / warps}
        print(f"  profile (musicgen call, {warps} warps): tile loop "
              f"{loop / warps:.0f} clocks a warp, prologue "
              f"{counts[6] / warps:.0f}; " + ", ".join(
                  f"{n} {100 * v:.1f} %" for n, v in shares.items()))
    order = (["baseline", "new", "new", "baseline"] if "baseline" in libs
             else ["new", "new"])
    for i, tag in enumerate(order):
        use(tag)
        fn = lambda: fa.flash_attention(q, k, v, pos, pos, **kw)  # noqa
        ms = timed_ms(torch, fn, 20)
        dev_ms = device_kernel_ms(torch, fn, "flash_attention_kernel",
                                  reps=10)
        result["call_ms"].setdefault(tag, []).append(ms)
        result["device_ms"].setdefault(tag, []).append(dev_ms)
        print(f"  turn {i}: {tag:8s} musicgen f32 call {ms:.4f} ms "
              f"(device {dev_ms if dev_ms is None else round(dev_ms, 4)} ms)"
              f" on {card}")
    made.clear()
    del q, k, v

    if args.prefill:
        from repro_torch.configs import get_config
        from repro_torch.launch import serve
        from repro_torch.models import serving, transformer
        cfg = get_config("musicgen-medium").replace(dtype="float32")
        params = transformer.init_params(cfg, seed=0, device=dev)
        batch = serve.make_batch(cfg, 4, 2048, rng=np.random.default_rng(0),
                                 device=dev)
        for i, tag in enumerate(order):
            use(tag)
            fa.reset_launches()
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                serving.prefill(params, batch, cfg)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            launches = fa.launches[fa.ENTRY]
            ok_all &= launches == 3 * cfg.num_layers
            warm = min(walls[1:])
            result["prefill_s"].setdefault(tag, []).append(warm)
            print(f"  turn {i}: {tag:8s} float32 prefill 4 x 2048 warm "
                  f"{warm:.4f} s ({walls[1]:.4f}/{walls[2]:.4f}; "
                  f"{launches} CUDA-core launches over 3 prefills) on {card}")
    print(json.dumps(result))
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
