#!/usr/bin/env python3
"""A/B of the Monte-Carlo non-ideal ADC kernel on one card.

  python3 tools/mc_eval_ab.py [--baseline OTHER.cu]

Builds the repo's ``src/repro_torch/kernels/csrc/mc_eval.cu`` and, with
``--baseline``, another copy of that source (for example a parent
commit's, unpacked with ``git archive`` into a directory that .gitignore
lists) with the repo's nvcc flags, one nvcc each, in parallel, into
``build/mc_ab/``, and prints each build's ptxas registers and spills.
Each library is put behind ``kernels.mc_eval`` in turn (the wrapper, its
checks and its launch counters unchanged) and:

- all four entries (``mc_adc_eval{,_cal}{,_population}``) are held
  bitwise against their plain versions: operands compiled by
  ``core.nonideal`` (and ``faulttol.calibrate`` for the calibrated
  tables) under NonIdealSpec(0.5, 0.01, 0.02) with NaN, +-inf and
  on-bound inputs, at cardio's width (C 21) and 2^N 16 and 64; interval
  tables that are no partition (overlapping, empty and NaN intervals,
  mixed-sign values; ``chip_smoke.overlapping_operands``); and every
  timed shape below;
- timed in turns (baseline, new, new, baseline) at five shapes, each
  nominal and calibrated, C 21: the search (P 16, S 32, cardio test split
  M 636, 2^N 16), ``evaluate_robustness`` (D 6, S 32, M 636), the
  single-design call (S 32, M 636), the wide call (P 64, S 32, M 8192,
  1.41 GB out) and the search at 6 bits (2^N 64); CUDA events over 200
  calls (20 for the wide call) after warm-up, and torch.profiler's
  device time per launch, beside the bound (``chip_smoke.kernel_bound``) and
  the time ``Tensor.fill_`` takes to write an output of the same size
  (what this card's stores reach, a yardstick the port never calls);
- with ``--leaf-ceiling``, how many leaf tests a second the card runs
  in the kernel's own arrangement, from registers with no memory
  traffic: 256 threads a block, 16 leaves and 8 rows a thread, the
  kernel's integer-key test (subtract, unsigned compare, predicated add)
  and the two float compares it replaced, one to eight blocks an SM.

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

ENTRIES = ("mc_adc_eval", "mc_adc_eval_population", "mc_adc_eval_cal",
           "mc_adc_eval_cal_population")
# label: (P, S, M or None for the cardio test split, bits); P = 1 runs the
# single-design entries
SHAPES = {"search P=16 S=32 M=636": (16, 32, None, 4),
          "evaluate_robustness D=6 S=32 M=636": (6, 32, None, 4),
          "single S=32 M=636": (1, 32, None, 4),
          "wide P=64 S=32 M=8192": (64, 32, 8192, 4),
          "6-bit search P=16 S=32 M=636": (16, 32, None, 6)}


def build_all(sources):
    """{tag: (library, nvcc log)}, one nvcc each, started together."""
    from repro_torch.kernels import _build
    procs = {}
    for tag, src in sources.items():
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(_build.NVCC_FLAGS).encode())
        lib = REPO / "build" / "mc_ab" / f"lib{tag}-{digest.hexdigest()[:16]}.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        procs[tag] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for tag, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{tag}: nvcc exited {proc.returncode}\n{log}")
        libs[tag] = (lib, log)
    return libs


LEAF_CEILING_CU = r"""
#include <cuda_runtime.h>
// acc[i] += val[k] where row i's key lies in leaf k; the leaf data and the
// row keys are made from the thread index and move every iteration, so
// nothing folds; inline PTX keeps the kernels' instruction pattern
template <bool kKeys>
__global__ void __launch_bounds__(256) leaf_ceiling(float* out, int iters) {
  int key[16];
  unsigned width[16];
  float val[16], lbf[16], ubf[16];
  for (int k = 0; k < 16; ++k) {
    key[k] = k * 37 + threadIdx.x;
    width[k] = 40u + k;
    val[k] = 0.5f * k;
    lbf[k] = k + threadIdx.x * 1e-3f;
    ubf[k] = lbf[k] + 1.5f;
  }
  int ku[8];
  float u[8], acc[8];
  for (int i = 0; i < 8; ++i) {
    ku[i] = threadIdx.x + 11 * i;
    u[i] = (threadIdx.x % 17) + 0.25f * i;
    acc[i] = 0.0f;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (kKeys) {
          asm("{\n\t.reg .pred p;\n\t.reg .u32 d;\n\t"
              "sub.u32 d, %1, %2;\n\tsetp.lt.u32 p, d, %3;\n\t"
              "@p add.rn.f32 %0, %0, %4;\n\t}"
              : "+f"(acc[i]) : "r"(ku[i]), "r"(key[k]), "r"(width[k]), "f"(val[k]));
        } else {
          asm("{\n\t.reg .pred p;\n\tsetp.ge.f32 p, %1, %2;\n\t"
              "setp.lt.and.f32 p, %1, %3, p;\n\t@p add.rn.f32 %0, %0, %4;\n\t}"
              : "+f"(acc[i]) : "f"(u[i]), "f"(lbf[k]), "f"(ubf[k]), "f"(val[k]));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ku[i] += 7;
      u[i] += 0.375f;
    }
  }
  float t = 0.0f;
  for (int i = 0; i < 8; ++i) t += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}
extern "C" int leaf_run(int keys, float* out, int blocks, int iters) {
  if (keys) leaf_ceiling<true><<<blocks, 256>>>(out, iters);
  else leaf_ceiling<false><<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
LEAF_TESTS_PER_ITER = 16 * 8        # leaves x rows a thread, one iteration


def load(path: Path) -> ctypes.CDLL:
    """The library with the mc_eval C interface's argtypes (with the tile
    argument: every build must have the repo's C interface)."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mc_eval.argtypes = [ptr] * 7 + [i64] + [i32] * 5 + [i64, ptr]
    lib.mc_eval.restype = i32
    lib.mc_eval_error_string.argtypes = [i32]
    lib.mc_eval_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path,
                    help="another mc_eval.cu to hold against the repo's")
    ap.add_argument("--leaf-ceiling", action="store_true",
                    help="leaf tests a second from registers, the kernel's "
                         "arrangement, integer keys and float compares")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("mc_eval_ab: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3
    from chip_smoke import (MC_SPECS, card_line, cuda_ms, device_kernel_ms,
                            kernel_bound, mc_operands_on, on_bound_inputs,
                            overlapping_operands, ptxas_report, random_masks)
    from repro_torch.core import nonideal
    from repro_torch.core.spec import AdcSpec
    from repro_torch.data import tabular
    from repro_torch.device import resolve_device
    from repro_torch.kernels import envelope, mc_eval, ref

    card = card_line()
    print(f"nvidia-smi: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device 0: "
          f"{torch.cuda.get_device_name(0)}")
    dev = resolve_device("cuda")
    sources = {"new": REPO / "src/repro_torch/kernels/csrc/mc_eval.cu"}
    if args.baseline:
        sources["baseline"] = args.baseline.resolve()
    if args.leaf_ceiling:
        ceiling = REPO / "build" / "mc_ab" / "leaf_ceiling.cu"
        ceiling.parent.mkdir(parents=True, exist_ok=True)
        ceiling.write_text(LEAF_CEILING_CU)
        sources["leaf_ceiling"] = ceiling
    t0 = time.perf_counter()
    built = build_all(sources)
    print(f"build: {time.perf_counter() - t0:.2f} s")
    libs, result = {}, {"card": card, "ptxas": {}, "checks": {}, "shapes": {}}
    for tag, (path, log) in built.items():
        for name, regs, st, ld in ptxas_report(log)[0]:
            print(f"  ptxas {tag}: {name}: {regs} registers, spill stores "
                  f"{st} B, spill loads {ld} B")
            result["ptxas"].setdefault(tag, []).append([name, regs, st, ld])
        libs[tag] = (ctypes.CDLL(str(path)) if tag == "leaf_ceiling"
                     else load(path))
    ceiling = libs.pop("leaf_ceiling", None)
    if ceiling is not None:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        buf = torch.empty(sms * 8 * 256, device=dev)
        for keys in (1, 0):
            for per_sm in (1, 2, 4, 8):
                blocks, iters = sms * per_sm, 400
                run = lambda: ceiling.leaf_run(  # noqa: E731
                    keys, ctypes.c_void_p(buf.data_ptr()), blocks, iters)
                run()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                err = run()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
                rate = blocks * 256 * iters * LEAF_TESTS_PER_ITER / ms / 1e9   # T/s
                label = "integer keys" if keys else "float compares"
                result.setdefault("leaf_tests_T_per_s", {})[
                    f"{label} blocks/SM={per_sm}"] = rate
                print(f"  leaf ceiling, {label}, {per_sm} blocks an SM: "
                      f"{rate:.2f} T leaf tests/s "
                      f"({'ok' if err == 0 else f'launch error {err}'}) "
                      f"on {card}")

    def use(tag):
        mc_eval._lib = lambda: libs[tag]                 # noqa: E731

    plain = {"mc_adc_eval": ref.mc_adc_eval_ref,
             "mc_adc_eval_population": ref.mc_adc_eval_ref_population,
             "mc_adc_eval_cal": ref.mc_adc_eval_cal_ref,
             "mc_adc_eval_cal_population": ref.mc_adc_eval_cal_ref_population}
    rng = np.random.default_rng(2026)
    x_te = tabular.make_dataset("cardio")["x_test"]
    c = x_te.shape[1]
    all3 = nonideal.NonIdealSpec(*MC_SPECS["all three"], seed=1)
    ok_all = True

    def held(label, entry, xd, operands):
        nonlocal ok_all
        want = plain[entry](xd, *operands)
        for tag in libs:
            use(tag)
            got = getattr(mc_eval, entry)(xd, *operands)
            torch.cuda.synchronize()
            ok = got.shape == want.shape and torch.equal(got, want)
            ok_all &= ok
            result["checks"][f"{tag} {entry} {label}"] = ok
            print(f"  {tag:8s} {entry:27s} {label:40s} "
                  f"{'bitwise ok' if ok else 'MISMATCH'}")
            del got
        del want

    def entry_of(p, cal):
        return ("mc_adc_eval" + ("_cal" if cal else "")
                + ("_population" if p > 1 else ""))

    def operands_of(p, s, bits, cal):
        masks = random_masks(np, torch, rng, p, c, bits).to(dev)
        return mc_operands_on(np, torch, dev, AdcSpec(bits=bits), all3,
                              masks if p > 1 else masks[0], s, cal)

    for bits in (4, 6):
        for p in (1, 5):
            for cal in (False, True):
                operands = operands_of(p, 8, bits, cal)
                host = [t.cpu().numpy() for t in operands]
                xs = on_bound_inputs(np, x_te, host[0], host[3], host[4])
                held(f"compiled 2^N={2 ** bits} P={p} S=8, specials",
                     entry_of(p, cal), torch.as_tensor(xs).to(dev), operands)
    for entry in ENTRIES:
        lead = (5,) if entry.endswith("_population") else ()
        operands = tuple(torch.as_tensor(a).to(dev) for a in
                         overlapping_operands(np, rng, lead, 8, c, 16,
                                              "_cal" in entry))
        held("overlapping 2^N=16 S=8", entry, torch.as_tensor(x_te).to(dev),
             operands)

    order = (["baseline", "new", "new", "baseline"] if "baseline" in libs
             else ["new", "new"])
    for label, (p, s, m, bits) in SHAPES.items():
        x = x_te if m is None else x_te[rng.integers(0, len(x_te), size=m)]
        xd = torch.as_tensor(x).to(dev).contiguous()
        for cal in (False, True):
            entry = entry_of(p, cal)
            operands = operands_of(p, s, bits, cal)
            name = ("cal " if cal else "") + label
            held(label, entry, xd, operands)
            fn = lambda: getattr(mc_eval, entry)(xd, *operands)  # noqa: E731
            reps = 20 if "wide" in label else 200
            n = 2 ** bits
            b_ms, b_by, nbytes, _ = kernel_bound(
                "mc_eval_cal_population" if cal else "mc_eval_population",
                len(x), c, n, p=p, s=s)
            row = {"entry": entry, "P": p, "S": s, "M": len(x), "C": c,
                   "levels": n, "bound_ms": b_ms, "bound_by": b_by,
                   "bytes": nbytes,
                   "geometry": list(envelope.mc_geometry(p, s, len(x), c,
                                                         n)),
                   "call_ms": {}, "device_ms": {}}
            sink = torch.empty((p, s, len(x), c) if p > 1 else (s, len(x), c),
                               device=dev)
            row["fill_ms"] = cuda_ms(torch, lambda: sink.fill_(0.0), reps)
            del sink
            print(f"  {'fill_':8s} {name:40s} "
                  f"{row['fill_ms'] * 1e3:.2f} us to write the output "
                  f"(Tensor.fill_) on {card}")
            for i, tag in enumerate(order):
                use(tag)
                ms = cuda_ms(torch, fn, reps)
                dev_ms = device_kernel_ms(torch, fn, "mc_eval_kernel", reps)
                row["call_ms"].setdefault(tag, []).append(ms)
                row["device_ms"].setdefault(tag, []).append(dev_ms)
                dtxt = ("not measured" if dev_ms is None
                        else f"{dev_ms * 1e3:.2f} us")
                print(f"  turn {i}: {tag:8s} {name:40s} call "
                      f"{ms * 1e3:.2f} us, device {dtxt} (bound "
                      f"{b_ms * 1e3:.3f} us, {b_by}) on {card}")
            result["shapes"][name] = row
            del operands
            torch.cuda.empty_cache()
    result["ok"] = ok_all
    print(json.dumps(result))
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
