#!/usr/bin/env python3
"""A/B of the tensor-core attention backward on one card.

  python3 tools/flash_bwd_ab.py [--dh 256] [--variant NAME=OTHER.cu ...]

Builds the repo's ``src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu``
and each ``--variant`` (another copy of that source: a parent commit's,
unpacked with ``git archive``, or the repo's with one change made by
``sed``, in a directory that .gitignore lists) with the repo's nvcc
flags, one nvcc each, in parallel, into ``build/flash_bwd_ab/``, and
prints each build's ptxas registers and spills per kernel. Each library
is put behind ``kernels.flash_attention``'s tensor-core backward in turn
(the wrapper unchanged) and:

- held against the plain autograd (``ref.flash_attention_bwd_ref`` in
  float32 at the same inputs) at musicgen-medium's layer (B 4, S 2048,
  H = KV 24, dh 64, causal) and a GQA call at dh 128 with a window and a
  softcap (B 1, S 777, H 40, KV 8, window 512, softcap 50), or with
  ``--dh 256`` at gemma2-2b's layer (B 1, S 8192, H 8, KV 4, dh 256,
  softcap 50; global, then window 4096), on
  q, k ~ N(0, 1.5^2), v ~ N(1, 1), dout ~ N(0, 1): each gradient's share
  of chip_smoke.py's bf16 gate ``BWD_TOL`` (above 1 breaks it; reported,
  not enforced, so a variant that breaks it is measured too) and whether
  it is bitwise the repo's build;
- timed at both calls in turns (the repo's, the variants, the variants
  again in reverse, the repo's): CUDA events over 20 calls, and each
  pass's device time per launch (torch.profiler, as chip_smoke.py reads
  it);
- beside them, the repo's CUDA-core backward (csrc/flash_attention_bwd.cu)
  on the same bf16 inputs: shares, two timings of 3 calls, its passes;
  and chip_smoke.py's ``bwd_bound`` of the call (the gradient's five
  products at the bf16 tensor-core peak) and the tensor-core design's
  own products at that peak.

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
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

# (label, B, S, H, KV, dh, window, softcap)
CASES = [("musicgen layer", 4, 2048, 24, 24, 64, 0, 0.0),
         ("GQA dh 128 window softcap", 1, 777, 40, 8, 128, 512, 50.0)]
# --dh 256: gemma2-2b's layer (chip_smoke.GEMMA_ATTN), global and windowed
CASES_256 = [("gemma2 layer global", 1, 8192, 8, 4, 256, 0, 50.0),
             ("gemma2 layer window 4096", 1, 8192, 8, 4, 256, 4096, 50.0)]
REPS = 20


def build_all(sources):
    """{tag: (library path, nvcc log)} of each source, built in parallel."""
    from repro_torch.kernels import _build
    procs = {}
    for tag, src in sources.items():
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(_build.NVCC_FLAGS).encode())
        lib = (REPO / "build" / "flash_bwd_ab"
               / f"lib{tag}-{digest.hexdigest()[:16]}.so")
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


def load(path: Path) -> ctypes.CDLL:
    """The library with the flash_attention_bwd_tc C interface's
    argtypes."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd_tc.argtypes = ([ptr] * 11 + [i32] * 6
                                           + [f32, i32, i32, f32, ptr])
    lib.flash_attention_bwd_tc.restype = i32
    lib.flash_attention_bwd_tc_error_string.argtypes = [i32]
    lib.flash_attention_bwd_tc_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another flash_attention_bwd_tc.cu to hold "
                         "against the repo's (repeatable)")
    ap.add_argument("--dh", type=int, choices=(128, 256), default=128,
                    help="256: gemma2-2b's layer instead of the dh 64 and "
                         "dh 128 calls")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_ab: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3
    from chip_smoke import (BWD_DEVICE_NAMES, BWD_PASSES, bwd_bound,
                            bwd_share, card_line, device_ms_by_name,
                            flash_inputs, ptxas_report, timed_ms)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    card = card_line()
    print(f"nvidia-smi: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device 0: "
          f"{torch.cuda.get_device_name(0)}")
    dev = resolve_device("cuda")
    sources = {"repo": REPO / "src/repro_torch/kernels/csrc/"
                              "flash_attention_bwd_tc.cu"}
    for item in args.variant:
        name, _, path = item.partition("=")
        if not name or not path or name in sources:
            raise SystemExit(f"--variant wants a new NAME=PATH, got {item!r}")
        sources[name] = Path(path)
    built = build_all(sources)
    out = {"card": card, "ptxas": {}, "cases": {}}
    libs = {}
    for tag, (path, log) in built.items():
        kernels, warnings = ptxas_report(log)
        out["ptxas"][tag] = kernels
        for name, regs, st, ld in kernels:
            short = name.split("_cu_")[-1]
            print(f"  ptxas {tag}: {short[:40]}: {regs} registers, spill "
                  f"stores {st} B, loads {ld} B")
        for line in warnings:
            print(f"  ptxas {tag}: {line[:160]}")
        libs[tag] = load(path)

    gen = torch.Generator(device=dev)
    gen.manual_seed(2027)
    names = BWD_DEVICE_NAMES["flash_attention_bwd_tc"]
    for label, b, s, h, kv, dh, win, cap in (CASES_256 if args.dh == 256
                                             else CASES):
        q, k, v = flash_inputs(torch, gen, dev, b, s, s, h, kv, dh,
                               torch.bfloat16)
        do = torch.randn((b, s, h, dh), generator=gen,
                         device=dev).to(torch.bfloat16)
        pos = torch.arange(s, dtype=torch.int32, device=dev)
        kw = dict(causal=True, window=win, attn_softcap=cap)
        want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                           do.float(), pos, pos, **kw)
        b_ms, b_by, _, _, _, floors = bwd_bound(
            torch, q, k, pos, pos, window=win, route="flash_attention_bwd_tc")

        def call():
            return fa._launch_bwd("tensor_core", q, k, v, do, pos, pos, **kw)

        def call_cuda_core():
            return fa._launch_bwd("cuda_core", q, k, v, do, pos, pos, **kw)

        case = {tag: {} for tag in libs}
        cc = case["cuda_core"] = {}
        got = call_cuda_core()
        torch.cuda.synchronize()
        cc["shares"] = [bwd_share(torch, g, w.to(g.dtype), "bfloat16")
                        for g, w in zip(got, want)]
        first = None
        for tag, lib in libs.items():
            fa._lib_bwd_tc = lambda lib=lib: lib          # noqa: E731
            got = call()
            torch.cuda.synchronize()
            first = first or got
            case[tag]["shares"] = [bwd_share(torch, g, w.to(g.dtype),
                                             "bfloat16")
                                   for g, w in zip(got, want)]
            case[tag]["bitwise_repo"] = all(
                torch.equal(g, f) for g, f in zip(got, first))
        cc["bitwise_repo"] = False
        del want, first, got
        order = list(libs) + list(libs)[::-1]
        for tag in order:
            fa._lib_bwd_tc = lambda lib=libs[tag]: lib    # noqa: E731
            case[tag].setdefault("ms", []).append(timed_ms(torch, call, REPS))
        for tag, lib in libs.items():
            fa._lib_bwd_tc = lambda lib=lib: lib          # noqa: E731
            by_name = device_ms_by_name(torch, call, names)
            case[tag]["pass_device_ms"] = {
                p: by_name[n] for p, n in zip(BWD_PASSES, names)}
        cc["ms"] = [timed_ms(torch, call_cuda_core, 3) for _ in range(2)]
        cc_names = BWD_DEVICE_NAMES["flash_attention_bwd"]
        by_name = device_ms_by_name(torch, call_cuda_core, cc_names)
        cc["pass_device_ms"] = {p: by_name[n]
                                for p, n in zip(BWD_PASSES, cc_names)}
        for tag, row in case.items():
            passes = ", ".join(
                f"{p} {'not measured' if t is None else f'{t:.4f}'}"
                for p, t in row["pass_device_ms"].items())
            print(f"{label} [{tag}]: shares of the gate "
                  f"{', '.join(f'{x:.3f}' for x in row['shares'])} (dq, dk, "
                  f"dv); bitwise the repo's {row['bitwise_repo']}; "
                  f"{' / '.join(f'{t:.4f}' for t in row['ms'])} ms a call; "
                  f"device ms a pass: {passes} on {card}")
        print(f"{label}: bound {b_ms:.4f} ms ({b_by}), the tensor-core "
              f"design's products at the bf16 peak {floors['design']:.4f} "
              f"ms on {card}")
        case["bound"] = {"ms": b_ms, "by": b_by, "floors_ms": floors}
        out["cases"][label] = case
        del q, k, v, do
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
