#!/usr/bin/env python3
"""A/B of the population quantizer and the classifier bank kernels on one
card.

  python3 tools/adc_bank_ab.py [--baseline DIR] [--variant DIR ...]

Builds the repo's ``src/repro_torch/kernels/csrc/adc_quantize.cu`` and
``qmlp_bank.cu`` and, with ``--baseline``, the copies of both in DIR (a
directory holding the two files, or the root of another checkout, for
example a parent commit unpacked with ``git archive`` into a directory
that .gitignore lists); each ``--variant DIR`` adds one more such pair.
All with the repo's nvcc flags, one nvcc each, in parallel, into
``build/adc_bank_ab/``; each build's ptxas registers and spills are
printed. Each library is put behind ``kernels.adc_quantize`` and
``kernels.qmlp`` in turn (the wrappers, their checks and their launch
counters unchanged) and:

- every case of chip_smoke.py's quantizer and bank phases
  (``chip_smoke.quantizer_cases``, ``chip_smoke.bank_cases``) is held
  against the plain version (``kernels/ref.py``): bitwise for the
  quantizer and for the dyadic bank cases, rtol 1e-5 / atol 1e-6 for the
  float ones; and every other build is held bitwise against the repo's,
  the non-dyadic bank cases included;
- each kernel is timed in turns (baseline, new, new, baseline; variants
  after) at the paths' shapes: the quantizer at the search's (cardio
  train and test splits, P 16), the P = 1 call and the wide call (P 64,
  M 65536); the banks at the serve batch (the fixture fronts, D 6 and 3,
  M 1024), one design (D 1) and the wide call (D 64, M 65536); CUDA
  events over 200 calls (20 for the wide calls) after warm-up, and
  torch.profiler's device time per launch, beside the bound
  (``chip_smoke.kernel_bound``, from the port's cost model) and the time
  ``Tensor.fill_`` takes to write an output of the same size (what this
  card's stores reach; a yardstick the port never calls).

The card's nvidia-smi name and power limit are printed first; the last
line is one JSON object with every number. Needs a CUDA card and nvcc;
imports nothing of the JAX package.
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

NAMES = ("adc_quantize", "qmlp_bank")
CSRC = Path("src/repro_torch/kernels/csrc")


def source_in(root: Path, name: str) -> Path:
    """``name``.cu in root, or in root's src/repro_torch/kernels/csrc."""
    for path in (root / f"{name}.cu", root / CSRC / f"{name}.cu"):
        if path.is_file():
            return path
    raise SystemExit(f"no {name}.cu in {root} or {root / CSRC}")


def build_all(builds):
    """{tag: {name: (library, nvcc log)}}, one nvcc each, started
    together."""
    from repro_torch.kernels import _build
    procs = {}
    for tag, sources in builds.items():
        for name, src in sources.items():
            digest = hashlib.sha256(src.read_bytes()
                                    + " ".join(_build.NVCC_FLAGS).encode())
            lib = (REPO / "build" / "adc_bank_ab"
                   / f"lib{name}-{tag}-{digest.hexdigest()[:16]}.so")
            lib.parent.mkdir(parents=True, exist_ok=True)
            procs[tag, name] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                lib)
    out = {}
    for (tag, name), (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{tag} {name}: nvcc exited {proc.returncode}"
                             f"\n{log}")
        out.setdefault(tag, {})[name] = (lib, log)
    return out


def load(name: str, path: Path) -> ctypes.CDLL:
    """The library with its C interface's argtypes (the launchers, with
    their tile argument, and the error string; every build must have the
    repo's C interface)."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "adc_quantize":
        lib.adc_quantize_population.argtypes = [ptr] * 5 + [i64] + [i32] * 3 \
            + [i64, ptr]
        lib.adc_quantize_population.restype = i32
        lib.adcq_error_string.argtypes = [i32]
        lib.adcq_error_string.restype = ctypes.c_char_p
    else:
        lib.qmlp_mlp_bank.argtypes = [ptr] * 9 + [i64] + [i32] * 5 \
            + [i64, ptr]
        lib.qmlp_mlp_bank.restype = i32
        lib.qmlp_svm_bank.argtypes = [ptr] * 7 + [i64] + [i32] * 4 \
            + [i64, ptr]
        lib.qmlp_svm_bank.restype = i32
        lib.qmlp_error_string.argtypes = [i32]
        lib.qmlp_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path,
                    help="a directory holding another adc_quantize.cu and "
                         "qmlp_bank.cu (or a checkout's root)")
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="one more such directory (repeatable)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("adc_bank_ab: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3
    from chip_smoke import (FRONTS, bank_cases, card_line, cuda_ms,
                            device_kernel_ms, kernel_bound, ptxas_report,
                            quantizer_cases, random_masks)
    from repro_torch.core import deploy
    from repro_torch.core.adc import range_rows_tensors
    from repro_torch.core.spec import AdcSpec
    from repro_torch.data import tabular
    from repro_torch.device import resolve_device
    from repro_torch.kernels import adc_quantize as adcq
    from repro_torch.kernels import qmlp, ref

    card = card_line()
    print(f"nvidia-smi: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device 0: "
          f"{torch.cuda.get_device_name(0)}")
    dev = resolve_device("cuda")
    builds = {"new": {n: REPO / CSRC / f"{n}.cu" for n in NAMES}}
    if args.baseline:
        builds["baseline"] = {n: source_in(args.baseline.resolve(), n)
                              for n in NAMES}
    for i, root in enumerate(args.variant):
        builds[f"variant{i}"] = {n: source_in(root.resolve(), n)
                                 for n in NAMES}
    t0 = time.perf_counter()
    built = build_all(builds)
    print(f"build: {time.perf_counter() - t0:.2f} s")
    result = {"card": card, "sources": {t: {n: str(p) for n, p in s.items()}
                                        for t, s in builds.items()},
              "ptxas": {}, "checks": {}, "shapes": {}}
    libs = {}
    for tag, per_name in built.items():
        for name, (path, log) in per_name.items():
            for kname, regs, st, ld in ptxas_report(log)[0]:
                print(f"  ptxas {tag} {name}: {kname}: {regs} registers, "
                      f"spill stores {st} B, spill loads {ld} B")
                result["ptxas"].setdefault(tag, []).append(
                    [name, kname, regs, st, ld])
            for line in log.splitlines():
                if "stack frame" in line and not line.strip().startswith("0 "):
                    print(f"  ptxas {tag} {name}: {line.strip()}")
            libs.setdefault(tag, {})[name] = load(name, path)
    tags = list(libs)

    def use(tag):
        adcq._lib = lambda: libs[tag]["adc_quantize"]       # noqa: E731
        qmlp._lib = lambda: libs[tag]["qmlp_bank"]          # noqa: E731

    data = tabular.make_dataset("cardio")
    x_test = data["x_test"]
    fronts = {}
    for kind in ("mlp", "svm"):
        designs = deploy.load_front(FRONTS / f"cardio_{kind}")
        tables, weights = deploy.bank_arrays(designs)
        fronts[kind] = (designs, designs[0].spec, tables, weights)
    ok_all = True

    def record(key, ok, text):
        nonlocal ok_all
        ok_all &= bool(ok)
        result["checks"][key] = bool(ok)
        print(f"  {text} {'ok' if ok else 'MISMATCH'}")

    # the quantizer: every case bitwise against the plain version and
    # against the repo's build
    for label, spec, x, masks, single in quantizer_cases(
            np, torch, np.random.default_rng(2025), data):
        xd = torch.as_tensor(x).to(dev).contiguous()
        tables = spec.value_table(masks.to(dev)).contiguous()
        if single:
            want = ref.adc_quantize_ref(xd, tables, spec.bits, spec.vmin,
                                        spec.vmax)
        else:
            want = ref.adc_quantize_ref_population(xd, tables, spec.bits,
                                                   spec.vmin, spec.vmax)
        got = {}
        for tag in tags:
            use(tag)
            got[tag] = (adcq.adc_quantize(xd, tables, spec=spec) if single
                        else adcq.adc_quantize_population(xd, tables,
                                                          spec=spec))
            torch.cuda.synchronize()
            record(f"{tag} quantizer {label} == plain",
                   torch.equal(got[tag], want),
                   f"{tag:9s} quantizer {label:48s} == plain (bitwise)")
        for tag in tags[1:]:
            record(f"{tag} quantizer {label} == new",
                   torch.equal(got[tag], got["new"]),
                   f"{tag:9s} quantizer {label:48s} == new (bitwise)")
        del got, want

    def single_entry(fn):
        return lambda x, t, *w, spec: fn(x, t[0], *(a[0] for a in w),
                                         spec=spec)[None]

    entries = {"qmlp_mlp_bank": (qmlp.bespoke_mlp_bank,
                                 ref.bespoke_mlp_bank_ref),
               "qmlp_svm_bank": (qmlp.bespoke_svm_bank,
                                 ref.bespoke_svm_bank_ref),
               "bespoke_mlp": (single_entry(qmlp.bespoke_mlp),
                               ref.bespoke_mlp_bank_ref),
               "bespoke_svm": (single_entry(qmlp.bespoke_svm),
                               ref.bespoke_svm_bank_ref)}
    for label, name, spec, x, tables, weights, exact in bank_cases(
            np, np.random.default_rng(2024), fronts, x_test):
        kern, plain = entries[name]
        xd = torch.as_tensor(x).to(dev).contiguous()
        td = torch.as_tensor(tables).to(dev).contiguous()
        wd = tuple(torch.as_tensor(w).to(dev).contiguous() for w in weights)
        want = plain(xd, td, spec.bits, *wd, spec.vmin, spec.vmax)
        got = {}
        for tag in tags:
            use(tag)
            got[tag] = kern(xd, td, *wd, spec=spec)
            torch.cuda.synchronize()
            ok = (torch.equal(got[tag], want) if exact else
                  torch.allclose(got[tag], want, rtol=1e-5, atol=1e-6))
            rule = "bitwise" if exact else "rtol=1e-5 atol=1e-6"
            record(f"{tag} {name} {label} == plain", ok,
                   f"{tag:9s} {name:13s} {label:44s} == plain ({rule})")
        for tag in tags[1:]:
            record(f"{tag} {name} {label} == new",
                   torch.equal(got[tag], got["new"]),
                   f"{tag:9s} {name:13s} {label:44s} == new (bitwise)")
        del got, want

    order = ((["baseline", "new", "new", "baseline"] if "baseline" in libs
              else ["new", "new"])
             + [t for t in tags if t.startswith("variant")] * 2)
    rng = np.random.default_rng(7)

    def timed(key, fn, kernel_name, b, sink_shape, reps):
        b_ms, b_by, nbytes, work = b
        row = {"bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "work": work, "call_ms": {}, "device_ms": {}}
        sink = torch.empty(sink_shape, device=dev)
        row["fill_ms"] = cuda_ms(torch, lambda: sink.fill_(0.0), reps)
        del sink
        print(f"  fill_     {key:40s} {row['fill_ms'] * 1e3:.2f} us to "
              f"write the output (Tensor.fill_) on {card}")
        for i, tag in enumerate(order):
            use(tag)
            ms = cuda_ms(torch, fn, reps)
            dev_ms = device_kernel_ms(torch, fn, kernel_name, reps)
            row["call_ms"].setdefault(tag, []).append(ms)
            row["device_ms"].setdefault(tag, []).append(dev_ms)
            dtxt = ("not measured" if dev_ms is None
                    else f"{dev_ms * 1e3:.2f} us")
            print(f"  turn {i}: {tag:9s} {key:40s} call {ms * 1e3:.2f} us, "
                  f"device {dtxt} (bound {b_ms * 1e3:.3f} us, {b_by}) on "
                  f"{card}")
        result["shapes"][key] = row

    c = x_test.shape[1]
    spec = AdcSpec(bits=4)
    lo, scale = (t.to(dev) for t in range_rows_tensors(4, 0.0, 1.0, c))
    for key, x, p in (("row 2: search train P=16 M=1488", data["x_train"], 16),
                      ("search test P=16 M=636", x_test, 16),
                      ("row 1: P=1 M=636", x_test, 1),
                      ("wide quantizer P=64 M=65536",
                       x_test[rng.integers(0, len(x_test), 65536)], 64)):
        xd = torch.as_tensor(x).to(dev).contiguous()
        tables = spec.value_table(random_masks(np, torch, rng, p, c, 4)
                                  .to(dev)).contiguous()
        fn = (lambda: adcq.adc_quantize_population(     # noqa: E731
            xd, tables, spec=spec, rows=(lo, scale)))
        timed(key, fn, "adc_quantize_population_kernel",
              kernel_bound("adc_quantize_population", len(x), c, 16, p=p),
              (p, len(x), c),
              20 if "wide" in key else 200)
        result["shapes"][key]["shape"] = {"P": p, "M": len(x), "C": c,
                                          "levels": 16}
    for kind in ("mlp", "svm"):
        designs, fspec, tables, weights = fronts[kind]
        for key, m, tile in ((f"row {5 if kind == 'mlp' else 6}: {kind} "
                              f"serve batch D={len(designs)} M=1024", 1024,
                              np.arange(len(designs))),
                             (f"row {3 if kind == 'mlp' else 4}: {kind} D=1 "
                              f"M=1024", 1024, np.arange(1)),
                             (f"wide {kind} bank D=64 M=65536", 65536,
                              np.arange(64) % len(designs))):
            xd = torch.as_tensor(
                x_test[rng.integers(0, len(x_test), size=m)]).to(dev)
            td = torch.as_tensor(tables[tile]).to(dev).contiguous()
            wd = tuple(torch.as_tensor(w[tile]).to(dev).contiguous()
                       for w in weights)
            d, f, n = td.shape
            h = wd[0].shape[2] if kind == "mlp" else 0
            o = wd[-1].shape[-1]
            rows = tuple(t.to(dev) for t in range_rows_tensors(
                fspec.bits, fspec.vmin, fspec.vmax, f))
            kern = entries[f"bespoke_{kind}" if d == 1
                           else f"qmlp_{kind}_bank"][0]
            fn = (lambda: kern(xd, td, *wd, spec=fspec)  # noqa: E731
                  if d == 1 else kern(xd, td, *wd, spec=fspec, rows=rows))
            timed(key, fn, f"qmlp_{kind}_bank_kernel",
                  kernel_bound(f"classifier_bank_{kind}", m, f, n, d=d, h=h,
                               o=o), (d, m, o),
                  20 if "wide" in key else 200)
            result["shapes"][key]["shape"] = {"D": d, "M": m, "F": f,
                                              "levels": n, "H": h, "O": o}
    result["ok"] = ok_all
    print(json.dumps(result))
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
