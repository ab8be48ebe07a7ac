#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

  python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports neither JAX nor the JAX package ``repro``. Phases:

1. header: the card (nvidia-smi name and power limit), the nvcc build of
   the kernels with its time and ptxas report, and the TF32 state (off).
2. kernels: each bank kernel (qmlp_mlp_bank, qmlp_svm_bank) is held
   against its plain PyTorch version on the card: the fixture fronts'
   shapes, D=1, M not a multiple of the block, bits 1/4/6, H and O wider
   than a register chunk, a design above 48 KB of shared memory, a
   per-channel-range case and a wide D=64, M=65536 bank. Bitwise on
   dyadic inputs (every exported front's); rtol=1e-5, atol=1e-6 where the
   sums are not exact, because the kernel sums in another order. Then
   each kernel and its plain version are timed with CUDA events over 200
   launches after warm-up, beside the least time the card could take.
3. serve (the main path): with every launch counter at 0, each committed
   fixture front (tests/fixtures/fronts/cardio_{mlp,svm}, exported by the
   JAX package) is loaded and served by the batch driver, 256 requests x 8
   rows in microbatches of 1024, on cuda; the served accuracies must equal
   the exported ones exactly, and each kernel must have launched. Then the
   per-request predictions are held against the plain version's on the
   card.

It prints one JSON line of kernel results and, last, the
``{"ok": true, "device": ...}`` line. Any failed check, build or launch
exits non-zero before that line; so does a missing card or a directory
that does not hold the port.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
FRONTS = ROOT / "tests" / "fixtures" / "fronts"
DATASET = "cardio"

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12           # float32 outside the tensor cores
REPS = 200
WARMUP = 20

KERNELS = {
    "qmlp_mlp_bank": {"replaces": "src/repro/kernels/qmlp.py:210",
                      "pallas": "bespoke_mlp_bank_pallas "
                                "(+ bespoke_mlp_pallas as D=1)"},
    "qmlp_svm_bank": {"replaces": "src/repro/kernels/qmlp.py:250",
                      "pallas": "bespoke_svm_bank_pallas "
                                "(+ bespoke_svm_pallas as D=1)"},
}
SOURCE = "src/repro_torch/kernels/csrc/qmlp_bank.cu"


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- inputs
def dyadic_case(np, rng, kind, d, m, f, h, o, bits, x_lo=-0.1, x_hi=1.1):
    """Random pruned masks baked to dyadic tables, power-of-two weights
    and fixed-point biases: every partial sum is exact, so any summation
    order gives the same bits. x strays outside [0, 1] to hit the
    clamps."""
    from repro_torch.core.adc import repair_mask
    from repro_torch.core.spec import AdcSpec
    import torch
    spec = AdcSpec(bits=bits)
    n = 2 ** bits
    masks = repair_mask(torch.from_numpy(
        (rng.random((d, f, n)) < 0.5).astype(np.int32)))
    tables = spec.value_table(masks).contiguous()

    def po2(*shape):
        e = rng.integers(-3, 1, size=shape)
        s = rng.choice([-1.0, 0.0, 1.0], size=shape, p=[0.45, 0.1, 0.45])
        return (s * np.exp2(e)).astype(np.float32)

    def fixed(*shape):
        return (rng.integers(-16, 17, size=shape) / 16.0).astype(np.float32)

    if kind == "mlp":
        weights = (po2(d, f, h), fixed(d, h), po2(d, h, o), fixed(d, o))
    else:
        weights = (po2(d, f, o), fixed(d, o))
    x = rng.uniform(x_lo, x_hi, size=(m, f)).astype(np.float32)
    return spec, x, tables, tuple(torch.from_numpy(w) for w in weights)


def float_case(np, rng, kind, d, m, f, h, o, bits, per_channel):
    """Float weights (and optionally per-channel ranges): sums round, so
    kernel and plain agree to rounding only."""
    from repro_torch.core.adc import repair_mask
    from repro_torch.core.spec import AdcSpec
    import torch
    if per_channel:
        lo = rng.uniform(-1.0, 0.5, size=f)
        spec = AdcSpec(bits=bits, vmin=tuple(lo),
                       vmax=tuple(lo + rng.uniform(0.5, 2.0, size=f)))
        x = rng.uniform(lo - 0.2, lo + 2.2, size=(m, f)).astype(np.float32)
    else:
        spec = AdcSpec(bits=bits)
        x = rng.uniform(-0.1, 1.1, size=(m, f)).astype(np.float32)
    n = 2 ** bits
    masks = repair_mask(torch.from_numpy(
        (rng.random((d, f, n)) < 0.5).astype(np.int32)))
    tables = spec.value_table(masks).contiguous()
    g = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    weights = ((g(d, f, h), g(d, h), g(d, h, o), g(d, o)) if kind == "mlp"
               else (g(d, f, o), g(d, o)))
    return spec, x, tables, weights


# ---------------------------------------------------------------- timing
def cuda_ms(torch, fn, reps=REPS) -> float:
    """Mean time per call over ``reps`` back-to-back calls, CUDA events."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernel_ms(torch, fn, name_part: str, reps=REPS):
    """Device time per launch of the CUDA kernel whose name contains
    ``name_part``, from torch.profiler; None when the profiler records no
    device time for it."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if name_part in ev.key and ev.count:
            total = getattr(ev, "device_time_total",
                            getattr(ev, "cuda_time_total", 0.0))
            if total > 0:
                return total / ev.count / 1000.0
    return None


def bound(kind, d, m, f, n, h, o):
    """(bound_ms, bound_by, bytes, flops) of one bank call: each input read
    once and the output written once, against HBM; the multiply-adds
    against the float32 peak."""
    if kind == "mlp":
        resident = f * n + f * h + h + h * o + o
        flops = 2 * d * m * (f * h + h * o)
    else:
        resident = f * n + f * o + o
        flops = 2 * d * m * f * o
    nbytes = 4 * (m * f + d * m * o + d * resident + 2 * f)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, flops
    return t_ops, "operations", nbytes, flops


# ---------------------------------------------------------------- phases
def phase_kernels(np, torch, dev, fronts, x_test):
    from repro_torch.kernels import qmlp, ref
    rng = np.random.default_rng(2024)
    cases = []      # (label, kernel name, spec, x, tables, weights, exact)

    for kind, (designs, spec, tables, weights) in fronts.items():
        name = f"qmlp_{kind}_bank"
        cases.append((f"fixture {kind} front, test split", name, spec,
                      x_test, tables, weights, True))
        idx = rng.integers(0, len(x_test), size=1024)
        cases.append((f"fixture {kind} front, serve batch", name, spec,
                      x_test[idx], tables, weights, True))
        cases.append((f"fixture {kind} design 0 (D=1)", name, spec,
                      x_test, tables[:1], tuple(w[:1] for w in weights),
                      True))
        tile = np.arange(64) % len(designs)
        wide_x = x_test[rng.integers(0, len(x_test), size=65536)]
        cases.append((f"wide {kind} bank D=64 M=65536", name, spec, wide_x,
                      tables[tile], tuple(w[tile] for w in weights), True))
        for bits in (1, 4, 6):
            spec_b, x, t, w = dyadic_case(np, rng, kind, 4, 1000, 21, 5, 3,
                                          bits)
            cases.append((f"dyadic {kind} bits={bits} D=4 M=1000", name,
                          spec_b, x, t, w, True))
        spec_c, x, t, w = dyadic_case(np, rng, kind, 3, 333, 16, 20, 11, 4)
        cases.append((f"dyadic {kind} H=20 O=11 (register chunks)", name,
                      spec_c, x, t, w, True))
        spec_s, x, t, w = float_case(np, rng, kind, 2, 300, 200, 8, 4, 6,
                                     per_channel=False)
        cases.append((f"{kind} F=200 bits=6 (> 48 KB shared memory)", name,
                      spec_s, x, t, w, False))
        spec_p, x, t, w = float_case(np, rng, kind, 5, 777, 21, 5, 3, 4,
                                     per_channel=True)
        cases.append((f"{kind} per-channel ranges, float weights", name,
                      spec_p, x, t, w, False))

    wrappers = {"qmlp_mlp_bank": (qmlp.bespoke_mlp_bank,
                                  ref.bespoke_mlp_bank_ref),
                "qmlp_svm_bank": (qmlp.bespoke_svm_bank,
                                  ref.bespoke_svm_bank_ref)}
    max_err = {k: 0.0 for k in KERNELS}
    print("phase kernels: kernel vs plain version on the card")
    for label, name, spec, x, tables, weights, exact in cases:
        kern, plain = wrappers[name]
        xd = torch.as_tensor(x).to(dev).contiguous()
        td = torch.as_tensor(tables).to(dev).contiguous()
        wd = tuple(torch.as_tensor(w).to(dev).contiguous() for w in weights)
        got = kern(xd, td, *wd, spec=spec)
        want = plain(xd, td, spec.bits, *wd, spec.vmin, spec.vmax)
        torch.cuda.synchronize()
        check(got.shape == want.shape,
              f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite logits")
        err = float((got - want).abs().max())
        max_err[name] = max(max_err[name], err)
        if exact:
            ok = torch.equal(got, want)
            rule = "bitwise"
        else:
            ok = torch.allclose(got, want, rtol=1e-5, atol=1e-6)
            rule = "rtol=1e-5 atol=1e-6"
        print(f"  {name:14s} {label:45s} shape={tuple(got.shape)} "
              f"max_abs_err={err:.3e} [{rule}] {'ok' if ok else 'MISMATCH'}")
        check(ok, f"{name} disagrees with its plain version on {label} "
                  f"(max_abs_err {err:.3e}, {rule})")

    timings = {}
    for kind, (designs, spec, tables, weights) in fronts.items():
        name = f"qmlp_{kind}_bank"
        kern, plain = wrappers[name]
        shapes = {"serve batch": 1024, "wide bank": 65536}
        for label, m in shapes.items():
            tile = (np.arange(64) % len(designs) if label == "wide bank"
                    else np.arange(len(designs)))
            xd = torch.as_tensor(
                x_test[rng.integers(0, len(x_test), size=m)]).to(dev)
            td = torch.as_tensor(tables[tile]).to(dev).contiguous()
            wd = tuple(torch.as_tensor(w[tile]).to(dev).contiguous()
                       for w in weights)
            d, f, n = td.shape
            h = wd[0].shape[2] if kind == "mlp" else 0
            o = wd[-1].shape[-1]
            rows = tuple(t.to(dev) for t in _rows(spec, f))
            k_fn = lambda: kern(xd, td, *wd, spec=spec, rows=rows)  # noqa
            p_fn = lambda: plain(xd, td, spec.bits, *wd,  # noqa: E731
                                 spec.vmin, spec.vmax)
            # plain, kernel, kernel, plain: same card, turns interleaved
            p1 = cuda_ms(torch, p_fn)
            k1 = cuda_ms(torch, k_fn)
            k2 = cuda_ms(torch, k_fn)
            p2 = cuda_ms(torch, p_fn)
            dev_ms = device_kernel_ms(torch, k_fn, f"{name}_kernel")
            b_ms, b_by, nbytes, flops = bound(kind, d, m, f, n, h, o)
            row = {"shape": {"D": d, "M": m, "F": f, "levels": n, "H": h,
                             "O": o},
                   "ms": min(k1, k2), "plain_ms": min(p1, p2),
                   "device_ms": dev_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "bytes": nbytes, "flops": flops}
            timings.setdefault(name, {})[label] = row
            dev_txt = ("not measured" if dev_ms is None
                       else f"{dev_ms * 1e3:.2f} us")
            print(f"  time {name:14s} {label:12s} D={d} M={m}: "
                  f"kernel {k1 * 1e3:.2f}/{k2 * 1e3:.2f} us per call "
                  f"(profiler device time {dev_txt}), plain "
                  f"{p1 * 1e3:.2f}/{p2 * 1e3:.2f} us, bound "
                  f"{b_ms * 1e3:.3f} us ({b_by})")
    return max_err, timings


def _rows(spec, f):
    from repro_torch.core.adc import range_rows_tensors
    return range_rows_tensors(spec.bits, spec.vmin, spec.vmax, f)


def phase_serve(np, torch, dev, card, fronts, data):
    from repro_torch.core import deploy
    from repro_torch.kernels import qmlp, ref
    from repro_torch.launch.serve_classifier import (make_request_stream,
                                                     serve)
    requests = make_request_stream(data["x_test"], 256, 8)
    reports = {}
    print("phase serve: main path (load_front -> serve -> "
          "served_accuracies) on cuda")
    qmlp.reset_launches()
    for kind in fronts:
        designs = deploy.load_front(FRONTS / f"cardio_{kind}")
        rep = serve(designs, requests, 1024, device=dev)
        served = deploy.served_accuracies(designs, data["x_test"],
                                          data["y_test"], device=dev)
        exported = np.array([d.accuracy for d in designs])
        reports[kind] = (designs, rep, served, exported)
    launches = dict(qmlp.launches)
    print(f"  launch counters after the main path: {launches}")

    for kind, (designs, rep, served, exported) in reports.items():
        name = f"qmlp_{kind}_bank"
        for i, d in enumerate(designs):
            print(f"  {kind} design {i}: area={d.area_tc}T exported="
                  f"{d.accuracy!r} served={float(served[i])!r}")
        check(np.array_equal(served, exported),
              f"{kind}: served accuracies {served} != exported {exported}")
        # one launch per microbatch, plus the warm-up and the accuracy pass
        check(launches[name] == rep["batches"] + 2,
              f"{name}: {launches[name]} launches for {rep['batches']} "
              f"microbatches + warm-up + accuracy pass")
        print(f"  {kind}: {rep['requests']} requests ({rep['samples']} "
              f"samples, {rep['batches']} microbatches of {rep['batch']}) "
              f"in {rep['wall_s']:.4f} s: {rep['requests_per_s']:.1f} "
              f"req/s, {rep['samples_per_s']:.0f} samples/s on {card}; "
              f"parity OK")

        tables, weights = deploy.bank_arrays(designs)
        td = torch.from_numpy(tables).to(dev)
        wd = tuple(torch.from_numpy(w).to(dev) for w in weights)
        spec = designs[0].spec
        plain = (ref.bespoke_mlp_bank_ref if kind == "mlp"
                 else ref.bespoke_svm_bank_ref)
        plain_fn = lambda xb: plain(xb, td, spec.bits, *wd,  # noqa: E731
                                    spec.vmin, spec.vmax)
        plain_rep = serve(designs, requests, 1024, device=dev,
                          bank_fn=plain_fn)
        same = all(np.array_equal(rep["responses"][rid],
                                  plain_rep["responses"][rid])
                   for rid, _ in requests)
        check(same, f"{kind}: per-request predictions differ from the "
                    f"plain version's")
        print(f"  {kind}: per-request predictions == plain version's "
              f"({len(requests)} requests)")
        # a longer run of the same driver, for a steadier rate
        long_reqs = make_request_stream(data["x_test"], 8192, 8, seed=1)
        long_rep = serve(designs, long_reqs, 1024, device=dev)
        print(f"  {kind}: {long_rep['requests']} requests "
              f"({long_rep['batches']} microbatches) in "
              f"{long_rep['wall_s']:.4f} s: "
              f"{long_rep['requests_per_s']:.1f} req/s, "
              f"{long_rep['samples_per_s']:.0f} samples/s on {card}")
    for name in KERNELS:
        check(launches[name] > 0, f"{name} never launched on the main path")
    return launches


def main() -> int:
    if not (SRC / "repro_torch").is_dir() or not FRONTS.is_dir():
        print("chip_smoke: FAIL: run from the root of a checkout holding "
              "src/repro_torch and tests/fixtures/fronts", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    from repro_torch.core import deploy
    from repro_torch.data import tabular
    from repro_torch.device import resolve_device, tf32_state
    from repro_torch.kernels import _build

    try:
        card = card_line()
        print(f"nvidia-smi: {card}")
        dev = resolve_device("cuda")
        kind_name = torch.cuda.get_device_name(0)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device 0: {kind_name}")
        t0 = time.perf_counter()
        built = _build.build_all()
        print(f"build: {time.perf_counter() - t0:.2f} s "
              f"({', '.join(f'{k} {v:.2f} s' for k, v in built.items())})")
        for line in _build.build_log("qmlp_bank").splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling")):
                print(f"  ptxas: {line.strip()}")
        tf32 = tf32_state()
        print(f"tf32: {tf32}")
        check(not any(tf32.values()), "TF32 is on")

        data = tabular.make_dataset(DATASET)
        x_test = data["x_test"]
        fronts = {}
        for kind in ("mlp", "svm"):
            designs = deploy.load_front(FRONTS / f"cardio_{kind}")
            tables, weights = deploy.bank_arrays(designs)
            fronts[kind] = (designs, designs[0].spec, tables, weights)

        max_err, timings = phase_kernels(np, torch, dev, fronts, x_test)
        launches = phase_serve(np, torch, dev, card, fronts, data)

        mods = sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "jaxlib"))
                      or m == "repro" or m.startswith("repro."))
        check(not mods, f"JAX or the JAX package was imported: {mods}")

        rows = []
        for name, meta in KERNELS.items():
            t = timings[name]["serve batch"]
            rows.append({
                "name": name, "route": "cuda", "source": SOURCE,
                "replaces": meta["replaces"], "pallas": meta["pallas"],
                "launches": launches[name], "max_abs_err": max_err[name],
                "ms": t["ms"], "kernel_ms": t["ms"],
                "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None, "shape": t["shape"],
                "wide_bank": timings[name]["wide bank"]})
        print(json.dumps({"kernels": rows}))
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    print(card)                      # nvidia-smi's name and power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
