#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

  python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports neither JAX nor the JAX package ``repro``. Phases:

1. header: the card (nvidia-smi name and power limit), the nvcc build of
   every kernel source (one nvcc each, started together) with its time
   and ptxas report (registers and spills of every instantiation; the
   five tensor-core attention instantiations must not spill, nor may the
   eighteen CUDA-core ones compiled for head widths up to 128, nor the
   twelve Monte-Carlo ones, the two quantizer ones or the four bank
   ones), the SM clock, and the TF32 state (off).
2. kernels: each kernel is held against its plain PyTorch version on the
   card. The bank kernels (qmlp_mlp_bank, qmlp_svm_bank): the fixture
   fronts' shapes, D=1, M not a multiple of the block, bits 1/4/6, H and O
   wider than a register chunk, a design above 48 KB of shared memory, a
   per-channel-range case, one design at the shared-memory edge (the
   kernels' unpadded layout) and a wide D=64, M=65536 bank; bitwise on
   dyadic inputs (every exported front's), rtol=1e-5, atol=1e-6 where the
   sums are not exact. The population quantizer (adc_quantize_population):
   the search's shapes (cardio train and test splits, P=16 and 32), P=1
   (the adc_quantize entry), M not a multiple of the tile, bits 1/4/6,
   per-channel ranges, a table above 48 KB, NaN, +-inf and x on every
   code boundary (scalar and per-channel ranges), M*C odd (the kernel's
   word walk) and a wide P=64, M=65536 call; bitwise everywhere (a gather
   copies table values). For every bank and quantizer case the built
   library's launch geometry must equal envelope.bank_geometry's or
   envelope.quantize_geometry's, and every timed bank and quantizer call
   must have a device time in torch.profiler. The Monte-Carlo
   kernel's four entries (mc_adc_eval{,_cal}{,_population}): the search's
   shapes (P=16, S=32, cardio test and train splits) under every
   non-ideality spec (ideal, offset, drift, faults, fault_rate=1, all
   three), P=1 and S=1, ragged M, bits 1/4/6/7, per-channel ranges, NaN,
   +-inf and on-bound inputs, C=200 at 6 bits (150 KB of shared memory),
   P*S above 65,535, and a wide call writing 1.41 GB; then interval
   tables that are no partition (overlapping, empty and NaN intervals,
   mixed-sign values) for all four entries at 2^N 16 and 128 and at
   C=300, above a block's threads; bitwise everywhere, the operands and
   draws compiled on the card equal the CPU's bitwise, and the built
   kernel's launch geometry equals envelope.mc_geometry's. Then each
   kernel and its plain version are timed with
   CUDA events over 200 launches after warm-up (20 for the wide MC calls)
   and with torch.profiler, beside the least time the card could take;
   the single-design calls too. The flash-attention kernels, each call
   on the route dispatch names and counted on that route's key:
   flash_attention_tc (tensor cores, wgmma + TMA; bf16 at the configs'
   head widths 64, 96, 112, 128, 256) and flash_attention (CUDA cores;
   float32, and bf16 at other widths). The JAX package's four test shapes
   in f32, musicgen-medium's prefill (B=4, S=2048, H=KV=24, dh=64) in
   bf16 and f32, gemma2's widths (H=8, KV=4, dh=256, window 1024, softcap
   50, S=4096), phi3's (dh=96, S=1030) and llama4's (H=40, KV=8, dh=128,
   S=2047) in bf16 and f32, kimi's (H=64, KV=8, dh=112, window 512,
   S=1500) in bf16, ragged S=Sk=2049 (bf16 and f32), key positions
   holding -1 (f32 and bf16), fully masked rows (exactly 0) and bf16 at
   dh=32, on q, k ~ N(0, 1.5^2) and
   v ~ N(1, 1) (a peaked softmax, outputs O(1)); rtol=atol=2e-5 in f32
   (the JAX package's own test), two output ulps in bf16 (rtol 2^-6,
   atol 2^-7) against the plain version in the working type, a limit
   that must reject the plain version with one kv tile dropped and with
   the wrong kv head; each built kernel's shared memory must equal the
   envelope's. Timed at the musicgen (bf16 and f32), gemma2 (bf16 and
   f32), ragged and llama4 (bf16 and f32) shapes beside the bound (the
   largest of the HBM, the tensor- or CUDA-core and the ex2 times, the
   last at the SM clock read from the card) and, for the causal cases
   without window or softcap, scaled_dot_product_attention (the
   yardstick; the port never calls it), with the name of the device
   kernel it ran.
3. serve (the serving path): with every launch counter at 0, each
   committed fixture front (tests/fixtures/fronts/cardio_{mlp,svm},
   exported by the JAX package) is loaded and served by the batch driver,
   256 requests x 8 rows in microbatches of 1024, on cuda; the served
   accuracies must equal the exported ones exactly, design 0 served alone
   (the D=1 entry) must give its exported accuracy, and each bank kernel
   must have launched. The per-request predictions are then held against
   the plain version's on the card.
4. search (the main path): with every launch counter at 0, for the MLP
   and the SVM on cardio at full width (21 features, hidden 5, 3 classes,
   4-bit tree ADC; pop 16, 3 generations, 100 QAT steps, the fixture
   fronts' config): run_search -> export_front -> verify_front_parity
   (must be True) -> save_front -> load_front -> serve by the batch driver
   -> served accuracies must equal the exported ones exactly. The
   quantizer must have launched twice (train and test split) per
   population evaluation: 2 x (generations + 1) for the search, 2 for
   train_pareto_front and 2 for verify_front_parity; the bank kernels must
   have launched in serving. A lane-purity probe re-trains the front
   without padding to the fixed lane count and reports whether the lane
   count changed any accuracy.
5. robust (the robustness path): with every launch counter at 0 per
   model, the same search shape with 32 Monte-Carlo instances under
   NonIdealSpec(sigma_offset=0.5, sigma_range=0.01, fault_rate=0.02): the
   MLP with robust_objective='expected', the SVM with a FaultTolSpec and
   'yield'. run_search -> export_front -> verify_front_parity ->
   evaluate_robustness (must reproduce the searched third column
   bitwise) -> save_front/save_robustness -> load. MLP: serving instances
   0 and 31 through make_nonideal_bank_fn must give their listed instance
   accuracies, zero sigma must give the exported accuracy on every
   instance, and zero-sigma MC must equal the ideal quantizer. SVM:
   calibrate_front and make_calibrated_bank_fn serve, the tmr/calibrated
   leaves survive save -> load. The MC population entry must launch once
   and the quantizer twice per evaluation. A few genomes through the
   reference engine at one lane (the single-design MC entries) must equal
   the batched engine at one lane. Then one robust evaluation and one
   2-objective evaluation of the same genomes are timed in turns, and one
   robust evaluation is traced (MC device time, device busy share).
6. generation: one generation at SearchConfig defaults (pop 32, 300 QAT
   steps) per model, timed on the host clock around a synchronised call,
   then traced with torch.profiler: device time of the quantizer, of
   everything else, and the device's busy share.
7. baseline (the paper's Table 5 "Baseline" column): with every launch
   counter at 0 per model, full_adc_baseline for the MLP and the SVM at
   the search path's config: the full ADC at dp = -3 through one
   fixed-lane QAT chunk (2 quantizer launches), its accuracy equal to
   evaluate_population_acc of the same genome bitwise, and the flash,
   binary and proposed full areas equal to 21 x area.flash_full_tc(4),
   baseline_binary_tc(4) and ours_full_tc(4); the Table 5 row printed.
8. resume (search checkpoint/resume): with every launch counter at 0,
   the MLP search (pop 16, 3 generations, 100 QAT steps) checkpointing
   to a temporary directory, once whole and once killed after
   generation 1 (the save hook raises) and resumed: the final
   checkpoint (population, fitness, Generator state and, screened, the
   surrogate's leaves) and the front must equal the uninterrupted run's
   bitwise; then the same with screen_factor=2, whose front must
   re-train (train_pareto_front) to its fitness bitwise. The quantizer
   must have launched twice per QAT chunk of the phase.
9. gradient (the gradient engine): with every launch counter at 0,
   run_gradient_search for the MLP and the SVM, cut in depth from the
   reference's grad_* defaults (64 lanes, 800 gate-train steps in 4
   chunks, 2 polish rounds of at most 192 exact evaluations): the MLP to
   32 lanes, the SVM to 16 lanes, 400 steps and one polish round (the
   cuts printed), each -> export_front ->
   verify_front_parity (True) -> save_front -> load_front -> serve
   through the bank kernel, served accuracies equal to the exported ones
   and the front re-training to its fitness bitwise. The MLP's gate
   train killed after chunk 1 (that chunk traced: device time,
   operations, busy share) and resumed must give the uninterrupted
   run's snapshot genomes bitwise, and the backward of its per-code
   table lookup (the one-hot product) must be bitwise equal over five
   runs (a plain gather's, a scatter of float atomics, is printed
   beside it). Printed with the card: gate-train seconds
   per step, pool size and exact evaluations, re-score, polish and total
   seconds, launches of the quantizer and the banks. The quantizer must
   have launched twice per QAT chunk (counted around
   search._train_and_score), and each bank at least once.
10. lm (the LM serving path): with every launch counter at 0,
   repro_torch.launch.serve.main serves musicgen-medium at its full
   published config (48 layers, d_model 1536, 24 heads, dh 64; random
   seeded weights) on cuda: 4 requests, prompt 2048, 16 decode steps. The
   tensor-core flash kernel must launch exactly 48 times (once per layer
   of the prefill) and the CUDA-core one never, the (4, 16) generated
   matrix and every logit must be finite;
   prefill's last-position logits must equal logits_fn's (2e-2), and one
   decode step after prefill(extra_slots=1) the forward over the ragged
   2049-long sequence: 3e-2 in float32 activations (path lm_f32: that
   prefill and decode step, counted from 0, must launch the CUDA-core
   kernel 48 times and the tensor-core one never), 1.25e-1 in the served
   bf16 (twice its reading; each bf16 path is printed against the float32
   forward, and the bf16 forward with the plain attention in place of the
   kernel, as witnesses that the gap is rounding), a limit that must
   reject a decode whose layers read the next layer's cache and one with
   a 64-slot tile of the cache zeroed. Then a warm prefill and 16 warm
   decode steps are timed, and one prefill and one decode step traced
   (flash kernel device time, device operations, device busy share); so
   is the warm float32 prefill of the lm_f32 path (4 x 2048, 48 CUDA-core
   launches), beside the stated baseline of the CUDA-core kernel this one
   replaced (3.185 ms a call x 48 launches).

It prints one JSON line of kernel results, one entry per kernel (row 11
has two, one per route; launches summed over the serve, search, robust,
baseline, resume, gradient, lm and lm_f32 paths, each counted from 0),
then the card's name and power limit, and, last, the
``{"ok": true, "device": ...}`` line. Any failed check, build or launch
exits non-zero before that line; so does a missing card or a directory
that does not hold the port.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
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
    "adc_quantize": {"row": 1, "replaces": "src/repro/kernels/adc_quantize.py:101",
                     "pallas": "adc_quantize_pallas (the P=1 call)",
                     "source": "src/repro_torch/kernels/csrc/adc_quantize.cu"},
    "adc_quantize_population": {
        "row": 2, "replaces": "src/repro/kernels/adc_quantize.py:139",
        "pallas": "adc_quantize_pallas_population",
        "source": "src/repro_torch/kernels/csrc/adc_quantize.cu"},
    "bespoke_mlp": {"row": 3, "replaces": "src/repro/kernels/qmlp.py:140",
                    "pallas": "bespoke_mlp_pallas (the D=1 call)",
                    "source": "src/repro_torch/kernels/csrc/qmlp_bank.cu"},
    "bespoke_svm": {"row": 4, "replaces": "src/repro/kernels/qmlp.py:178",
                    "pallas": "bespoke_svm_pallas (the D=1 call)",
                    "source": "src/repro_torch/kernels/csrc/qmlp_bank.cu"},
    "qmlp_mlp_bank": {"row": 5, "replaces": "src/repro/kernels/qmlp.py:210",
                      "pallas": "bespoke_mlp_bank_pallas",
                      "source": "src/repro_torch/kernels/csrc/qmlp_bank.cu"},
    "qmlp_svm_bank": {"row": 6, "replaces": "src/repro/kernels/qmlp.py:250",
                      "pallas": "bespoke_svm_bank_pallas",
                      "source": "src/repro_torch/kernels/csrc/qmlp_bank.cu"},
    "mc_adc_eval": {"row": 7, "replaces": "src/repro/kernels/mc_eval.py:92",
                    "pallas": "mc_adc_eval_pallas (the P=1 call)",
                    "source": "src/repro_torch/kernels/csrc/mc_eval.cu"},
    "mc_adc_eval_population": {
        "row": 8, "replaces": "src/repro/kernels/mc_eval.py:129",
        "pallas": "mc_adc_eval_pallas_population",
        "source": "src/repro_torch/kernels/csrc/mc_eval.cu"},
    "mc_adc_eval_cal": {"row": 9,
                        "replaces": "src/repro/kernels/mc_eval.py:194",
                        "pallas": "mc_adc_eval_cal_pallas (the P=1 call)",
                        "source": "src/repro_torch/kernels/csrc/mc_eval.cu"},
    "mc_adc_eval_cal_population": {
        "row": 10, "replaces": "src/repro/kernels/mc_eval.py:231",
        "pallas": "mc_adc_eval_cal_pallas_population",
        "source": "src/repro_torch/kernels/csrc/mc_eval.cu"},
    "flash_attention_tc": {
        "row": 11, "replaces": "src/repro/kernels/flash_attention.py:74",
        "pallas": "flash_attention_pallas (bf16 at the configs' head "
                  "widths: the tensor-core route)",
        "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu"},
    "flash_attention": {
        "row": 11, "replaces": "src/repro/kernels/flash_attention.py:74",
        "pallas": "flash_attention_pallas (float32, and bf16 at other head "
                  "widths: the CUDA-core route)",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu"},
}
# the device kernel each launch counter counts, as torch.profiler names it
FLASH_DEVICE_NAMES = {"flash_attention_tc": "flash_attention_tc_kernel",
                      "flash_attention": "flash_attention_kernel"}
# the search's main path: the fixture fronts' config at cardio's width
SEARCH = dict(bits=4, pop_size=16, generations=3, train_steps=100)
# the robust path: the same shape with 32 Monte-Carlo instances
ROBUST = dict(SEARCH, mc_samples=32)
# the gradient path's cuts of depth (the reference's grad_* defaults: 64
# lanes, 800 gate-train steps in 4 chunks, 2 polish rounds of at most 192
# exact evaluations), to keep the phase near 90 s on a host-bound card
GRADIENT_CUTS = {"mlp": dict(grad_points=32),
                 "svm": dict(grad_points=16, grad_train_steps=400,
                             grad_polish_rounds=1)}
ROBUST_NI = dict(sigma_offset=0.5, sigma_range=0.01, fault_rate=0.02,
                 seed=0)
# the wide Monte-Carlo call: 64 x 32 x 8192 x 21 float32 outputs, 1.41 GB
MC_WIDE = dict(P=64, S=32, M=8192)
# the LM path: musicgen-medium at its full published config
LM = dict(arch="musicgen-medium", requests=4, prompt_len=2048, gen=16)
BF16_FLOP_PER_S = 989e12         # dense bf16 on the tensor cores
EX2_PER_SM_PER_CLOCK = 16        # special-function unit exponentials
FLASH_F32_TOL = dict(rtol=2e-5, atol=2e-5)   # the JAX package's own test
# bf16: two ulps of the output at its magnitude (2^-6 relative), for the
# output's rounding on both sides, plus one ulp at 1.0 (2^-7 absolute),
# for p rounded to bf16 against different running maxima (the kernel's
# online max, the plain version's row max) carried to an O(1) output.
# The largest error seen, 1.56e-2 at an output below 1, is 0.97 of a
# limit without that floor
FLASH_BF16_TOL = dict(rtol=2 ** -6, atol=2 ** -7)
FLASH_QK_STD = 1.5               # scores' std 2.25: a peaked softmax
LM_TEACHER_F32_TOL = 3e-2        # tests/test_steps_lm.py's tolerance
# musicgen's float32 flash call on the CUDA-core kernel the 8 x 8 design
# replaced (NVIDIA H100 80GB HBM3, 700.00 W): the lm_f32 prefill's
# stated baseline
BASELINE_CUDA_CORE_MS = 3.185
LM_TEACHER_BF16_ATOL = 1.25e-1   # 2x the largest sound bf16 reading


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


def sm_clock(torch):
    """(SM clock in Hz, its source, SM count) of card 0: the clock from
    torch's device properties where they carry it, else nvidia-smi's
    maximum SM clock."""
    props = torch.cuda.get_device_properties(0)
    khz = getattr(props, "clock_rate", None)
    if khz:
        return (khz * 1e3, "torch.cuda.get_device_properties(0).clock_rate",
                props.multi_processor_count)
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return (float(res.stdout.strip().splitlines()[0]) * 1e6,
            "nvidia-smi clocks.max.sm", props.multi_processor_count)


def ptxas_report(log: str):
    """[(kernel, registers, spill store bytes, spill load bytes)] from an
    nvcc -Xptxas -v log, plus its performance warnings."""
    import re
    rows, name, spills, warn = [], None, (0, 0), []
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spills))
            spills = (0, 0)
        if "Potential Performance Loss" in line:
            warn.append(line.strip())
    return rows, warn


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


def top_device_kernel(torch, fn, reps=3):
    """The name of the device kernel that takes most of ``fn``'s device
    time, from torch.profiler; None when it records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    best, best_us = None, 0.0
    for ev in prof.key_averages():
        if "DeviceType.CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        total = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
        if total > best_us:
            best, best_us = ev.key, total
    return best


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
def bank_cases(np, rng, fronts, x_test):
    """The bank phase's cases: [(label, kernel name, spec, x, tables,
    weights, exact)]; ``exact``: every partial sum is exact (dyadic), so
    any summation order gives the same bits."""
    cases = []

    for kind, (designs, spec, tables, weights) in fronts.items():
        name = f"qmlp_{kind}_bank"
        cases.append((f"fixture {kind} front, test split", name, spec,
                      x_test, tables, weights, True))
        idx = rng.integers(0, len(x_test), size=1024)
        cases.append((f"fixture {kind} front, serve batch", name, spec,
                      x_test[idx], tables, weights, True))
        cases.append((f"fixture {kind} design 0 (D=1)", f"bespoke_{kind}",
                      spec, x_test, tables[:1],
                      tuple(w[:1] for w in weights), True))
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
    for kind, f in (("mlp", 840), ("svm", 860)):
        # one design that leaves the kernel too little shared memory for
        # padded weight rows and four rows a thread: its unpadded path;
        # dyadic, so the 840-term sums are exact in any order
        spec_e, x, t, w = dyadic_case(np, rng, kind, 2, 300, f, 1, 1, 6)
        cases.append((f"dyadic {kind} F={f} bits=6 at the shared-memory "
                      f"edge", f"qmlp_{kind}_bank", spec_e, x, t, w, True))
    return cases


def phase_kernels(np, torch, dev, fronts, x_test):
    from repro_torch.kernels import envelope, qmlp, ref
    rng = np.random.default_rng(2024)
    cases = bank_cases(np, rng, fronts, x_test)

    def single(fn):
        """The single-design entry on a D=1 bank's operands, (1, M, O)."""
        return lambda x, t, *w, spec, rows=None: fn(
            x, t[0], *(a[0] for a in w), spec=spec, rows=rows)[None]

    wrappers = {"qmlp_mlp_bank": (qmlp.bespoke_mlp_bank,
                                  ref.bespoke_mlp_bank_ref),
                "qmlp_svm_bank": (qmlp.bespoke_svm_bank,
                                  ref.bespoke_svm_bank_ref),
                "bespoke_mlp": (single(qmlp.bespoke_mlp),
                                ref.bespoke_mlp_bank_ref),
                "bespoke_svm": (single(qmlp.bespoke_svm),
                                ref.bespoke_svm_bank_ref)}
    max_err = {k: 0.0 for k in wrappers}
    print("phase kernels: kernel vs plain version on the card")
    for label, name, spec, x, tables, weights, exact in cases:
        kern, plain = wrappers[name]
        xd = torch.as_tensor(x).to(dev).contiguous()
        td = torch.as_tensor(tables).to(dev).contiguous()
        wd = tuple(torch.as_tensor(w).to(dev).contiguous() for w in weights)
        kind = "svm" if "svm" in name else "mlp"
        shape = (kind, td.shape[0], xd.shape[0], td.shape[1], td.shape[2],
                 wd[0].shape[2] if kind == "mlp" else 0, wd[-1].shape[-1])
        mirror = envelope.bank_geometry(*shape)
        built = qmlp.geometry(*shape)
        check(built == tuple(mirror), f"{name} {label}: the built kernel's "
                                      f"geometry {built} != envelope's "
                                      f"{mirror}")
        check("edge" not in label or not mirror.padded,
              f"{name} {label}: expected the unpadded layout, got {mirror}")
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
              f"max_abs_err={err:.3e} [{rule}, geometry ==] "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"{name} disagrees with its plain version on {label} "
                  f"(max_abs_err {err:.3e}, {rule})")

    timings = {}
    for kind, (designs, spec, tables, weights) in fronts.items():
        # the front at the serve batch; design 0 alone (the D=1 call that
        # replaces bespoke_{mlp,svm}_pallas); a wide bank
        shapes = {"serve batch": (1024, np.arange(len(designs))),
                  "D=1": (1024, np.arange(1)),
                  "wide bank": (65536, np.arange(64) % len(designs))}
        for label, (m, tile) in shapes.items():
            name = (f"bespoke_{kind}" if label == "D=1"
                    else f"qmlp_{kind}_bank")
            kern, plain = wrappers[name]
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
            dev_ms = device_kernel_ms(torch, k_fn, f"qmlp_{kind}_bank_kernel")
            check(dev_ms is not None, f"torch.profiler recorded no device "
                                      f"time for qmlp_{kind}_bank_kernel")
            b_ms, b_by, nbytes, flops = bound(kind, d, m, f, n, h, o)
            row = {"shape": {"D": d, "M": m, "F": f, "levels": n, "H": h,
                             "O": o},
                   "ms": min(k1, k2), "plain_ms": min(p1, p2),
                   "device_ms": dev_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "bytes": nbytes, "flops": flops}
            timings.setdefault(name, {})[label] = row
            print(f"  time {name:14s} {label:12s} D={d} M={m}: "
                  f"kernel {k1 * 1e3:.2f}/{k2 * 1e3:.2f} us per call "
                  f"(profiler device time {dev_ms * 1e3:.2f} us), plain "
                  f"{p1 * 1e3:.2f}/{p2 * 1e3:.2f} us, bound "
                  f"{b_ms * 1e3:.3f} us ({b_by})")
    return max_err, timings


def _rows(spec, f):
    from repro_torch.core.adc import range_rows_tensors
    return range_rows_tensors(spec.bits, spec.vmin, spec.vmax, f)


def quantize_bound(p, m, c, n):
    """(bound_ms, bound_by, bytes, ops) of one population-quantizer call:
    x read once, the tables and rows read once, P x M x C outputs written
    once, against HBM; about five float operations per output (subtract,
    multiply, floor, two clamps) against the float32 peak."""
    nbytes = 4 * (m * c + p * c * n + 2 * c + p * m * c)
    ops = 5 * p * m * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, ops
    return t_ops, "operations", nbytes, ops


def code_edge_inputs(np, rng, spec, m, c):
    """x (M, C) float32, uniform over each channel's range widened by a
    tenth; rows 0-2 NaN, +inf and -inf, and rows 3 .. 2^(N+1) + 2 put
    every channel on each code boundary k: x nudged, one float at a time
    and at most 64 floats, to the least float32 whose code position
    (x - lo) * scale reaches k in float32, and the float below it."""
    from repro_torch.core.adc import range_rows
    n = spec.levels
    lo, sc = (r[0].astype(np.float64) for r in range_rows(
        spec.bits, spec.vmin, spec.vmax, c))
    width = n / sc
    x = rng.uniform(lo - 0.1 * width, lo + 1.1 * width,
                    size=(m, c)).astype(np.float32)
    x[0], x[1], x[2] = np.nan, np.inf, -np.inf
    lo32, sc32 = lo.astype(np.float32), sc.astype(np.float32)
    for k in range(n):
        for ch in range(c):
            xv = np.float32(lo[ch] + k / sc[ch])
            for _ in range(64):
                u = np.float32(np.float32(xv - lo32[ch]) * sc32[ch])
                if u >= k and np.float32(np.float32(np.nextafter(
                        xv, np.float32(-np.inf)) - lo32[ch]) * sc32[ch]) < k:
                    break
                xv = np.nextafter(xv, np.float32(np.inf if u < k
                                                 else -np.inf))
            x[3 + 2 * k, ch] = xv
            x[4 + 2 * k, ch] = np.nextafter(xv, np.float32(-np.inf))
    return x


def random_masks(np, torch, rng, p, c, bits):
    """Repaired pruned masks (P, C, 2^N), as genome decode gives them."""
    from repro_torch.core.adc import repair_mask
    return repair_mask(torch.from_numpy(
        (rng.random((p, c, 2 ** bits)) < 0.5).astype(np.int32)))


def quantizer_cases(np, torch, rng, data):
    """The quantizer phase's cases: [(label, spec, x, masks, via the P=1
    entry)]."""
    from repro_torch.core.spec import AdcSpec
    x_tr, x_te = data["x_train"], data["x_test"]
    c = x_tr.shape[1]
    cases = []
    for split, x in (("train", x_tr), ("test", x_te)):
        for p in (16, 32):
            cases.append((f"cardio {split} split M={len(x)} P={p}",
                          AdcSpec(bits=4), x, random_masks(
                              np, torch, rng, p, c, 4), False))
    cases.append((f"P=1 (adc_quantize entry) M={len(x_te)}", AdcSpec(bits=4),
                  x_te, random_masks(np, torch, rng, 1, c, 4)[0], True))
    for m in (257, 1000):
        x = rng.uniform(-0.1, 1.1, size=(m, c)).astype(np.float32)
        cases.append((f"ragged M={m} P=5", AdcSpec(bits=4), x,
                      random_masks(np, torch, rng, 5, c, 4), False))
    for bits in (1, 4, 6):
        x = rng.uniform(-0.1, 1.1, size=(999, c)).astype(np.float32)
        cases.append((f"bits={bits} M=999 P=7", AdcSpec(bits=bits), x,
                      random_masks(np, torch, rng, 7, c, bits), False))
    lo = rng.uniform(-1.0, 0.5, size=c)
    spec_pc = AdcSpec(bits=4, vmin=tuple(lo),
                      vmax=tuple(lo + rng.uniform(0.5, 2.0, size=c)))
    x = rng.uniform(lo - 0.2, lo + 2.2, size=(777, c)).astype(np.float32)
    cases.append(("per-channel ranges M=777 P=6", spec_pc, x,
                  random_masks(np, torch, rng, 6, c, 4), False))
    x = rng.uniform(-0.1, 1.1, size=(600, 200)).astype(np.float32)
    cases.append(("C=200 bits=6 (table > 48 KB) P=3", AdcSpec(bits=6), x,
                  random_masks(np, torch, rng, 3, 200, 6), False))
    wide_x = x_te[rng.integers(0, len(x_te), size=65536)]
    cases.append(("wide P=64 M=65536", AdcSpec(bits=4), wide_x,
                  random_masks(np, torch, rng, 64, c, 4), False))
    for spec_e in (AdcSpec(bits=4), spec_pc):
        x = code_edge_inputs(np, rng, spec_e, 999, c)
        cases.append((f"NaN, +-inf, on code boundaries M=999 P=9"
                      f"{' per-channel' if spec_e is spec_pc else ''}",
                      spec_e, x, random_masks(np, torch, rng, 9, c, 4),
                      False))
    x = code_edge_inputs(np, rng, AdcSpec(bits=4), 635, c)    # M*C odd
    cases.append(("word walk (M*C odd), edges M=635 P=16", AdcSpec(bits=4),
                  x, random_masks(np, torch, rng, 16, c, 4), False))
    return cases


def phase_quantizer(np, torch, dev, data):
    """adc_quantize_population against ref.adc_quantize_ref_population on
    the card, bitwise, then timed at the search's shapes."""
    from repro_torch.core.spec import AdcSpec
    from repro_torch.kernels import adc_quantize as adcq
    from repro_torch.kernels import envelope, ops, ref
    rng = np.random.default_rng(2025)
    x_tr, x_te = data["x_train"], data["x_test"]
    c = x_tr.shape[1]
    cases = quantizer_cases(np, torch, rng, data)
    wide_x = next(x for label, _, x, _, _ in cases
                  if label.startswith("wide"))

    max_err = {"adc_quantize_population": 0.0, "adc_quantize": 0.0}
    print("phase kernels: adc_quantize{,_population} vs plain version on "
          "the card (bitwise)")
    for label, spec, x, masks, single in cases:
        name = "adc_quantize" if single else "adc_quantize_population"
        xd = torch.as_tensor(x).to(dev).contiguous()
        md = masks.to(dev)
        tables = spec.value_table(md).contiguous()
        shape = (1 if single else tables.shape[0], x.shape[0], x.shape[1],
                 tables.shape[-1])
        built, mirror = adcq.geometry(*shape), tuple(
            envelope.quantize_geometry(*shape))
        check(built == mirror, f"{label}: the built kernel's geometry "
                               f"{built} != envelope's {mirror}")
        if single:
            got = ops.adc_quantize(xd, md, spec=spec)
            want = ref.adc_quantize_ref(xd, tables, spec.bits, spec.vmin,
                                        spec.vmax)
        else:
            got = ops.adc_quantize_population(xd, md, spec=spec)
            want = ref.adc_quantize_ref_population(xd, tables, spec.bits,
                                                   spec.vmin, spec.vmax)
        torch.cuda.synchronize()
        check(got.shape == want.shape,
              f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = float((got - want).abs().max())
        max_err[name] = max(max_err[name], err)
        ok = torch.equal(got, want)
        print(f"  {name} {label:40s} shape={tuple(got.shape)} "
              f"max_abs_err={err:.3e} [bitwise, geometry ==] "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"{name} disagrees with its plain version on {label} "
                  f"(max_abs_err {err:.3e}, bitwise)")
        del got, want

    timings = {}
    spec = AdcSpec(bits=4)
    shapes = {"search train P=16": (x_tr, 16), "search test P=16": (x_te, 16),
              "search train P=32": (x_tr, 32), "P=1": (x_te, 1),
              "wide P=64 M=65536": (wide_x, 64)}
    name = "adc_quantize_population"
    for label, (x, p) in shapes.items():
        xd = torch.as_tensor(x).to(dev).contiguous()
        tables = spec.value_table(random_masks(np, torch, rng, p, c, 4)
                                  .to(dev)).contiguous()
        m, n = len(x), spec.levels
        rows = tuple(t.to(dev) for t in _rows(spec, c))
        if p == 1:                           # the adc_quantize entry
            k_fn = lambda: adcq.adc_quantize(  # noqa: E731
                xd, tables[0], spec=spec, rows=rows)
        else:
            k_fn = lambda: adcq.adc_quantize_population(  # noqa: E731
                xd, tables, spec=spec, rows=rows)
        p_fn = lambda: ref.adc_quantize_ref_population(  # noqa: E731
            xd, tables, spec.bits, spec.vmin, spec.vmax)
        p1 = cuda_ms(torch, p_fn)
        k1 = cuda_ms(torch, k_fn)
        k2 = cuda_ms(torch, k_fn)
        p2 = cuda_ms(torch, p_fn)
        dev_ms = device_kernel_ms(torch, k_fn, f"{name}_kernel")
        check(dev_ms is not None, f"torch.profiler recorded no device time "
                                  f"for {name}_kernel")
        b_ms, b_by, nbytes, nops = quantize_bound(p, m, c, n)
        timings[label] = {"shape": {"P": p, "M": m, "C": c, "levels": n},
                          "ms": min(k1, k2), "plain_ms": min(p1, p2),
                          "device_ms": dev_ms, "bound_ms": b_ms,
                          "bound_by": b_by, "bytes": nbytes, "ops": nops}
        print(f"  time {name} {label:18s}: kernel {k1 * 1e3:.2f}/"
              f"{k2 * 1e3:.2f} us per call (profiler device time "
              f"{dev_ms * 1e3:.2f} us), plain {p1 * 1e3:.2f}/"
              f"{p2 * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({b_by}, "
              f"{nbytes} bytes)")
    return max_err, timings


def phase_serve(np, torch, dev, card, fronts, data):
    from repro_torch.core import deploy
    from repro_torch.kernels import qmlp, ref
    from repro_torch.launch.serve_classifier import (make_request_stream,
                                                     serve)
    requests = make_request_stream(data["x_test"], 256, 8)
    reports = {}
    print("phase serve: the serving path (load_front -> serve -> "
          "served_accuracies) on cuda")
    reset_all_launches()
    for kind in fronts:
        designs = deploy.load_front(FRONTS / f"cardio_{kind}")
        rep = serve(designs, requests, 1024, device=dev)
        served = deploy.served_accuracies(designs, data["x_test"],
                                          data["y_test"], device=dev)
        exported = np.array([d.accuracy for d in designs])
        # one design served alone: the single-design entry (D=1)
        alone = designs[0].accuracy_on(data["x_test"], data["y_test"],
                                       device=dev)
        check(alone == designs[0].accuracy,
              f"{kind}: design 0 served alone gives {alone}, exported "
              f"{designs[0].accuracy}")
        reports[kind] = (designs, rep, served, exported)
    launches = all_launches()
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
    for name in ("qmlp_mlp_bank", "qmlp_svm_bank", "bespoke_mlp",
                 "bespoke_svm"):
        check(launches[name] > 0, f"{name} never launched on the serving "
                                  f"path")
    print("  design 0 of each front served alone (the D=1 entry) at its "
          "exported accuracy")
    return launches


def reset_all_launches():
    from repro_torch.kernels import adc_quantize as adcq
    from repro_torch.kernels import flash_attention, mc_eval, qmlp
    qmlp.reset_launches()
    adcq.reset_launches()
    mc_eval.reset_launches()
    flash_attention.reset_launches()


def all_launches():
    from repro_torch.kernels import adc_quantize as adcq
    from repro_torch.kernels import flash_attention, mc_eval, qmlp
    return {**qmlp.launches, **adcq.launches, **mc_eval.launches,
            **flash_attention.launches}


def phase_search(np, torch, dev, card, data):
    """The main path: the port searches, exports, checks, saves, loads and
    serves its own front, for the MLP and the SVM."""
    from repro_torch.core import deploy, search
    from repro_torch.data import tabular
    from repro_torch.launch.serve_classifier import (make_request_stream,
                                                     serve)
    spec = tabular.SPECS[DATASET]
    sizes = (spec.features, spec.hidden, spec.classes)
    requests = make_request_stream(data["x_test"], 256, 8)
    evals = 2 * (SEARCH["generations"] + 1) + 2 + 2
    print(f"phase search: the main path (run_search -> export_front -> "
          f"verify_front_parity -> save_front -> load_front -> serve) on "
          f"cuda, cardio sizes={sizes}, {SEARCH}")
    out, fronts = {}, {}
    for kind in ("mlp", "svm"):
        cfg = search.SearchConfig(model=kind, **SEARCH)
        marks = [time.perf_counter()]

        def log(g, pop, fit):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            dt = marks[-1] - marks[-2]
            print(f"  {kind} gen {g}: {dt:.3f} s/gen, "
                  f"{cfg.pop_size / dt:.1f} individuals/s, best-acc "
                  f"{1 - fit[:, 0].min():.4f}, min-area "
                  f"{fit[:, 1].min():.4f}", flush=True)

        reset_all_launches()
        t0 = time.perf_counter()
        pg, pf, _, trained = search.run_search(
            data, sizes, cfg, log=log, return_trained=True, device=dev)
        designs = deploy.export_front(pg, data, sizes, cfg, trained=trained,
                                      device=dev)
        parity = deploy.verify_front_parity(designs, pg, data, sizes, cfg,
                                            device=dev)
        with tempfile.TemporaryDirectory() as tmp:
            deploy.save_front(tmp, designs, extra_meta={
                "dataset": DATASET, "sizes": list(sizes)})
            loaded = deploy.load_front(tmp)
        rep = serve(loaded, requests, 1024, device=dev)
        served = deploy.served_accuracies(loaded, data["x_test"],
                                          data["y_test"], device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
        exported = np.array([d.accuracy for d in designs])
        gen_s = [b - a for a, b in zip(marks[1:-1], marks[2:])]
        for i, d in enumerate(designs):
            print(f"  {kind} design {i}: area={d.area_tc}T dp={int(d.dp)} "
                  f"exported={d.accuracy!r} served={float(served[i])!r}")
        print(f"  {kind}: {len(designs)} designs; verify_front_parity="
              f"{parity}; launch counters {launches}; main path "
              f"{wall:.2f} s on {card}")
        if gen_s:
            print(f"  {kind}: steady generation {np.mean(gen_s):.3f} s "
                  f"({cfg.pop_size / np.mean(gen_s):.1f} individuals/s) "
                  f"over generations 1..{len(gen_s)} on {card}")
        check(parity, f"{kind}: verify_front_parity is False")
        # the front's re-train (train_pareto_front) reproduces the fitness
        # each genome got in whichever generation evaluated it
        refit = (1.0 - trained[0].astype(np.float32)).astype(np.float64)
        check(np.array_equal(refit, pf[:, 0]),
              f"{kind}: re-trained accuracies {trained[0]} do not give the "
              f"search fitness {1 - pf[:, 0]}")
        check(np.array_equal(served, exported),
              f"{kind}: served accuracies {served} != exported {exported}")
        check(launches["adc_quantize_population"] == evals,
              f"{kind}: adc_quantize_population launched "
              f"{launches['adc_quantize_population']} times, expected "
              f"{evals} (2 per population evaluation)")
        name = f"qmlp_{kind}_bank"
        check(launches[name] == rep["batches"] + 2,
              f"{name}: {launches[name]} launches for {rep['batches']} "
              f"microbatches + warm-up + accuracy pass")
        out[kind] = {"launches": launches, "designs": len(designs),
                     "generation_s": gen_s, "wall_s": wall}
        fronts[kind] = (pg, cfg)

    # lane purity: the front re-trained as exactly its K lanes, without
    # padding to the fixed lane count, against the padded result
    dd = search.device_data(data, dev)
    for kind, (pg, cfg) in fronts.items():
        padded = search._fixed_lanes(pg, dd, sizes, cfg)["acc"]
        k = len(pg)
        free = search._train_and_score(
            pg, search._stacked_init(k, sizes, cfg, dev), dd, sizes,
            cfg)["acc"].cpu().numpy()
        same = bool(np.array_equal(free, padded))
        out[kind]["lane_count_free_equals_padded"] = same
        print(f"  lane-purity probe {kind}: K={k} lanes unpadded vs padded "
              f"to {cfg.pop_size}: {'equal' if same else 'DIFFERENT'} "
              f"(max |diff| {float(np.abs(free - padded).max()):.3e})")
    return out


def mc_bound(p, s, m, c, n, cal):
    """(bound_ms, bound_by, bytes, ops) of one Monte-Carlo call: x read
    once, lb and ub once, the values (C, 2^N) or, calibrated, (P, S, C,
    2^N) once, the (S, C) rows once, P x S x M x C outputs written once,
    against HBM; per output a subtract and a multiply, two compares per
    leaf and one add, against the float32 peak."""
    tab = p * s * c * n
    nbytes = 4 * (m * c + 2 * tab + (tab if cal else c * n) + 2 * s * c
                  + p * s * m * c)
    ops = p * s * m * c * (3 + 2 * n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, ops
    return t_ops, "operations", nbytes, ops


MC_SPECS = {"ideal": (0.0, 0.0, 0.0), "offset": (0.5, 0.0, 0.0),
            "drift": (0.0, 0.01, 0.0), "faults": (0.0, 0.0, 0.05),
            "all faulty": (0.0, 0.0, 1.0), "all three": (0.5, 0.01, 0.02)}


def mc_operands_on(np, torch, dev, spec, ni, masks, s, cal, seed=0):
    """The Monte-Carlo operands of (P, C, 2^N) masks (or one (C, 2^N)
    mask), compiled on ``dev``: the nominal ones, or, with ``cal``, the
    calibrated-table ones under random TMR and calibrate genes."""
    from repro_torch.core import nonideal
    from repro_torch.faulttol import calibrate, redundancy
    c = masks.shape[-2]
    if not cal:
        return nonideal.mc_operands(spec, ni, masks, samples=s, device=dev)
    rng = np.random.default_rng(seed)
    lead = masks.shape[:-2]
    tmr = (rng.random(lead + (c,)) < 0.5).astype(np.int32)
    genes = (rng.random(lead) < 0.5).astype(np.int32)
    rd = redundancy.draw_redundant(spec.bits, c, s, ni, dev)
    return calibrate.mc_operands_ft(spec, ni, masks, tmr, genes, rd, dev)


def on_bound_inputs(np, x, lb, lo, scale):
    """Rows 0-2 of x become NaN, +inf and -inf; row 3 puts every channel
    exactly on a finite lower bound of instance 0 of design 0 (x nudged
    until (x - lo) * scale lands on it in float32)."""
    x = np.array(x, np.float32)
    x[0], x[1], x[2] = np.nan, np.inf, -np.inf
    lb0 = lb.reshape((-1,) + lb.shape[-3:])[0, 0]          # (C, 2^N)
    lo0, sc0 = lo[0], scale[0]
    for ch in range(x.shape[1]):
        ks = np.nonzero(np.isfinite(lb0[ch]) & (lb0[ch] > 0))[0]
        if not len(ks):
            continue
        t = lb0[ch, ks[0]]
        xv = np.float32(lo0[ch] + t / sc0[ch])
        for _ in range(16):
            u = np.float32(np.float32(xv - lo0[ch]) * sc0[ch])
            if u == t:
                break
            xv = np.nextafter(xv, np.float32(np.inf if u < t else -np.inf))
        x[3, ch] = xv
    return x


def overlapping_operands(np, rng, lead, s, c, n, cal):
    """Monte-Carlo operands (lb, ub, values, lo, scale) whose intervals
    are no partition, as numpy arrays: lb/ub (*lead, S, C, 2^N) of random
    position and width (0 to 3 codes wide, a sixth empty or reversed, a
    few NaN), so that none, one or several leaves are live at a code
    position; values of mixed signs with some -0.0, (C, 2^N) or, with
    ``cal``, (*lead, S, C, 2^N); lo/scale (S, C) spreading x in [0, 1]
    over the 2^N codes."""
    shape = lead + (s, c, n)
    lb = rng.uniform(-1.0, n + 1.0, size=shape).astype(np.float32)
    ub = (lb + rng.uniform(-0.6, 3.0, size=shape)).astype(np.float32)
    lb[rng.random(shape) < 0.02] = np.nan
    ub[rng.random(shape) < 0.02] = np.nan
    lb[..., 0], ub[..., -1] = -np.inf, np.inf
    values = rng.uniform(-2.0, 2.0, size=shape if cal else (c, n)).astype(
        np.float32)
    values[rng.random(values.shape) < 0.1] = -0.0
    lo = rng.uniform(-0.1, 0.1, size=(s, c)).astype(np.float32)
    scale = (n * rng.uniform(0.9, 1.1, size=(s, c))).astype(np.float32)
    return lb, ub, values, lo, scale


def live_leaves(torch, x, lb, ub, values, lo, scale):
    """How many leaves are live at each output: (..., S, M, C)."""
    u = ((x[None] - lo[:, None]) * scale[:, None])[..., None]
    return ((u >= lb.unsqueeze(-3)) & (u < ub.unsqueeze(-3))).sum(-1)


def phase_mc_kernels(np, torch, dev, data):
    """The four Monte-Carlo entries against their plain versions on the
    card, bitwise, then timed beside their bounds."""
    from repro_torch.core import nonideal
    from repro_torch.core.spec import AdcSpec
    from repro_torch.kernels import envelope, mc_eval, ref
    rng = np.random.default_rng(2026)
    x_tr, x_te = data["x_train"], data["x_test"]
    c = x_tr.shape[1]
    all3 = nonideal.NonIdealSpec(*MC_SPECS["all three"], seed=1)
    cases = []      # (label, spec, nonideal, x, masks, S, special, compare)
    for sname, knobs in MC_SPECS.items():
        ni = nonideal.NonIdealSpec(*knobs, seed=2)
        cases.append((f"search test split P=16 S=32 M=636, {sname}",
                      AdcSpec(bits=4), ni, x_te,
                      random_masks(np, torch, rng, 16, c, 4), 32, False))
    cases.append(("search train split P=16 S=32 M=1488", AdcSpec(bits=4),
                  all3, x_tr, random_masks(np, torch, rng, 16, c, 4), 32,
                  False))
    cases.append(("P=1 (single-design entry) S=32 M=636", AdcSpec(bits=4),
                  all3, x_te, random_masks(np, torch, rng, 1, c, 4)[0], 32,
                  False))
    cases.append(("S=1 P=16 M=636", AdcSpec(bits=4), all3, x_te,
                  random_masks(np, torch, rng, 16, c, 4), 1, False))
    cases.append(("P=1 S=1 M=636", AdcSpec(bits=4), all3, x_te,
                  random_masks(np, torch, rng, 1, c, 4)[0], 1, False))
    for m in (257, 1000):
        x = rng.uniform(-0.1, 1.1, size=(m, c)).astype(np.float32)
        cases.append((f"ragged M={m} P=5 S=7", AdcSpec(bits=4), all3, x,
                      random_masks(np, torch, rng, 5, c, 4), 7, False))
    for bits in (1, 4, 6):
        x = rng.uniform(-0.1, 1.1, size=(999, c)).astype(np.float32)
        cases.append((f"bits={bits} P=3 S=8 M=999", AdcSpec(bits=bits),
                      all3, x, random_masks(np, torch, rng, 3, c, bits), 8,
                      False))
    lo = rng.uniform(-1.0, 0.5, size=c)
    spec_pc = AdcSpec(bits=4, vmin=tuple(lo),
                      vmax=tuple(lo + rng.uniform(0.5, 2.0, size=c)))
    x = rng.uniform(lo - 0.2, lo + 2.2, size=(777, c)).astype(np.float32)
    cases.append(("per-channel ranges P=6 S=8 M=777", spec_pc, all3, x,
                  random_masks(np, torch, rng, 6, c, 4), 8, False))
    cases.append(("NaN, +-inf and on-bound inputs P=4 S=8 M=636",
                  AdcSpec(bits=4), all3, x_te,
                  random_masks(np, torch, rng, 4, c, 4), 8, True))
    x = rng.uniform(-0.1, 1.1, size=(300, 200)).astype(np.float32)
    cases.append(("C=200 bits=6 (150 KB shared memory) P=2 S=3", AdcSpec(
        bits=6), all3, x, random_masks(np, torch, rng, 2, 200, 6), 3, False))
    x = rng.uniform(-0.1, 1.1, size=(16, 3)).astype(np.float32)
    cases.append(("P*S = 2100*32 > 65535 (grid loop) C=3 M=16",
                  AdcSpec(bits=4),
                  all3, x, random_masks(np, torch, rng, 2100, 3, 4), 32,
                  False))
    rng7 = np.random.default_rng(2027)      # leaves the cases above as they were
    x = rng7.uniform(-0.1, 1.1, size=(999, 8)).astype(np.float32)
    cases.append(("bits=7 C=8 (2^N=128, shared memory) P=3 S=8 M=999",
                  AdcSpec(bits=7), all3, x,
                  random_masks(np, torch, rng7, 3, 8, 7), 8, False))

    plain = {"mc_adc_eval": ref.mc_adc_eval_ref,
             "mc_adc_eval_population": ref.mc_adc_eval_ref_population,
             "mc_adc_eval_cal": ref.mc_adc_eval_cal_ref,
             "mc_adc_eval_cal_population":
                 ref.mc_adc_eval_cal_ref_population}
    max_err = {k: 0.0 for k in plain}
    print("phase kernels: mc_adc_eval{,_cal}{,_population} vs plain "
          "version on the card (bitwise); operands and draws compiled on "
          "the card vs on the CPU (bitwise)")
    d_cpu = nonideal.draw(4, c, 32, all3)
    d_gpu = nonideal.draw(4, c, 32, all3, device=dev)
    check(all(torch.equal(a, b.cpu()) for a, b in zip(d_cpu, d_gpu)),
          "the draws differ between the CPU and the card")
    def held(entry, label, xd, operands, note):
        got = getattr(mc_eval, entry)(xd, *operands)
        want = plain[entry](xd, *operands)
        torch.cuda.synchronize()
        check(got.shape == want.shape,
              f"{entry} {label}: shape {tuple(got.shape)} != "
              f"{tuple(want.shape)}")
        lb = operands[0]
        p, s = (1, lb.shape[0]) if lb.ndim == 3 else tuple(lb.shape[:2])
        (m, c), n = xd.shape, lb.shape[-1]
        mirror = tuple(envelope.mc_geometry(p, s, m, c, n))
        built = mc_eval.geometry(p, s, m, c, n)
        check(built == mirror, f"{entry} {label}: the built kernel's launch "
                               f"geometry {built} != envelope's {mirror}")
        err = float((got - want).abs().max())
        max_err[entry] = max(max_err[entry], err)
        ok = torch.equal(got, want)
        print(f"  {entry:27s} {label:45s} shape={tuple(got.shape)} "
              f"max_abs_err={err:.3e} [bitwise{note}, geometry ==] "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"{entry} disagrees with its plain version on {label} "
                  f"(max_abs_err {err:.3e}, bitwise)")

    for label, spec, ni, x, masks, s, special in cases:
        for cal in (False, True):
            single = masks.ndim == 2
            entry = ("mc_adc_eval" + ("_cal" if cal else "")
                     + ("" if single else "_population"))
            operands = mc_operands_on(np, torch, dev, spec, ni,
                                      masks.to(dev), s, cal)
            host = mc_operands_on(np, torch, "cpu", spec, ni, masks, s, cal)
            same = all(torch.equal(a.cpu(), b)
                       for a, b in zip(operands, host))
            check(same, f"{entry} operands on the card differ from the CPU's "
                        f"on {label}")
            xs = (on_bound_inputs(np, x, host[0].numpy(), host[3].numpy(),
                                  host[4].numpy()) if special else x)
            xd = torch.as_tensor(xs).to(dev).contiguous()
            held(entry, label, xd, operands, ", operands ==")

    # no channels, and no leaves: an empty output, and zeros
    for c_e, n_e in ((0, 16), (21, 0)):
        ops_e = tuple(torch.zeros(shape, device=dev) for shape in (
            (3, 4, c_e, n_e), (3, 4, c_e, n_e), (c_e, n_e), (4, c_e),
            (4, c_e)))
        xe = torch.zeros((50, c_e), device=dev)
        before = dict(mc_eval.launches)
        got = mc_eval.mc_adc_eval_population(xe, *ops_e)
        torch.cuda.synchronize()
        launched = mc_eval.launches != before
        ok = (got.shape == (3, 4, 50, c_e) and not bool(got.any())
              and launched == (c_e > 0))
        print(f"  {'mc_adc_eval_population':27s} "
              f"{f'C={c_e} 2^N={n_e} P=3 S=4 M=50':45s} shape="
              f"{tuple(got.shape)} launched={launched} "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"C={c_e}, 2^N={n_e}: shape {tuple(got.shape)}, "
                  f"launched {launched}")

    # interval tables that are no partition: overlapping, empty and NaN
    # intervals, mixed-sign values; the sum must add every live leaf in k
    # order, as the plain version does
    for c_o, bits_o, m_o in ((21, 4, 1000), (8, 7, 333), (300, 2, 257)):
        n_o = 2 ** bits_o
        x = rng7.uniform(-0.1, 1.1, size=(m_o, c_o)).astype(np.float32)
        x[0], x[1] = np.nan, np.inf
        xd = torch.as_tensor(x).to(dev)
        for entry in plain:
            lead = () if entry in ("mc_adc_eval", "mc_adc_eval_cal") else (5,)
            operands = tuple(torch.as_tensor(a).to(dev) for a in
                             overlapping_operands(np, rng7, lead, 8, c_o, n_o,
                                                  "_cal" in entry))
            live = live_leaves(torch, xd, *operands)
            share = float((live >= 2).float().mean())
            check(share > 0.1 and int(live.max()) >= 3,
                  f"the overlapping case at C={c_o} has too few outputs "
                  f"with two live leaves ({share:.3f})")
            held(entry, f"overlapping C={c_o} 2^N={n_o} S=8 M={m_o}", xd,
                 operands, f", {100 * share:.0f} % with >= 2 live leaves")

    # a wide call: P=64, S=32, M=8192, C=21 writes 1.41 GB
    wp, ws, wm = MC_WIDE["P"], MC_WIDE["S"], MC_WIDE["M"]
    wide_x = x_te[rng.integers(0, len(x_te), size=wm)]
    wide_masks = random_masks(np, torch, rng, wp, c, 4).to(dev)
    xd = torch.as_tensor(wide_x).to(dev).contiguous()
    for cal in (False, True):
        entry = "mc_adc_eval_cal_population" if cal else \
            "mc_adc_eval_population"
        operands = mc_operands_on(np, torch, dev, AdcSpec(bits=4), all3,
                                  wide_masks, ws, cal)
        got = getattr(mc_eval, entry)(xd, *operands)
        want = plain[entry](xd, *operands)
        torch.cuda.synchronize()
        gb = got.numel() * 4 / 1e9
        err = float((got - want).abs().max())
        max_err[entry] = max(max_err[entry], err)
        ok = torch.equal(got, want)
        label = f"wide P={wp} S={ws} M={wm} ({gb:.2f} GB out)"
        print(f"  {entry:27s} {label:45s} max_abs_err={err:.3e} [bitwise] "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok and gb >= 1.0,
              f"{entry} wide call: bitwise {ok}, {gb:.2f} GB written")
        del got, want, operands
    torch.cuda.empty_cache()

    timings = {}
    shapes = {   # label: (entry, P, S, x, masks)
        "search P=16 S=32 M=636": ("mc_adc_eval_population", 16, 32, x_te),
        "evaluate_robustness D=6 S=32 M=636": ("mc_adc_eval_population", 6,
                                               32, x_te),
        f"wide P={wp} S={ws} M={wm}": ("mc_adc_eval_population", wp, ws,
                                       wide_x),
        "single S=32 M=636": ("mc_adc_eval", 1, 32, x_te),
        "cal search P=16 S=32 M=636": ("mc_adc_eval_cal_population", 16, 32,
                                       x_te),
        f"cal wide P={wp} S={ws} M={wm}": ("mc_adc_eval_cal_population", wp,
                                           ws, wide_x),
        "cal single S=32 M=636": ("mc_adc_eval_cal", 1, 32, x_te)}
    spec = AdcSpec(bits=4)
    for label, (entry, p, s, x) in shapes.items():
        cal = "_cal" in entry
        single = not entry.endswith("_population")
        masks = random_masks(np, torch, rng, p, c, 4).to(dev)
        if single:
            masks = masks[0]
        operands = mc_operands_on(np, torch, dev, spec, all3, masks, s, cal)
        xd = torch.as_tensor(x).to(dev).contiguous()
        k_fn = lambda: getattr(mc_eval, entry)(xd, *operands)  # noqa: E731
        p_fn = lambda: plain[entry](xd, *operands)  # noqa: E731
        reps = 20 if "wide" in label else REPS
        p1 = cuda_ms(torch, p_fn, reps)
        k1 = cuda_ms(torch, k_fn, reps)
        k2 = cuda_ms(torch, k_fn, reps)
        p2 = cuda_ms(torch, p_fn, reps)
        dev_ms = device_kernel_ms(torch, k_fn, "mc_eval_kernel", reps)
        m = len(x)
        b_ms, b_by, nbytes, nops = mc_bound(p, s, m, c, 16, cal)
        timings.setdefault(entry, {})[label] = {
            "shape": {"P": p, "S": s, "M": m, "C": c, "levels": 16},
            "ms": min(k1, k2), "plain_ms": min(p1, p2), "device_ms": dev_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": nops}
        dev_txt = ("not measured" if dev_ms is None
                   else f"{dev_ms * 1e3:.2f} us")
        print(f"  time {entry:27s} {label:36s}: kernel {k1 * 1e3:.2f}/"
              f"{k2 * 1e3:.2f} us per call (profiler device time "
              f"{dev_txt}), plain {p1 * 1e3:.2f}/{p2 * 1e3:.2f} us, bound "
              f"{b_ms * 1e3:.3f} us ({b_by}, {nbytes} bytes)")
        del operands
        torch.cuda.empty_cache()
    return max_err, timings


def phase_robust(np, torch, dev, card, data, search_out):
    """The robust path: with every launch counter at 0 per model, a
    3-objective search on cardio at full width, export, the deployed
    robustness report, save/load and serving through sampled (and, for
    the fault-tolerant SVM, calibrated) hardware instances; then the
    reference engine's single-design entries; then one robust generation
    traced with torch.profiler."""
    import dataclasses
    from repro_torch.core import deploy, nonideal, search
    from repro_torch.data import tabular
    from repro_torch.faulttol import FaultTolSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_classifier import (make_request_stream,
                                                     serve)
    spec = tabular.SPECS[DATASET]
    sizes = (spec.features, spec.hidden, spec.classes)
    ni = nonideal.NonIdealSpec(**ROBUST_NI)
    x_te, y_te = data["x_test"], data["y_test"]
    y_dev = torch.as_tensor(y_te).to(dev)
    requests = make_request_stream(x_te, 256, 8)
    configs = {
        "mlp": search.SearchConfig(model="mlp", nonideal=ni,
                                   robust_objective="expected", **ROBUST),
        "svm": search.SearchConfig(model="svm", nonideal=ni,
                                   robust_objective="yield",
                                   faulttol=FaultTolSpec(), **ROBUST)}
    gens = ROBUST["generations"]
    print(f"phase robust: the robust path (run_search -> export_front -> "
          f"evaluate_robustness -> save_front -> load_front -> non-ideal / "
          f"calibrated serving) on cuda, cardio sizes={sizes}, {ROBUST}, "
          f"{ni.describe()}")
    out = {}
    for kind, cfg in configs.items():
        pop_entry = ("mc_adc_eval_cal_population" if cfg.faulttol
                     else "mc_adc_eval_population")
        single_entry = "mc_adc_eval_cal" if cfg.faulttol else "mc_adc_eval"
        marks = [time.perf_counter()]

        def log(g, pop, fit):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            dt = marks[-1] - marks[-2]
            print(f"  {kind} gen {g}: {dt:.3f} s/gen, best-acc "
                  f"{1 - fit[:, 0].min():.4f}, min-area "
                  f"{fit[:, 1].min():.4f}, best-robust "
                  f"{fit[:, 2].min():.4f}", flush=True)

        reset_all_launches()
        t0 = time.perf_counter()
        pg, pf, decode, trained = search.run_search(
            data, sizes, cfg, log=log, return_trained=True, device=dev)
        torch.cuda.synchronize()
        after_search = all_launches()
        designs = deploy.export_front(pg, data, sizes, cfg, trained=trained,
                                      device=dev)
        parity = deploy.verify_front_parity(designs, pg, data, sizes, cfg,
                                            device=dev)
        margins = (cfg.yield_margin, 0.05)
        torch.cuda.synchronize()
        t_rep = time.perf_counter()
        rep = deploy.evaluate_robustness(designs, ni, x_te, y_te,
                                         samples=cfg.mc_samples,
                                         yield_margins=margins, device=dev)
        t_rep = time.perf_counter() - t_rep
        print(f"  {kind}: evaluate_robustness of {len(designs)} designs x "
              f"{cfg.mc_samples} instances on the test split: {t_rep:.4f} s "
              f"on {card}")
        with tempfile.TemporaryDirectory() as tmp:
            deploy.save_front(tmp, designs, extra_meta={
                "dataset": DATASET, "sizes": list(sizes)})
            deploy.save_robustness(tmp, rep)
            loaded = deploy.load_front(tmp)
            rep_loaded = deploy.load_robustness(tmp)
        check(rep_loaded == json.loads(json.dumps(rep)),
              f"{kind}: robustness.json does not round-trip")
        served = {}
        if cfg.faulttol is None:
            for k in (0, cfg.mc_samples - 1):
                fn = deploy.make_nonideal_bank_fn(
                    loaded, ni, instance=k, samples=cfg.mc_samples,
                    device=dev)
                srep = serve(loaded, requests, 1024, device=dev, bank_fn=fn)
                logits = fn(x_te)
                served[k] = deploy._mean_acc(
                    torch.argmax(logits, -1) == y_dev[None]).cpu().numpy()
                print(f"  {kind}: served instance {k} of {cfg.mc_samples} "
                      f"through make_nonideal_bank_fn: {srep['requests']} "
                      f"requests in {srep['wall_s']:.4f} s, "
                      f"{srep['requests_per_s']:.1f} req/s on {card}")
            zero = deploy.evaluate_robustness(
                designs, nonideal.NonIdealSpec(seed=3), x_te, y_te,
                samples=cfg.mc_samples, device=dev)
            xd = torch.as_tensor(x_te).to(dev)
            mask = torch.from_numpy(designs[0].mask).to(dev)
            ideal_q = ops.adc_quantize(xd, mask, spec=cfg.adc_spec)
            mc_q = nonideal.mc_quantize(xd, mask, cfg.adc_spec,
                                        nonideal.NonIdealSpec(), samples=2)
            check(torch.equal(mc_q, ideal_q[None].expand_as(mc_q)),
                  f"{kind}: zero-sigma MC != the ideal quantizer")
        else:
            cal = deploy.calibrate_front(loaded, ni, instance=0,
                                         samples=cfg.mc_samples, device=dev)
            cal_acc = deploy.served_accuracies(cal, x_te, y_te, device=dev)
            cfn = deploy.make_calibrated_bank_fn(
                loaded, ni, instance=0, samples=cfg.mc_samples, device=dev)
            crep = serve(loaded, requests, 1024, device=dev, bank_fn=cfn)
            clog = cfn(x_te)
            check(bool(torch.isfinite(clog).all())
                  and tuple(clog.shape) == (len(loaded), len(x_te), 3),
                  f"{kind}: calibrated serving gave {tuple(clog.shape)} / "
                  f"non-finite logits")
            cal_served = deploy._mean_acc(
                torch.argmax(clog, -1) == y_dev[None]).cpu().numpy()
            print(f"  {kind}: calibrate_front(instance 0) served "
                  f"accuracies {[float(a) for a in cal_acc]}; "
                  f"make_calibrated_bank_fn {[float(a) for a in cal_served]};"
                  f" {crep['requests']} requests in {crep['wall_s']:.4f} s, "
                  f"{crep['requests_per_s']:.1f} req/s on {card}")
            for a, b in zip(loaded, designs):
                check(np.array_equal(a.tmr, b.tmr)
                      and a.calibrated == b.calibrated,
                      f"{kind}: tmr/calibrated leaves lost in save -> load")
        # the reference engine: a few genomes, one lane each, against the
        # batched engine at the same lane count (pop_size=1), so both QATs
        # run the same shapes and the single-design MC entry is held
        # against the population one
        one = dataclasses.replace(cfg, pop_size=1)
        g3 = pg[:3]
        dd = search.device_data(data, dev)
        before_ref = all_launches()[single_entry]
        ref_fit = search.evaluate_population_reference(
            g3, dd, sizes, dataclasses.replace(one, engine="reference"))
        bat_fit = search.evaluate_population(g3, dd, sizes, one)
        torch.cuda.synchronize()
        launches = all_launches()
        wall = time.perf_counter() - t0
        gen_s = [b - a for a, b in zip(marks[1:-1], marks[2:])]

        col = np.array([
            (1.0 - r["yield"][f"{cfg.yield_margin:g}"]) if cfg.faulttol
            else r["expected_drop"] for r in rep["designs"]])
        for i, d in enumerate(designs):
            r = rep["designs"][i]
            print(f"  {kind} design {i}: area={d.area_tc}T "
                  f"exported={d.accuracy!r} mean={r['mean_accuracy']!r} "
                  f"worst={r['worst_accuracy']!r} yield@0.01="
                  f"{r['yield']['0.01']!r} column={pf[i, 2]!r} "
                  f"report={col[i]!r}"
                  + (f" tmr={int(d.tmr.sum())}/{d.channels} "
                     f"calibrated={d.calibrated}" if d.tmr is not None
                     else ""))
        print(f"  {kind}: {len(designs)} designs; verify_front_parity="
              f"{parity}; launches after the search {after_search}; after "
              f"the whole path {launches}; path {wall:.2f} s on {card}")
        check(parity, f"{kind}: verify_front_parity is False")
        check(np.array_equal(col, pf[:, 2]),
              f"{kind}: evaluate_robustness {col} != the searched third "
              f"column {pf[:, 2]}")
        if cfg.faulttol is None:
            for k, acc in served.items():
                want = np.array([r["instance_accuracies"][k]
                                 for r in rep["designs"]], np.float32)
                check(np.array_equal(acc, want),
                      f"{kind}: serving instance {k} gave {acc}, the report "
                      f"lists {want}")
            for d, r in zip(designs, zero["designs"]):
                check(r["instance_accuracies"] == [d.accuracy] * cfg.mc_samples,
                      f"{kind}: zero-sigma instances {r['instance_accuracies']}"
                      f" != exported {d.accuracy}")
            print(f"  {kind}: report == searched column bitwise; instances 0 "
                  f"and {cfg.mc_samples - 1} served at their listed "
                  f"accuracies; zero sigma == exported for every instance")
        else:
            print(f"  {kind}: report (1 - yield@{cfg.yield_margin:g}) == "
                  f"searched column bitwise; tmr/calibrated survive "
                  f"save -> load")
        evals = gens + 1
        check(after_search[pop_entry] == evals,
              f"{pop_entry}: {after_search[pop_entry]} launches in the "
              f"search, expected {evals} (1 per population evaluation)")
        check(after_search["adc_quantize_population"] == 2 * evals + 2,
              f"adc_quantize_population: "
              f"{after_search['adc_quantize_population']} launches in the "
              f"search, expected {2 * evals + 2} (2 per evaluation, 2 for "
              f"train_pareto_front)")
        ref_launches = launches[single_entry] - before_ref
        check(ref_launches == len(g3),
              f"{single_entry}: {ref_launches} launches for {len(g3)} "
              f"reference-engine genomes")
        check(np.allclose(ref_fit, bat_fit, rtol=0, atol=1e-6)
              and np.array_equal(ref_fit[:, 2], bat_fit[:, 2]),
              f"{kind}: reference engine {ref_fit} vs batched {bat_fit}")
        print(f"  {kind}: reference engine (single-design entry) == batched "
              f"engine at one lane: max |diff| "
              f"{float(np.abs(ref_fit - bat_fit).max()):.3e} (robust column "
              f"bitwise)")
        two_obj = search_out[kind]["generation_s"]
        if gen_s and two_obj:
            ratio = float(np.mean(gen_s) / np.mean(two_obj))
            print(f"  {kind}: steady generation {np.mean(gen_s):.3f} s "
                  f"robust vs {np.mean(two_obj):.3f} s 2-objective "
                  f"(ratio {ratio:.3f}) on {card}; launches per evaluation: "
                  f"{pop_entry} {after_search[pop_entry] / evals:g}, "
                  f"adc_quantize_population "
                  f"{(after_search['adc_quantize_population'] - 2) / evals:g}")
        else:
            ratio = None
        out[kind] = {"launches": launches, "designs": len(designs),
                     "evaluate_robustness_s": t_rep,
                     "generation_s": gen_s, "two_objective_generation_s":
                     two_obj, "ratio_to_two_objective": ratio,
                     "wall_s": wall}

    # one robust evaluation against the 2-objective one of the same shape
    # on the same genomes, in turns (2-objective, robust, robust,
    # 2-objective); then one robust evaluation traced: device busy share
    # and MC device time
    from torch.profiler import ProfilerActivity, profile
    dd = search.device_data(data, dev)
    rng = np.random.default_rng(11)
    for kind, cfg in configs.items():
        g = (rng.random((cfg.pop_size, search.genome_len(
            sizes[0], cfg.bits, cfg.faulttol))) < 0.5).astype(np.uint8)
        draws = search.search_draws(cfg, sizes[0], dev)
        two = search.SearchConfig(model=kind, **SEARCH)
        g2 = g[:, :search.genome_len(sizes[0], two.bits)]
        turns = {"two": [], "robust": []}
        for which in ("two", "robust", "robust", "two"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if which == "two":
                search.evaluate_population(g2, dd, sizes, two)
            else:
                search.evaluate_population(g, dd, sizes, cfg, draws=draws)
            torch.cuda.synchronize()
            turns[which].append(time.perf_counter() - t0)
        paired = min(turns["robust"]) / min(turns["two"])
        out[kind].update({"paired_two_objective_s": turns["two"],
                          "paired_robust_s": turns["robust"],
                          "paired_ratio": paired})
        print(f"  {kind}: one evaluation of the same {cfg.pop_size} genomes,"
              f" in turns: 2-objective {turns['two'][0]:.3f}/"
              f"{turns['two'][1]:.3f} s, robust {turns['robust'][0]:.3f}/"
              f"{turns['robust'][1]:.3f} s (ratio of the faster "
              f"{paired:.3f}) on {card}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            search.evaluate_population(g, dd, sizes, cfg, draws=draws)
            torch.cuda.synchronize()
            traced_wall = time.perf_counter() - t0
        mc_us = other_us = 0.0
        for ev in prof.key_averages():
            if "DeviceType.CUDA" not in str(getattr(ev, "device_type", "")) \
                    or not ev.count:
                continue
            total = getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0))
            if "mc_eval_kernel" in ev.key:
                mc_us += total
            else:
                other_us += total
        busy = (mc_us + other_us) / 1e6 / traced_wall
        out[kind].update({"traced_wall_s": traced_wall,
                          "mc_device_ms": mc_us / 1e3,
                          "other_device_ms": other_us / 1e3,
                          "device_busy_share": busy})
        print(f"  {kind} robust generation traced: wall {traced_wall:.3f} s,"
              f" device time MC kernel {mc_us / 1e3:.3f} ms, everything "
              f"else {other_us / 1e3:.3f} ms, device busy "
              f"{busy * 100:.1f} % on {card}")
    return out


def phase_generation(np, torch, dev, card, data):
    """One generation at SearchConfig defaults (pop 32, 300 QAT steps) per
    model: host clock around a synchronised evaluate_population, then a
    torch.profiler trace of the same call."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import search
    from repro_torch.data import tabular
    spec = tabular.SPECS[DATASET]
    sizes = (spec.features, spec.hidden, spec.classes)
    dd = search.device_data(data, dev)
    rng = np.random.default_rng(7)
    print("phase generation: one generation at SearchConfig defaults")
    out = {}
    for kind in ("mlp", "svm"):
        cfg = search.SearchConfig(bits=4, model=kind)
        g = (rng.random((cfg.pop_size, search.genome_len(sizes[0], 4)))
             < 0.5).astype(np.uint8)
        search.evaluate_population(g[:2], dd, sizes, cfg)     # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            search.evaluate_population(g, dd, sizes, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            search.evaluate_population(g, dd, sizes, cfg)
            torch.cuda.synchronize()
            traced_wall = time.perf_counter() - t0
        quant_us = other_us = 0.0
        launches_traced = 0
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) is None or not ev.count:
                continue
            if "DeviceType.CUDA" not in str(ev.device_type):
                continue
            total = getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0))
            if "adc_quantize_population_kernel" in ev.key:
                quant_us += total
            else:
                other_us += total
                launches_traced += ev.count
        wall = min(walls)
        busy = (quant_us + other_us) / 1e6 / traced_wall
        out[kind] = {"generation_s": walls, "individuals_per_s":
                     cfg.pop_size / wall, "traced_wall_s": traced_wall,
                     "quantizer_device_ms": quant_us / 1e3,
                     "other_device_ms": other_us / 1e3,
                     "other_device_ops": launches_traced,
                     "device_busy_share": busy}
        print(f"  {kind} pop={cfg.pop_size} steps={cfg.train_steps}: "
              f"{walls[0]:.3f}/{walls[1]:.3f} s per generation "
              f"({cfg.pop_size / wall:.1f} individuals/s) on {card}; "
              f"traced: wall {traced_wall:.3f} s, device time quantizer "
              f"{quant_us / 1e3:.3f} ms, everything else "
              f"{other_us / 1e3:.3f} ms over {launches_traced} device "
              f"operations, device busy {busy * 100:.1f} %")
    return out



@contextlib.contextmanager
def qat_chunks(search):
    """Counts the fixed-lane QAT chunks (``search._train_and_score``
    calls, each one train and one test quantizer launch) run inside."""
    orig = search._train_and_score
    count = [0]

    def counted(*args, **kw):
        count[0] += 1
        return orig(*args, **kw)

    search._train_and_score = counted
    try:
        yield count
    finally:
        search._train_and_score = orig


@contextlib.contextmanager
def gradient_record(torch, search, grad_gates):
    """Records, inside, what the gradient engine ran, from its own
    returns: the gate train's ``diag`` and its end, and the genome count
    and end of every exact evaluation (``search.evaluate_population``:
    the pool's re-score first, then one call a polish round). Times are
    seconds from entry, the card synchronized."""
    rec = {"t0": time.perf_counter(), "diag": None, "gate_end": None,
           "evals": []}
    train, evaluate = (grad_gates.train_gate_family,
                       search.evaluate_population)

    def trained(*args, **kw):
        snaps, diag = train(*args, **kw)
        torch.cuda.synchronize()
        rec["diag"], rec["gate_end"] = diag, time.perf_counter() - rec["t0"]
        return snaps, diag

    def evaluated(genomes, *args, **kw):
        fit = evaluate(genomes, *args, **kw)
        torch.cuda.synchronize()
        rec["evals"].append((len(genomes), time.perf_counter() - rec["t0"]))
        return fit

    grad_gates.train_gate_family = trained
    search.evaluate_population = evaluated
    try:
        yield rec
    finally:
        grad_gates.train_gate_family = train
        search.evaluate_population = evaluate


class Killed(RuntimeError):
    pass


def killing_save(ckpt, after_step: int):
    """Make ``ckpt.save`` raise once it has saved ``after_step``: a run
    killed there, with its checkpoint on disk."""
    orig = ckpt.save

    def save(step, tree):
        orig(step, tree)
        if step == after_step:
            ckpt.save = orig
            raise Killed()

    ckpt.save = save


def phase_baseline(np, torch, dev, card, data):
    """The Table 5 baseline: the full ADC at dp = -3 with QAT, and the
    three full-design areas, for the MLP and the SVM."""
    from repro_torch.core import area, search
    from repro_torch.data import tabular
    spec = tabular.SPECS[DATASET]
    sizes = (spec.features, spec.hidden, spec.classes)
    c, bits = sizes[0], SEARCH["bits"]
    print(f"phase baseline: full_adc_baseline (the paper's Table 5 "
          f"'Baseline' column) on cuda, cardio sizes={sizes}, {SEARCH}")
    out = {}
    for kind in ("mlp", "svm"):
        cfg = search.SearchConfig(model=kind, **SEARCH)
        reset_all_launches()
        with qat_chunks(search) as chunks:
            t0 = time.perf_counter()
            row = search.full_adc_baseline(data, sizes, cfg, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = all_launches()
        print(f"  Table 5 baseline {kind}: accuracy {row['accuracy']!r}, "
              f"flash {row['area_flash_tc']} T, binary "
              f"{row['area_binary_baseline_tc']} T, ours "
              f"{row['area_binary_ours_tc']} T; {wall:.3f} s on {card}")
        want = {"area_flash_tc": c * area.flash_full_tc(bits),
                "area_binary_baseline_tc": c * area.baseline_binary_tc(bits),
                "area_binary_ours_tc": c * area.ours_full_tc(bits)}
        for key, value in want.items():
            check(row[key] == value, f"{kind}: baseline {key} {row[key]} != "
                                     f"{c} x its full-design area {value}")
        genome = np.ones((1, search.genome_len(c, bits)), np.uint8)
        genome[0, c * 2 ** bits:c * 2 ** bits + search.DP_BITS] = [1, 0, 1, 0]
        acc = search.evaluate_population_acc(genome, data, sizes, cfg,
                                             device=dev)
        check(row["accuracy"] == 1.0 - float(np.float32(1.0) - acc[0]),
              f"{kind}: baseline accuracy {row['accuracy']!r} is not "
              f"evaluate_population_acc's {acc[0]!r} of the same genome")
        check(launches["adc_quantize_population"] == 2 * chunks[0] == 2,
              f"{kind}: adc_quantize_population launched "
              f"{launches['adc_quantize_population']} times for "
              f"{chunks[0]} QAT chunk(s), expected 2")
        out[kind] = dict(row, wall_s=wall, launches=launches)
    return out


def phase_resume(np, torch, dev, card, data):
    """A search killed after generation 1 and resumed equals the
    uninterrupted one bitwise, plain and surrogate-screened."""
    import dataclasses
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import search
    from repro_torch.data import tabular
    spec = tabular.SPECS[DATASET]
    sizes = (spec.features, spec.hidden, spec.classes)
    print(f"phase resume: run_search(ckpt=...) killed after generation 1 "
          f"and resumed, against the uninterrupted run, on cuda, MLP, "
          f"{SEARCH}")
    out = {}
    reset_all_launches()
    with qat_chunks(search) as chunks, \
            tempfile.TemporaryDirectory() as tmp:
        for screen in (1, 2):
            cfg = dataclasses.replace(
                search.SearchConfig(model="mlp", **SEARCH),
                screen_factor=screen)
            name = "screened" if screen > 1 else "plain"
            whole = CheckpointManager(Path(tmp) / f"{name}_whole", keep=2)
            t0 = time.perf_counter()
            pg, pf, _ = search.run_search(data, sizes, cfg, ckpt=whole,
                                          device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            parted = CheckpointManager(Path(tmp) / f"{name}_parted", keep=2)
            killing_save(parted, 1)
            try:
                search.run_search(data, sizes, cfg, ckpt=parted, device=dev)
                check(False, f"{name}: the killed run was not killed")
            except Killed:
                pass
            check(parted.latest_step() == 1,
                  f"{name}: the killed run left step "
                  f"{parted.latest_step()}, expected 1")
            rg, rf, _ = search.run_search(data, sizes, cfg, ckpt=parted,
                                          resume=True, device=dev)
            last = SEARCH["generations"]
            a, b = whole.restore_flat(last), parted.restore_flat(last)
            check(sorted(a) == sorted(b) and all(
                np.array_equal(a[k], b[k]) for k in a),
                  f"{name}: the resumed run's final state (population, "
                  f"fitness, Generator, surrogate) differs from the "
                  f"uninterrupted run's")
            check(np.array_equal(rg, pg) and np.array_equal(rf, pf),
                  f"{name}: the resumed front differs from the "
                  f"uninterrupted one")
            row = {"wall_s": wall, "front": len(pf),
                   "state_leaves": len(a)}
            if screen > 1:
                accs = search.train_pareto_front(pg, data, sizes, cfg,
                                                 device=dev)[0]
                refit = (1.0 - accs.astype(np.float32)).astype(np.float64)
                check(np.array_equal(refit, pf[:, 0]),
                      f"screened: the front re-trains to {accs}, not its "
                      f"fitness {1 - pf[:, 0]}")
            print(f"  {name}: {len(pf)} front points; killed after "
                  f"generation 1, resumed to {last}: population, fitness, "
                  f"Generator and {len(a) - 4} surrogate leaves equal "
                  f"bitwise; uninterrupted run {wall:.2f} s on {card}")
            out[name] = row
        launches = all_launches()
    check(launches["adc_quantize_population"] == 2 * chunks[0],
          f"resume: adc_quantize_population launched "
          f"{launches['adc_quantize_population']} times for {chunks[0]} "
          f"QAT chunks")
    print(f"  resume: {chunks[0]} QAT chunks, launch counters {launches}")
    out["launches"] = launches
    out["qat_chunks"] = chunks[0]
    return out


def phase_gradient(np, torch, dev, card, data):
    """The gradient engine: gate train -> exact re-score -> polish ->
    front -> export -> verify -> save -> load -> serve, for the MLP and
    (cut) the SVM; the MLP's gate train killed after chunk 1 and resumed;
    one chunk traced."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import deploy, grad_gates, search
    from repro_torch.data import tabular
    from repro_torch.launch.serve_classifier import (make_request_stream,
                                                     serve)
    spec = tabular.SPECS[DATASET]
    sizes = (spec.features, spec.hidden, spec.classes)
    requests = make_request_stream(data["x_test"], 256, 8)
    print(f"phase gradient: run_gradient_search -> export_front -> "
          f"verify_front_parity -> save_front -> load_front -> serve on "
          f"cuda, cardio sizes={sizes}, {SEARCH}")
    for kind, cut in GRADIENT_CUTS.items():
        print(f"  cut: the {kind.upper()} runs with {cut} (the reference's "
              f"defaults: 64 lanes, 800 gate-train steps in 4 chunks, 2 "
              f"polish rounds of at most 192 exact evaluations)")
    out = {}
    reset_all_launches()
    with qat_chunks(search) as chunks, tempfile.TemporaryDirectory() as tmp:
        for kind in ("mlp", "svm"):
            cfg = search.SearchConfig(model=kind, engine="gradient",
                                      **SEARCH, **GRADIENT_CUTS[kind])
            ckpt = CheckpointManager(Path(tmp) / f"{kind}_gate", keep=2)
            first = chunks[0]
            with gradient_record(torch, search, grad_gates) as rec:
                pg, pf, _, trained = search.run_gradient_search(
                    data, sizes, cfg, ckpt=ckpt, return_trained=True,
                    progress=lambda msg: print(f"  {kind}: {msg}",
                                               flush=True), device=dev)
                torch.cuda.synchronize()
                total = time.perf_counter() - rec["t0"]
            designs = deploy.export_front(pg, data, sizes, cfg,
                                          trained=trained, device=dev)
            parity = deploy.verify_front_parity(designs, pg, data, sizes,
                                                cfg, device=dev)
            with tempfile.TemporaryDirectory() as fdir:
                deploy.save_front(fdir, designs, extra_meta={
                    "dataset": DATASET, "sizes": list(sizes)})
                loaded = deploy.load_front(fdir)
            rep = serve(loaded, requests, 1024, device=dev)
            served = deploy.served_accuracies(loaded, data["x_test"],
                                              data["y_test"], device=dev)
            exported = np.array([d.accuracy for d in designs])
            check(parity, f"gradient {kind}: verify_front_parity is False")
            refit = (1.0 - trained[0].astype(np.float32)).astype(np.float64)
            check(np.array_equal(refit, pf[:, 0]),
                  f"gradient {kind}: the front re-trains to {trained[0]}, "
                  f"not its fitness {1 - pf[:, 0]}")
            check(np.array_equal(served, exported),
                  f"gradient {kind}: served accuracies {served} != "
                  f"exported {exported}")
            diag, gate_s = rec["diag"], rec["gate_end"]
            (pool, t_rescore), polish_runs = rec["evals"][0], rec["evals"][1:]
            polish = [n for n, _ in polish_runs]
            row = {"lanes": diag["lanes"], "gate_steps": diag["steps"],
                   "gate_chunks": diag["chunks"],
                   "gate_train_s": gate_s,
                   "gate_s_per_step": gate_s / diag["steps"],
                   "pool": pool, "polish_evals": polish,
                   "exact_evals": pool + sum(polish),
                   "rescore_s": t_rescore - gate_s,
                   "polish_s": (polish_runs[-1][1] - t_rescore
                                if polish else 0.0),
                   "total_s": total, "front": len(pf),
                   "qat_chunks": chunks[0] - first,
                   "served": served.tolist()}
            for i, d in enumerate(designs):
                print(f"  gradient {kind} design {i}: area={d.area_tc}T "
                      f"dp={int(d.dp)} exported={d.accuracy!r} "
                      f"served={float(served[i])!r}")
            print(f"  gradient {kind}: {row['lanes']} lanes, "
                  f"{row['gate_steps']} gate-train steps "
                  f"{row['gate_s_per_step'] * 1e3:.2f} ms/step "
                  f"({row['gate_train_s']:.2f} s); pool {pool} genomes, "
                  f"{row['exact_evals']} exact evaluations in "
                  f"{row['qat_chunks']} QAT chunks; re-score "
                  f"{row['rescore_s']:.2f} s, polish {row['polish_s']:.2f} "
                  f"s, total {total:.2f} s; verify_front_parity={parity} "
                  f"on {card}")
            if kind == "mlp":
                row.update(gate_resume_traced(np, torch, card, data, sizes,
                                              cfg, diag, ckpt,
                                              Path(tmp) / "mlp_parted", dev))
                row["gate_backward_bitwise"] = gate_backward_repeats(
                    torch, dev, data, sizes, cfg, diag["lanes"])
            out[kind] = row
        launches = all_launches()
    check(launches["adc_quantize_population"] == 2 * chunks[0],
          f"gradient: adc_quantize_population launched "
          f"{launches['adc_quantize_population']} times for {chunks[0]} "
          f"QAT chunks (2 per chunk)")
    for kind in ("mlp", "svm"):
        check(launches[f"qmlp_{kind}_bank"] > 0,
              f"gradient: qmlp_{kind}_bank never launched")
    print(f"  gradient: {chunks[0]} QAT chunks; launches of row 2 "
          f"(adc_quantize_population) {launches['adc_quantize_population']}"
          f", of the banks {launches['qmlp_mlp_bank']} / "
          f"{launches['qmlp_svm_bank']} on {card}")
    out["launches"] = launches
    out["qat_chunks"] = chunks[0]
    return out


def gate_backward_repeats(torch, dev, data, sizes, cfg, lanes, runs=5):
    """The gate train's backward (``grad_gates.lane_losses``, its table
    lookup a one-hot product: tools/lookup_backward_ab.py holds it
    against a gather) taken ``runs`` times on the same inputs from the
    seeded start: the gradients must be bitwise the same every time, or
    a resumed gate train could not repeat the uninterrupted one."""
    from repro_torch.core import grad_gates
    state = grad_gates.init_lanes(sizes, cfg, lanes, dev)
    onehot, target, values = grad_gates.train_inputs(data, sizes, cfg, dev)
    lams = torch.from_numpy(grad_gates.lambda_sweep(cfg, lanes)).to(dev)
    tau = grad_gates.tau_schedule(cfg, 2)[0].to(dev)
    trained = state.leaves()[1:]                # dp gets no gradient
    for t in trained:
        t.requires_grad_(True)

    def grads():
        loss = grad_gates.lane_losses(state, lams, tau, onehot, target,
                                      values, cfg).sum()
        return torch.autograd.grad(loss, trained)

    first = grads()
    same = all(all(torch.equal(a, b) for a, b in zip(first, grads()))
               for _ in range(runs - 1))
    check(same, "the gate train's backward differs between runs on the "
                "same inputs")
    print(f"  gradient mlp: the gate train's backward, {runs} runs on the "
          f"same inputs: bitwise equal {same}")
    return same


def gate_resume_traced(np, torch, card, data, sizes, cfg, diag, whole,
                       directory, dev):
    """The gate train killed after chunk 1 (its first chunk traced with
    torch.profiler: device time and operations, the device's busy share
    of the chunk's wall time) and resumed: its snapshot genomes must be
    the uninterrupted run's (``whole``'s last step) bitwise."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import grad_gates
    snaps = whole.restore_flat(whole.latest_step())["snap_genomes"]
    parted = CheckpointManager(directory, keep=2)
    killing_save(parted, 1)
    lanes = diag["lanes"]
    steps = int(grad_gates._chunk_bounds(diag["steps"], diag["chunks"])[1])
    # device activity only: a host trace of the chunk's ~0.5 M operator
    # events costs more to record and to reduce than the chunk itself
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        try:
            grad_gates.train_gate_family(data, sizes, cfg, lanes=lanes,
                                         ckpt=parted, device=dev)
            check(False, "the killed gate train was not killed")
        except Killed:
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    again, _ = grad_gates.train_gate_family(data, sizes, cfg, lanes=lanes,
                                            ckpt=parted, resume=True,
                                            device=dev)
    check(np.array_equal(again, snaps),
          "the gate train resumed after chunk 1 gives other snapshot "
          "genomes than the uninterrupted one")
    print(f"  gradient mlp: gate train killed after chunk 1 and resumed: "
          f"{len(again)} snapshot genomes equal bitwise")
    dev_us, ops = 0.0, 0
    for ev in prof.events():
        if "DeviceType.CUDA" in str(getattr(ev, "device_type", "")):
            dev_us += ev.time_range.elapsed_us()
            ops += 1
    check(dev_us > 0, "torch.profiler recorded no device time for the "
                      "gate-train chunk")
    busy = dev_us / 1e6 / wall
    print(f"  gradient mlp: the killed run's one chunk of {steps} steps, "
          f"traced: wall {wall:.3f} s ({wall / steps * 1e3:.2f} ms/step, "
          f"with the operands' set-up and the save), device "
          f"{dev_us / 1e3:.2f} ms over {ops} device operations "
          f"({ops / steps:.0f} a step), device busy {busy * 100:.1f} % on "
          f"{card}")
    return {"traced_steps": steps, "traced_wall_s": wall,
            "traced_device_ms": dev_us / 1e3, "traced_device_ops": ops,
            "device_busy_share": busy}


def flash_bound(torch, q, k, qpos, kpos, *, causal, window, clock):
    """(bound_ms, bound_by, bytes, flops, floors) of one attention call,
    the largest of three times: q, k, v and positions read once and the
    output written once, against HBM; 2 flops per multiply-add of q.k and
    of p.v over the (query, key) pairs these positions leave unmasked,
    against the peak of the inputs' type (bf16 tensor cores, or float32
    outside them); one exponential per such pair on the special-function
    units, EX2_PER_SM_PER_CLOCK a clock on each SM at ``clock`` (Hz,
    source, SM count). ``floors`` names each time."""
    qp = qpos.long()[:, None]
    kp = kpos.long()[None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (qp - kp >= 0)
    if window:
        ok = ok & (qp - kp < window)
    pairs = int(ok.sum())
    b, _, h, dh = q.shape
    flops = 4 * b * h * dh * pairs
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + 4 * (qpos.numel() + kpos.numel())
    rate = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
    hz, _, sms = clock
    floors = {"hbm": nbytes / HBM_BYTES_PER_S * 1e3,
              "tensor_cores" if q.dtype == torch.bfloat16 else "cuda_cores":
                  flops / rate * 1e3,
              "ex2": b * h * pairs / (sms * EX2_PER_SM_PER_CLOCK * hz) * 1e3}
    unit = max(floors, key=floors.get)
    return (floors[unit], "bytes" if unit == "hbm" else "operations",
            nbytes, flops, dict(floors, binding=unit))


def flash_inputs(torch, gen, dev, b, s, sk, h, kv, dh, dt):
    """q, k ~ N(0, FLASH_QK_STD^2) and v ~ N(1, 1), in dt: the scores'
    standard deviation is FLASH_QK_STD^2 at any dh, so the softmax is
    peaked (a few keys carry each row) and the outputs are O(1), where a
    wrong key, tile or head moves them by O(1)."""
    q = torch.randn((b, s, h, dh), generator=gen, device=dev) * FLASH_QK_STD
    k = torch.randn((b, sk, kv, dh), generator=gen, device=dev) \
        * FLASH_QK_STD
    v = torch.randn((b, sk, kv, dh), generator=gen, device=dev) + 1.0
    return q.to(dt), k.to(dt), v.to(dt)


def limit_share(got, want, tol) -> float:
    """Largest |got - want| / (atol + rtol |want|): the share of the
    allclose limit used (above 1 fails)."""
    w = want.float()
    return float(((got.float() - w).abs()
                  / (tol["atol"] + tol["rtol"] * w.abs())).max())


def flash_controls(torch, ref, made) -> None:
    """The bf16 tolerance must reject the faults a kernel could make:
    the plain version with one kv tile of 64 keys dropped (keys 1024..1087
    masked), and with each query head reading the wrong kv head (the next
    head for musicgen's H = KV; h % KV in place of h // (H / KV) under
    gemma2's GQA), against the sound plain version. p left unrounded
    before P.V (the plain version on float32 copies, rounded to bf16 at
    the end) is printed: a rounding the limit is not meant to see."""
    def rejected(label, bad, want, strict=True):
        tol = FLASH_BF16_TOL
        err = float((bad.float() - want.float()).abs().max())
        fails = not torch.allclose(bad.float(), want.float(), **tol)
        print(f"  control {label}: max_abs_err {err:.3e} "
              f"({limit_share(bad, want, tol):.2f} of the limit): "
              f"{'rejected' if fails else 'not rejected'}")
        if strict:
            check(fails, f"the bf16 tolerance does not reject {label} "
                         f"({err:.3e})")

    for label in ("musicgen prefill B=4 S=2048 H=KV=24 dh=64",
                  "gemma2 widths H=8 KV=4 dh=256 win=1024 cap=50 S=4096"):
        q, k, v, qpos, kpos, kw = made[label]
        want = ref.flash_attention_ref(q, k, v, qpos, kpos, **kw)
        short = label.split()[0]
        drop = kpos.clone()
        drop[1024:1088] = -1
        rejected(f"{short}, one kv tile dropped",
                 ref.flash_attention_ref(q, k, v, qpos, drop, **kw), want)
        h, kvh = q.shape[2], k.shape[2]
        if h == kvh:
            heads = (torch.arange(h, device=q.device) + 1) % kvh
        else:
            heads = torch.arange(h, device=q.device) % kvh
        kw_, vw_ = k[:, :, heads].contiguous(), v[:, :, heads].contiguous()
        rejected(f"{short}, wrong kv head",
                 ref.flash_attention_ref(q, kw_, vw_, qpos, kpos, **kw), want)
        unrounded = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                            qpos, kpos, **kw).to(q.dtype)
        rejected(f"{short}, p unrounded", unrounded, want, strict=False)
        del want, kw_, vw_, unrounded


def timed_ms(torch, fn, reps, warmup=3) -> float:
    """Mean time per call over ``reps`` back-to-back calls, CUDA events,
    after ``warmup`` calls (the attention calls are long: few reps)."""
    for _ in range(warmup):
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


def phase_flash_kernels(np, torch, dev, card, clock):
    """The flash-attention kernels against their plain version on the
    card: the JAX package's four test shapes (f32), musicgen-medium's
    prefill (bf16 and f32), gemma2's widths with GQA, a window and a
    softcap (bf16), phi3's, kimi's and llama4's head widths (bf16, GQA,
    ragged S, one with a window), ragged S, empty key slots, fully masked
    rows and a bf16 width off the tensor-core list; each call on the route
    dispatch names, counted on that route's key. Then times at the
    musicgen (bf16: tensor cores; f32: CUDA cores), gemma2 and ragged
    shapes beside the bound and, for the causal cases,
    scaled_dot_product_attention (the yardstick only)."""
    import torch.nn.functional as F
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    f32, bf16 = torch.float32, torch.bfloat16

    def arange(n, start=0):
        return torch.arange(start, start + n, dtype=torch.int32, device=dev)

    # label: (B, S, Sk, H, KV, dh, window, softcap, dtype, qpos, kpos)
    cases = {}
    for b, s, h, kv, dh, win, cap in ((1, 64, 4, 2, 16, 0, 0.0),
                                      (2, 128, 4, 4, 32, 0, 30.0),
                                      (1, 128, 8, 2, 16, 48, 0.0),
                                      (1, 96, 2, 1, 8, 0, 0.0)):
        cases[f"jax test B={b} S={s} H={h} KV={kv} dh={dh} win={win} "
              f"cap={cap}"] = (b, s, s, h, kv, dh, win, cap, f32,
                               arange(s), arange(s))
    cases["musicgen prefill B=4 S=2048 H=KV=24 dh=64"] = (
        4, 2048, 2048, 24, 24, 64, 0, 0.0, bf16, arange(2048), arange(2048))
    cases["gemma2 widths H=8 KV=4 dh=256 win=1024 cap=50 S=4096"] = (
        1, 4096, 4096, 8, 4, 256, 1024, 50.0, bf16, arange(4096),
        arange(4096))
    cases["ragged S=Sk=2049 (musicgen widths)"] = (
        4, 2049, 2049, 24, 24, 64, 0, 0.0, bf16, arange(2049), arange(2049))
    cases["phi3 widths H=KV=32 dh=96 S=1030"] = (
        1, 1030, 1030, 32, 32, 96, 0, 0.0, bf16, arange(1030), arange(1030))
    cases["kimi widths H=64 KV=8 dh=112 win=512 S=1500"] = (
        1, 1500, 1500, 64, 8, 112, 512, 0.0, bf16, arange(1500),
        arange(1500))
    cases["llama4 widths H=40 KV=8 dh=128 S=2047"] = (
        1, 2047, 2047, 40, 8, 128, 0, 0.0, bf16, arange(2047), arange(2047))
    kp = arange(300)
    kp[::5] = -1
    cases["k_positions with -1 (every 5th) f32"] = (
        2, 300, 300, 8, 2, 64, 0, 0.0, f32, arange(300), kp)
    cases["k_positions with -1, ragged, bf16"] = (
        2, 300, 300, 8, 2, 64, 100, 0.0, bf16, arange(300), kp)
    cases["fully masked rows 0..99 (keys at 100..) f32"] = (
        2, 256, 256, 4, 4, 64, 0, 0.0, f32, arange(256), arange(256, 100))
    cases["bf16 off the tensor-core widths dh=32"] = (
        2, 200, 200, 4, 2, 32, 0, 0.0, bf16, arange(200), arange(200))

    cases["musicgen prefill B=4 S=2048 H=KV=24 dh=64 f32"] = (
        4, 2048, 2048, 24, 24, 64, 0, 0.0, f32, arange(2048), arange(2048))
    # the configs' widths in float32, on the CUDA-core route
    cases["gemma2 widths H=8 KV=4 dh=256 win=1024 cap=50 S=4096 f32"] = (
        1, 4096, 4096, 8, 4, 256, 1024, 50.0, f32, arange(4096),
        arange(4096))
    cases["phi3 widths H=KV=32 dh=96 S=1030 f32"] = (
        1, 1030, 1030, 32, 32, 96, 0, 0.0, f32, arange(1030), arange(1030))
    cases["llama4 widths H=40 KV=8 dh=128 S=2047 f32"] = (
        1, 2047, 2047, 40, 8, 128, 0, 0.0, f32, arange(2047), arange(2047))
    cases["ragged S=Sk=2049 (musicgen widths) f32"] = (
        4, 2049, 2049, 24, 24, 64, 0, 0.0, f32, arange(2049), arange(2049))

    from repro_torch.kernels import envelope
    for dh in envelope.FLASH_TC_HEAD_DIMS:
        check(fa.tc_smem_bytes(dh) == envelope.flash_tc_smem_bytes(dh),
              f"dh={dh}: the kernel asks for {fa.tc_smem_bytes(dh)} bytes of "
              f"shared memory, the envelope says "
              f"{envelope.flash_tc_smem_bytes(dh)}")
    for dh in (8, 32, 64, 96, 128, 160, 256):
        check(fa.smem_bytes(dh) == envelope.flash_smem_bytes(dh),
              f"dh={dh}: the CUDA-core kernel asks for {fa.smem_bytes(dh)} "
              f"bytes of shared memory, the envelope says "
              f"{envelope.flash_smem_bytes(dh)}")
    print(f"phase flash kernels: flash_attention_tc (tensor cores) and "
          f"flash_attention (CUDA cores) vs the plain version on the card "
          f"({card}); q, k ~ N(0, {FLASH_QK_STD}^2), v ~ N(1, 1)")
    made, max_err, routes = {}, {key: 0.0 for key in FLASH_DEVICE_NAMES}, {}
    for label, (b, s, sk, h, kv, dh, win, cap, dt, qpos, kpos) in \
            cases.items():
        q, k, v = flash_inputs(torch, gen, dev, b, s, sk, h, kv, dh, dt)
        kw = dict(causal=True, window=win, attn_softcap=cap)
        route = dispatch.resolve_flash(fa.ENTRY, q).route
        key = fa.TC_ENTRY if route == "tensor_core" else fa.ENTRY
        want_route = ("tensor_core" if dt == bf16
                      and dh in envelope.FLASH_TC_HEAD_DIMS else "cuda_core")
        check(route == want_route, f"flash {label}: route {route}, "
                                   f"expected {want_route}")
        before = dict(fa.launches)
        got = fa.flash_attention(q, k, v, qpos, kpos, **kw)
        want = ref.flash_attention_ref(q, k, v, qpos, kpos, **kw)
        torch.cuda.synchronize()
        check(fa.launches == dict(before, **{key: before[key] + 1}),
              f"flash {label}: launches {before} -> {fa.launches}, "
              f"expected one on {key}")
        tol = FLASH_F32_TOL if dt == f32 else FLASH_BF16_TOL
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"flash {label}: {tuple(got.shape)} {got.dtype} != "
              f"{tuple(want.shape)} {want.dtype}")
        check(bool(torch.isfinite(got).all()), f"flash {label}: non-finite")
        err = float((got.float() - want.float()).abs().max())
        ok = torch.allclose(got.float(), want.float(), **tol)
        if "fully masked" in label:
            ok = ok and bool((got[:, :100] == 0).all()) and bool(
                (want[:, :100] == 0).all())
        max_err[key] = max(max_err[key], err)
        seen = want.float()[want.float() != 0].abs()
        print(f"  {key:18s} {label:52s} {str(dt)[6:]:8s} "
              f"max_abs_err={err:.3e} [rtol={tol['rtol']:g}, "
              f"atol={tol['atol']:g}; {limit_share(got, want, tol):.3f} of "
              f"the limit] |out| median "
              f"{float(seen.median()):.3f} {'ok' if ok else 'MISMATCH'}")
        check(ok, f"{key} disagrees with its plain version on "
                  f"{label} (max_abs_err {err:.3e})")
        made[label] = (q, k, v, qpos, kpos, kw)
        routes[label] = key
        del got, want
    flash_controls(torch, ref, made)

    hz, hz_src, sms = clock
    print(f"  ex2 floor: {sms} SMs x {EX2_PER_SM_PER_CLOCK} a clock x "
          f"{hz / 1e6:.0f} MHz ({hz_src})")
    timings = {}
    for label in ("musicgen prefill B=4 S=2048 H=KV=24 dh=64",
                  "gemma2 widths H=8 KV=4 dh=256 win=1024 cap=50 S=4096",
                  "ragged S=Sk=2049 (musicgen widths)",
                  "llama4 widths H=40 KV=8 dh=128 S=2047",
                  "musicgen prefill B=4 S=2048 H=KV=24 dh=64 f32",
                  "gemma2 widths H=8 KV=4 dh=256 win=1024 cap=50 S=4096 f32",
                  "llama4 widths H=40 KV=8 dh=128 S=2047 f32"):
        q, k, v, qpos, kpos, kw = made[label]
        key = routes[label]
        k_fn = lambda: fa.flash_attention(q, k, v, qpos, kpos, **kw)  # noqa
        p_fn = lambda: ref.flash_attention_ref(q, k, v, qpos,  # noqa: E731
                                               kpos, **kw)
        lib_ms = lib_err = lib_kernel = None
        if not kw["window"] and not kw["attn_softcap"]:
            rep = q.shape[2] // k.shape[2]
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            l_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=rep > 1)
            lib_out = l_fn().transpose(1, 2)
            lib_err = float((lib_out.float() - p_fn().float()).abs().max())
            check(lib_err < 5e-2, f"{label}: scaled_dot_product_attention "
                                  f"is not the same function ({lib_err})")
            lib_kernel = top_device_kernel(torch, l_fn)
        # plain, kernel, kernel, plain (library between): one card, turns
        p1 = timed_ms(torch, p_fn, 3, warmup=1)
        k1 = timed_ms(torch, k_fn, 20)
        if lib_err is not None:
            lib_ms = min(timed_ms(torch, l_fn, 20), timed_ms(torch, l_fn, 20))
        k2 = timed_ms(torch, k_fn, 20)
        p2 = timed_ms(torch, p_fn, 3, warmup=1)
        dev_ms = device_kernel_ms(torch, k_fn, FLASH_DEVICE_NAMES[key],
                                  reps=10)
        b_ms, b_by, nbytes, flops, floors = flash_bound(
            torch, q, k, qpos, kpos, causal=True, window=kw["window"],
            clock=clock)
        b, s, h, dh = q.shape
        row = {"kernel": key,
               "shape": {"B": b, "S": s, "Sk": k.shape[1], "H": h,
                         "KV": k.shape[2], "dh": dh, "window": kw["window"],
                         "softcap": kw["attn_softcap"],
                         "dtype": str(q.dtype)[6:]},
               "ms": min(k1, k2), "plain_ms": min(p1, p2),
               "device_ms": dev_ms, "library_ms": lib_ms,
               "library_kernel": lib_kernel,
               "library_max_abs_err": lib_err, "bound_ms": b_ms,
               "bound_by": b_by, "floors_ms": floors, "bytes": nbytes,
               "flops": flops,
               "tflop_per_s": flops / (min(k1, k2) * 1e-3) / 1e12}
        timings[label] = row
        dev_txt = ("not measured" if dev_ms is None else f"{dev_ms:.4f} ms")
        lib_txt = ("n/a" if lib_ms is None
                   else f"{lib_ms:.4f} ms (device kernel {lib_kernel})")
        print(f"  time {key} {label}: kernel {k1:.4f}/{k2:.4f} ms per call "
              f"(profiler device time {dev_txt}; "
              f"{row['tflop_per_s']:.2f} TFLOP/s), plain {p1:.3f}/{p2:.3f} "
              f"ms, scaled_dot_product_attention {lib_txt}, bound "
              f"{b_ms:.4f} ms ({floors['binding']}; hbm "
              f"{floors['hbm']:.4f}, ex2 {floors['ex2']:.4f} ms) on {card}")
    return max_err, timings


def timed_prefill(torch, fn):
    """Two warm runs of ``fn`` (a prefill), the host clock around a
    synchronised call, then one traced with torch.profiler: (walls,
    traced wall, flash device us, flash launches, other device us, other
    device operations)."""
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    flash_us = other_us = 0.0
    flash_n = other_n = 0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) is None or not ev.count:
            continue
        if "DeviceType.CUDA" not in str(ev.device_type):
            continue
        total = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
        if any(n in ev.key for n in FLASH_DEVICE_NAMES.values()):
            flash_us += total
            flash_n += ev.count
        else:
            other_us += total
            other_n += ev.count
    return walls, traced_wall, flash_us, flash_n, other_us, other_n


@contextlib.contextmanager
def plain_attention(torch):
    """models.layers.attention through the kernel's plain version in
    place of the kernel, for a witness (never on the main path)."""
    from repro_torch.kernels import ops, ref
    kernel = ops.flash_attention
    ops.flash_attention = ref.flash_attention_ref
    try:
        yield
    finally:
        ops.flash_attention = kernel


def phase_lm(np, torch, dev, card):
    """The LM serving path: musicgen-medium at its full published config
    through repro_torch.launch.serve (4 requests, prompt 2048, 16 steps),
    the launch counters at 0; then prefill == forward, decode == teacher
    forcing over a ragged 2049-long sequence, a warm prefill and a traced
    one (device busy share)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import serving, transformer
    cfg = get_config(LM["arch"])
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size)
          == (48, 1536, 24, 24, 64, 6144, 2048)
          and cfg.dtype == "bfloat16",
          f"{cfg.name} is not at its published widths")
    b, s, n_gen = LM["requests"], LM["prompt_len"], LM["gen"]
    print(f"phase lm: {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads, dh "
          f"{cfg.resolved_head_dim}, "
          f"{cfg.param_counts()['total'] / 1e9:.3f} B parameters, "
          f"{cfg.dtype} activations) through repro_torch.launch.serve on "
          f"cuda ({card})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    gen, info = serve.main(["--arch", LM["arch"], "--requests", str(b),
                            "--prompt-len", str(s), "--gen", str(n_gen),
                            "--device", "cuda", "--seed", "0"])
    wall = time.perf_counter() - t0
    launches = all_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  launch counters after the main path: {launches}")
    check(launches["flash_attention_tc"] == cfg.num_layers
          and launches["flash_attention"] == 0,
          f"flash kernels launched {launches['flash_attention_tc']} times "
          f"on the tensor-core route and {launches['flash_attention']} on "
          f"the CUDA-core route in the main path, expected "
          f"{cfg.num_layers} (one per layer of the prefill) and 0")
    check(info["prefill_flash_launches"] == cfg.num_layers
          and info["decode_flash_launches"] == 0,
          f"launches by phase: prefill {info['prefill_flash_launches']}, "
          f"decode {info['decode_flash_launches']}")
    check(gen.shape == (b, n_gen), f"generated {gen.shape}")
    check(len(info["logits"]) == n_gen + 1 and all(
        lg.shape == (b, cfg.vocab_size) and np.isfinite(lg).all()
        for lg in info["logits"]), "logits not finite or misshapen")
    print(f"  serve.main: {b} x {s} prefill in {info['prefill_s']:.3f} s "
          f"({info['prefill_tokens_per_s']:.0f} tokens/s, first call), "
          f"{n_gen} decode steps in {info['decode_s']:.3f} s "
          f"({info['decode_ms_per_token']:.2f} ms/token), whole call "
          f"{wall:.2f} s (init included), peak {peak_gb:.2f} GB on {card}")

    # the same weights (the port's seeded init) for the checks
    params = transformer.init_params(cfg, seed=0, device=dev)
    batch = serve.make_batch(cfg, b, s, rng=np.random.default_rng(0),
                             device=dev)
    pre, _ = serving.prefill(params, batch, cfg)
    full = transformer.logits_fn(params, batch, cfg)[:, -1]
    err_c = float((pre - full).abs().max())
    same = float(np.abs(pre.cpu().numpy() - info["logits"][0]).max())
    print(f"  (c) prefill last-position logits vs logits_fn: max_abs_err "
          f"{err_c:.3e} [rtol=atol=2e-2]; vs serve.main's prefill "
          f"{same:.3e}")
    check(torch.allclose(pre, full, rtol=2e-2, atol=2e-2),
          f"prefill != forward at full width ({err_c:.3e})")
    check(same <= 2e-2, f"re-initialised weights differ from the "
                         f"launcher's ({same:.3e})")
    ext = serve.make_batch(cfg, b, s + 1, rng=np.random.default_rng(1),
                           device=dev)
    head = {k: (t if k == "adc_mask" else t[:, :s]) for k, t in ext.items()}
    tail = {k: (t if k == "adc_mask" else t[:, s:]) for k, t in ext.items()}
    # (d) decode == teacher forcing at full width and depth, in float32
    # activations (where a cache fault cannot hide in rounding) and in the
    # served bf16. Witnesses that the bf16 gap is rounding: each bf16
    # path's distance from the float32 forward (the truth), and the bf16
    # forward with the plain attention in place of the kernel. Controls:
    # the same decode with each layer reading the next layer's cache, and
    # with one 64-slot tile of every layer's cache zeroed, must fail.
    # The float32 serving path (prefill, then one decode step, through
    # models.serving): the CUDA-core route, counted from 0.
    c32 = cfg.replace(dtype="float32")
    reset_all_launches()
    _, cache = serving.prefill(params, head, c32, extra_slots=1)
    got32, _ = serving.decode_step(params, tail, cache, c32)
    torch.cuda.synchronize()
    launches_f32 = all_launches()
    print(f"  path lm_f32 (prefill over {s} + one decode step, float32 "
          f"activations): launch counters {launches_f32}")
    check(launches_f32["flash_attention"] == cfg.num_layers
          and launches_f32["flash_attention_tc"] == 0,
          f"float32 serving launched {launches_f32}, expected "
          f"{cfg.num_layers} CUDA-core launches and none on the tensor "
          f"cores")
    want32 = transformer.logits_fn(params, ext, c32)[:, -1]
    del cache
    _, cache = serving.prefill(params, head, cfg, extra_slots=1)
    clean = {k: t.clone() for k, t in cache.items()}
    got16, _ = serving.decode_step(params, tail, cache, cfg)
    want16 = transformer.logits_fn(params, ext, cfg)[:, -1]
    with plain_attention(torch):
        want16_plain = transformer.logits_fn(params, ext, cfg)[:, -1]
    controls = {}
    for label, edit in (
            ("each layer reads the next layer's cache",
             lambda t: torch.roll(t, 1, dims=0)),
            ("cache slots 1024..1087 zeroed",
             lambda t: t.index_fill(2, torch.arange(1024, 1088,
                                                    device=dev), 0))):
        bad = dict(clean, k=edit(clean["k"]), v=edit(clean["v"]),
                   kpos=clean["kpos"].clone())
        controls[label] = float(
            (serving.decode_step(params, tail, bad, cfg)[0] - want16)
            .abs().max())
        del bad
    del cache, clean

    def dist(a, b_):
        return float((a - b_).abs().max())

    errs = {"float32": dist(got32, want32), cfg.dtype: dist(got16, want16)}
    wit = {"bf16 decode vs float32 forward": dist(got16, want32),
           "bf16 forward vs float32 forward": dist(want16, want32),
           "bf16 forward, plain attention, vs float32 forward":
               dist(want16_plain, want32),
           "bf16 decode vs bf16 forward with plain attention":
               dist(got16, want16_plain)}
    print(f"  (d) decode after prefill(extra_slots=1) vs forward over "
          f"S+1={s + 1} (ragged), last-position logits (float32 forward: "
          f"std {float(want32.std()):.3f}, max |.| "
          f"{float(want32.abs().max()):.3f}):")
    print(f"      float32 activations: max_abs_err {errs['float32']:.3e} "
          f"[rtol=atol={LM_TEACHER_F32_TOL:g}]")
    print(f"      {cfg.dtype} activations: max_abs_err {errs[cfg.dtype]:.3e} "
          f"[atol={LM_TEACHER_BF16_ATOL:g}]")
    for label, val in wit.items():
        print(f"      witness, {label}: {val:.3e}")
    for label, val in controls.items():
        verdict = ("rejected" if val > LM_TEACHER_BF16_ATOL
                   else "not rejected")
        print(f"      control, {label}: {val:.3e} ({verdict})")
    check(torch.allclose(got32, want32, rtol=LM_TEACHER_F32_TOL,
                         atol=LM_TEACHER_F32_TOL),
          f"decode != teacher forcing at full width in float32 "
          f"({errs['float32']:.3e})")
    check(errs[cfg.dtype] <= LM_TEACHER_BF16_ATOL,
          f"decode != teacher forcing at full width in {cfg.dtype} "
          f"({errs[cfg.dtype]:.3e})")
    check(all(val > LM_TEACHER_BF16_ATOL for val in controls.values()),
          f"the {cfg.dtype} limit does not reject a cache fault: {controls}")
    err_d = errs["float32"]
    del full, got32, want32, got16, want16, want16_plain

    walls, traced_wall, flash_us, flash_n, other_us, other_n = \
        timed_prefill(torch, lambda: serving.prefill(params, batch, cfg))
    busy = (flash_us + other_us) / 1e6 / traced_wall
    warm = min(walls)
    # the float32 prefill (the lm_f32 path, 48 CUDA-core launches)
    w32, tw32, f32_us, f32_n, o32_us, o32_n = timed_prefill(
        torch, lambda: serving.prefill(params, batch, c32))
    base_ms = BASELINE_CUDA_CORE_MS * cfg.num_layers
    print(f"  warm float32 prefill {w32[0]:.4f}/{w32[1]:.4f} s "
          f"({b * s / min(w32):.0f} tokens/s); traced: wall {tw32:.4f} s, "
          f"flash_attention (CUDA cores) {f32_us / 1e3:.3f} ms over {f32_n} "
          f"launches ({f32_us / 1e3 / max(f32_n, 1):.3f} ms each; the "
          f"replaced kernel, the stated baseline: "
          f"{BASELINE_CUDA_CORE_MS} ms x {cfg.num_layers} = {base_ms:.1f} "
          f"ms), everything else "
          f"{o32_us / 1e3:.3f} ms over {o32_n} device operations, device "
          f"busy {(f32_us + o32_us) / 1e4 / tw32:.1f} % on {card}")
    check(f32_n == cfg.num_layers, f"the traced float32 prefill launched "
                                   f"the CUDA-core kernel {f32_n} times")

    # warm decode: 16 steps after a fresh prefill (the launcher's loop, no
    # sampling), then one traced step
    _, cache = serving.prefill(params, batch, cfg)
    rng = np.random.default_rng(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_gen):
        step = serve.token_to_batch(cfg, None, s + i, b, rng, device=dev)
        serving.decode_step(params, step, cache, cfg)
    torch.cuda.synchronize()
    decode_warm_ms = (time.perf_counter() - t0) / n_gen * 1e3
    step = serve.token_to_batch(cfg, None, s + n_gen, b, rng, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serving.decode_step(params, step, cache, cfg)
        torch.cuda.synchronize()
        dec_wall = time.perf_counter() - t0
    dec_us, dec_n = 0.0, 0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) is None or not ev.count:
            continue
        if "DeviceType.CUDA" not in str(ev.device_type):
            continue
        dec_us += getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0.0))
        dec_n += ev.count
    del cache
    out = {"launches": launches, "launches_f32": launches_f32,
           "prefill_s_first": info["prefill_s"],
           "prefill_s_warm": walls, "prefill_tokens_per_s": b * s / warm,
           "decode_ms_per_token": info["decode_ms_per_token"],
           "decode_ms_per_token_warm": decode_warm_ms,
           "decode_traced_wall_ms": dec_wall * 1e3,
           "decode_device_ms": dec_us / 1e3, "decode_device_ops": dec_n,
           "decode_busy_share": dec_us / 1e6 / dec_wall,
           "peak_gb": peak_gb, "traced_wall_s": traced_wall,
           "flash_device_ms": flash_us / 1e3, "flash_launches_traced":
           flash_n, "other_device_ms": other_us / 1e3,
           "other_device_ops": other_n, "device_busy_share": busy,
           "f32_prefill_s_warm": w32, "f32_traced_wall_s": tw32,
           "f32_flash_device_ms": f32_us / 1e3,
           "f32_flash_launches_traced": f32_n,
           "f32_flash_baseline_ms": base_ms,
           "f32_other_device_ms": o32_us / 1e3,
           "f32_device_busy_share": (f32_us + o32_us) / 1e6 / tw32,
           "prefill_vs_forward_err": err_c, "decode_vs_teacher_err": err_d,
           "decode_vs_teacher_err_served_dtype": errs[cfg.dtype],
           "decode_vs_teacher_witnesses": wit,
           "decode_vs_teacher_controls": controls}
    print(f"  warm prefill {walls[0]:.4f}/{walls[1]:.4f} s "
          f"({b * s / warm:.0f} tokens/s); traced: wall {traced_wall:.4f} s, "
          f"flash_attention {flash_us / 1e3:.3f} ms over {flash_n} launches "
          f"({flash_us / 1e3 / max(flash_n, 1):.3f} ms each), everything "
          f"else {other_us / 1e3:.3f} ms over {other_n} device operations, "
          f"device busy {busy * 100:.1f} % on {card}")
    print(f"  warm decode {decode_warm_ms:.2f} ms/token over {n_gen} steps; "
          f"one traced step: wall {dec_wall * 1e3:.2f} ms, device "
          f"{dec_us / 1e3:.3f} ms over {dec_n} device operations, busy "
          f"{dec_us / 1e4 / dec_wall:.1f} % on {card}")
    return out


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
        t_start = time.perf_counter()
        card = card_line()
        print(f"nvidia-smi: {card}")
        dev = resolve_device("cuda")
        kind_name = torch.cuda.get_device_name(0)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"numpy {np.__version__} device 0: {kind_name}")
        t0 = time.perf_counter()
        built = _build.build_all()
        print(f"build: {time.perf_counter() - t0:.2f} s "
              f"({', '.join(f'{k} {v:.2f} s' for k, v in built.items())})")
        for src in _build.SOURCES:
            kernels, warnings = ptxas_report(_build.build_log(src))
            for name, regs, st, ld in kernels:
                print(f"  ptxas {src}: {name}: {regs} registers, spill "
                      f"stores {st} B, spill loads {ld} B")
            for line in warnings:
                print(f"  ptxas {src}: {line}")
            if src in ("adc_quantize", "qmlp_bank"):
                # quantizer: 16-byte and word walks; banks: {MLP, SVM} x
                # {padded, unpadded} weight rows
                want = 2 if src == "adc_quantize" else 4
                check(len(kernels) == want and all(
                    st == 0 and ld == 0 for _, _, st, ld in kernels),
                      f"the {src} instantiations spill or are missing: "
                      f"{kernels}")
            if src == "mc_eval":
                # {nominal, calibrated} x {2^N = 2, 4, 8, 16, 32 in
                # registers, the shared-memory route}
                check(len(kernels) == 12 and all(
                    st == 0 and ld == 0 for _, _, st, ld in kernels),
                      f"the Monte-Carlo instantiations spill or are "
                      f"missing: {kernels}")
            if src == "flash_attention_tc":
                check(len(kernels) == 5 and all(
                    st == 0 and ld == 0 for _, _, st, ld in kernels),
                      f"the tensor-core instantiations spill or are "
                      f"missing: {kernels}")
            if src == "flash_attention":
                # 3 layouts x softcap x (f32 cp.async, f32 and bf16
                # through registers), 18; Narrow is dh <= 64, Wide<128>
                # dh <= 128
                narrow = [k for k in kernels
                          if "Narrow" in k[0] or "WideILi128E" in k[0]]
                check(len(kernels) == 18 and len(narrow) == 12 and all(
                    st == 0 and ld == 0 for _, _, st, ld in narrow),
                      f"the CUDA-core instantiations for head widths up "
                      f"to 128 spill or are missing: {kernels}")
        clock = sm_clock(torch)
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
        q_err, q_timings = phase_quantizer(np, torch, dev, data)
        max_err.update(q_err)
        mc_err, mc_timings = phase_mc_kernels(np, torch, dev, data)
        max_err.update(mc_err)
        fa_err, fa_timings = phase_flash_kernels(np, torch, dev, card, clock)
        max_err.update(fa_err)
        serve_launches = phase_serve(np, torch, dev, card, fronts, data)
        search_out = phase_search(np, torch, dev, card, data)
        robust_out = phase_robust(np, torch, dev, card, data, search_out)
        gen_out = phase_generation(np, torch, dev, card, data)
        marks = [time.perf_counter()]
        baseline_out = phase_baseline(np, torch, dev, card, data)
        marks.append(time.perf_counter())
        resume_out = phase_resume(np, torch, dev, card, data)
        marks.append(time.perf_counter())
        gradient_out = phase_gradient(np, torch, dev, card, data)
        marks.append(time.perf_counter())
        phase_s = dict(zip(("baseline", "resume", "gradient"),
                           np.diff(marks).tolist()))
        print(f"phases baseline / resume / gradient: "
              f"{' / '.join(f'{v:.2f}' for v in phase_s.values())} s, "
              f"{marks[-1] - marks[0]:.2f} s in all on {card}")
        lm_out = phase_lm(np, torch, dev, card)

        mods = sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "jaxlib"))
                      or m == "repro" or m.startswith("repro."))
        check(not mods, f"JAX or the JAX package was imported: {mods}")

        # launches on each path, both models: serve, search, robust,
        # baseline, resume, gradient; lm
        both = lambda res: {n: sum(res[k]["launches"][n]  # noqa: E731
                                   for k in ("mlp", "svm"))
                            for n in KERNELS}
        by_path = {"serve": serve_launches,
                   "search": both(search_out),
                   "robust": both(robust_out),
                   "baseline": both(baseline_out),
                   "resume": resume_out["launches"],
                   "gradient": gradient_out["launches"],
                   "lm": lm_out["launches"],
                   "lm_f32": lm_out["launches_f32"]}
        main_timing = {
            "adc_quantize": q_timings["P=1"],
            "adc_quantize_population": q_timings["search train P=16"],
            "bespoke_mlp": timings["bespoke_mlp"]["D=1"],
            "bespoke_svm": timings["bespoke_svm"]["D=1"],
            "qmlp_mlp_bank": timings["qmlp_mlp_bank"]["serve batch"],
            "qmlp_svm_bank": timings["qmlp_svm_bank"]["serve batch"],
            "mc_adc_eval": mc_timings["mc_adc_eval"]["single S=32 M=636"],
            "mc_adc_eval_population":
                mc_timings["mc_adc_eval_population"]["search P=16 S=32 M=636"],
            "mc_adc_eval_cal":
                mc_timings["mc_adc_eval_cal"]["cal single S=32 M=636"],
            "mc_adc_eval_cal_population":
                mc_timings["mc_adc_eval_cal_population"][
                    "cal search P=16 S=32 M=636"],
            "flash_attention_tc":
                fa_timings["musicgen prefill B=4 S=2048 H=KV=24 dh=64"],
            "flash_attention":
                fa_timings["musicgen prefill B=4 S=2048 H=KV=24 dh=64 f32"]}
        extra_timings = {"adc_quantize_population": q_timings,
                         "qmlp_mlp_bank": timings["qmlp_mlp_bank"],
                         "qmlp_svm_bank": timings["qmlp_svm_bank"],
                         **mc_timings, "flash_attention": fa_timings,
                         "flash_attention_tc": fa_timings}
        rows = []
        for name, meta in KERNELS.items():
            paths = {path: counts.get(name, 0)
                     for path, counts in by_path.items()}
            total = sum(paths.values())
            check(total > 0, f"{name} (row {meta['row']}) never launched on "
                             f"a path")
            t = main_timing[name]
            rows.append({
                "name": name, "route": "cuda", "source": meta["source"],
                "replaces": meta["replaces"], "pallas": meta["pallas"],
                "row": meta["row"], "launches": total,
                "launches_by_path": paths, "max_abs_err": max_err[name],
                "ms": t["ms"], "kernel_ms": t["ms"],
                "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t.get("library_ms"), "shape": t["shape"],
                "timings": extra_timings.get(name)})
        summary = {"search": {k: {kk: vv for kk, vv in v.items()
                                  if kk != "launches"}
                              for k, v in search_out.items()},
                   "robust": {k: {kk: vv for kk, vv in v.items()
                                  if kk != "launches"}
                              for k, v in robust_out.items()},
                   "generation_defaults": gen_out,
                   "baseline": {k: {kk: vv for kk, vv in v.items()
                                    if kk != "launches"}
                                for k, v in baseline_out.items()},
                   "resume": {k: v for k, v in resume_out.items()
                              if k != "launches"},
                   "gradient": {k: v for k, v in gradient_out.items()
                                if k != "launches"},
                   "phase_s": phase_s,
                   "lm": {k: v for k, v in lm_out.items()
                          if k != "launches"},
                   "wall_s": time.perf_counter() - t_start}
        print(f"summary: {json.dumps(summary)}")
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
