"""The tile autotuner. Counterpart of ``repro/perf/autotune.py``.

Each hand kernel picks its tile (the bank kernels' rows, the quantizer's
span, the Monte-Carlo kernel's chunk; kernels/envelope.py) by one fixed
heuristic. This module *measures* instead: per entry and shape class it
times the kernel on the card at every candidate tile (``block_m``, in
sample rows), picks the winner, and persists the choices as a JSON table
next to the dispatch layer (``kernels/tuned_tables.json``), which
kernels/dispatch.py consults before the heuristic. Guarantees:

* the heuristic's tile (``cost_model.heuristic_block_m``) is always a
  candidate, so the tuned choice never measures slower than it on the
  tuning run;
* selection is deterministic: candidates are measured in sorted order
  and a tie breaks toward the smaller tile, so the same measurements
  give byte-identical tables;
* tuning changes only speed: a tile decides which block computes which
  rows, never an output's bits (chip_smoke.py holds every candidate
  bitwise against the heuristic tile and the plain version).

Measurement: ``measure_fn(entry, workload, block_m) -> us`` may be
injected (the tests do, on the CPU); without it, each candidate's kernel
is timed on a CUDA device with CUDA events over back-to-back launches
queued behind a spin (``device_us``), so the time is the card's and not
the host's. There is no CPU tuning path: without a card and without
``measure_fn``, ``tune`` raises.

Tables are validated on load (``load_table``): the wrong version, a
malformed document, or a table tuned on another backend or another card
(stale, not wrong) all degrade to "no tuned entry", with a WARNING, and
the dispatch layer then takes the heuristic. The table's ``device``
records the card's name and power limit as provenance.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import envelope
from repro_torch.perf import cost_model
from repro_torch.perf.workload import Workload, shape_class

log = logging.getLogger(__name__)

TABLE_VERSION = 1

# the default persisted location, next to the dispatch layer, so the
# tuned table travels with the kernels it describes
DEFAULT_TABLE_PATH = (Path(__file__).resolve().parent.parent / "kernels"
                      / "tuned_tables.json")
TABLE_ENV_VAR = "REPRO_TORCH_TUNED_TABLE"


def current_backend() -> str:
    """'cuda' where a card is visible, else 'cpu': the backend a table
    must have been tuned on to apply here."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _powers(unit: int, top: int):
    """unit, 2 unit, 4 unit, ... up to ``top``."""
    t = unit
    while t <= top:
        yield t
        t <<= 1


def candidate_block_ms(w: Workload) -> Tuple[int, ...]:
    """Sorted candidate tiles (sample rows) for one workload: powers of
    two times the kernel's row unit up to the largest tile worth taking,
    that tile itself, and the heuristic's, each one the kernel takes.

    * bank: multiples of the layout's rows a thread (4 padded, 1 not), up
      to ``BANK_MAX_ROWS``, ``BANK_CODE_WORDS // F`` and M (rounded up);
    * Monte-Carlo: multiples of row lanes x ``MC_BATCH``, up to the chunk
      that covers M;
    * quantizer: whole rows whose span fits ``Q_SPAN_MAX``, up to M; none
      where one row is longer than that (C > ``Q_SPAN_MAX``), and then
      the workload cannot be tuned."""
    fam = cost_model.family(w.entry)
    if fam == "bank":
        g = cost_model.geometry(w)
        unit = g.per_thread
        top = min(envelope.BANK_MAX_ROWS,
                  max(unit, envelope.BANK_CODE_WORDS // w.c),
                  -(-w.m // unit) * unit) // unit * unit
    elif fam == "mc":
        unit = envelope.mc_row_lanes(w.c) * envelope.MC_BATCH
        top = -(-w.m // unit) * unit
    else:
        unit, top = 1, min(w.m, envelope.Q_SPAN_MAX // w.c)
        if top < 1:
            return ()
    cands = set(_powers(unit, top)) | {top, cost_model.heuristic_block_m(w)}
    out = []
    for bm in sorted(cands):
        try:
            cost_model.geometry(w, bm)
        except ValueError:
            continue
        out.append(bm)
    return tuple(out)


def device_us(fn: Callable[[], object], reps: int = 100,
              warmup: int = 10) -> float:
    """Device microseconds per call of ``fn`` (which launches on the
    current stream): ``reps`` calls queued behind a spin of the card
    (``torch.cuda._sleep``) and timed with CUDA events, so the launches
    run back to back and the host's time per call is hidden. The spin
    doubles until the host has queued every launch before the card
    reaches the first (the start event is still pending then)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 20
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_first = not start.query()
        end.synchronize()
        if queued_first:
            return start.elapsed_time(end) * 1e3 / reps
        if cycles >= 1 << 36:
            raise RuntimeError("device_us: the host could not queue the "
                               "launches ahead of the card")
        cycles <<= 2


def tuning_operands(w: Workload, seed: int = 0, device="cuda"
                    ) -> Tuple[tuple, object]:
    """Operands for one workload in entry order (x, tables, *weights),
    and the AdcSpec driving them: x uniform floats in [0, 1), repaired
    random masks, float weights from a normal; the Monte-Carlo entries'
    operands compiled as the robust search compiles them. Deterministic
    in ``seed``; numpy draws, so the CPU and the card get the same."""
    from repro_torch.core.adc import repair_mask
    from repro_torch.core.nonideal import NonIdealSpec, mc_operands
    from repro_torch.core.spec import AdcSpec
    rng = np.random.default_rng(seed)
    spec = AdcSpec(bits=w.bits)
    dev = torch.device(device)
    x = torch.as_tensor(rng.random((w.m, w.c)), dtype=torch.float32,
                        device=dev)
    n = w.levels

    def masks(*lead):
        raw = (rng.random(lead + (w.c, n)) < 0.6).astype(np.int32)
        return repair_mask(torch.as_tensor(raw, device=dev))

    def weights(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32, device=dev)

    def table(*lead):
        return spec.value_table(masks(*lead)).contiguous()

    ni = NonIdealSpec(sigma_offset=0.3, sigma_range=0.01, fault_rate=0.02,
                      seed=seed)
    if w.entry == "adc_quantize":
        return (x, table()), spec
    if w.entry == "adc_quantize_population":
        return (x, table(w.p)), spec
    if w.entry in ("mc_eval", "mc_eval_population"):
        lead = (w.p,) if w.entry == "mc_eval_population" else ()
        return (x,) + mc_operands(spec, ni, masks(*lead), samples=w.s,
                                  device=dev), spec
    if w.entry in ("mc_eval_cal", "mc_eval_cal_population"):
        from repro_torch.faulttol import calibrate, redundancy
        lead = (w.p,) if w.entry == "mc_eval_cal_population" else ()
        tmr = (rng.random(lead + (w.c,)) < 0.5).astype(np.int32)
        genes = (np.ones(lead, np.int32) if lead else np.int32(1))
        rdraws = redundancy.draw_redundant(w.bits, w.c, w.s, ni, dev)
        return (x,) + calibrate.mc_operands_ft(spec, ni, masks(*lead), tmr,
                                               genes, rdraws, dev), spec
    if w.entry == "bespoke_mlp":
        return (x, table(), weights(w.c, w.h), weights(w.h),
                weights(w.h, w.o), weights(w.o)), spec
    if w.entry == "bespoke_svm":
        return (x, table(), weights(w.c, w.o), weights(w.o)), spec
    if w.entry == "classifier_bank_mlp":
        return (x, table(w.d), weights(w.d, w.c, w.h), weights(w.d, w.h),
                weights(w.d, w.h, w.o), weights(w.d, w.o)), spec
    if w.entry == "classifier_bank_svm":
        return (x, table(w.d), weights(w.d, w.c, w.o),
                weights(w.d, w.o)), spec
    raise ValueError(f"no tuning-operand rule for entry {w.entry!r}")


def default_workloads() -> Tuple[Workload, ...]:
    """The paths' shapes (PERF.md's kernel table): cardio's 21 channels
    at 4 bits, H=5 and O=3 where a classifier runs.

    * row 1: M=636 (the test split), the P=1 call;
    * row 2: P=16, M=1488 (the train split), and the co-search stacks
      P=16, M=1980, C=16 and M=1680, C=24, both 3 bits;
    * rows 3/4: M=1024 (the serve batch), D=1;
    * rows 5/6: M=1024 at D=6 (MLP) and D=3 (SVM), the fixture fronts, and
      M=256, the async engine's ``max_batch`` (its ladder quantum);
    * rows 7-10: S=32, M=636, with P=16 for the population rows."""
    c, b = 21, 4
    return (
        Workload("adc_quantize", m=636, c=c, bits=b),
        Workload("adc_quantize_population", m=1488, c=c, bits=b, p=16),
        Workload("adc_quantize_population", m=1980, c=16, bits=3, p=16),
        Workload("adc_quantize_population", m=1680, c=24, bits=3, p=16),
        Workload("bespoke_mlp", m=1024, c=c, bits=b, h=5, o=3),
        Workload("bespoke_svm", m=1024, c=c, bits=b, o=3),
        Workload("classifier_bank_mlp", m=1024, c=c, bits=b, d=6, h=5, o=3),
        Workload("classifier_bank_mlp", m=256, c=c, bits=b, d=6, h=5, o=3),
        Workload("classifier_bank_svm", m=1024, c=c, bits=b, d=3, o=3),
        Workload("classifier_bank_svm", m=256, c=c, bits=b, d=3, o=3),
        Workload("mc_eval", m=636, c=c, bits=b, s=32),
        Workload("mc_eval_population", m=636, c=c, bits=b, p=16, s=32),
        Workload("mc_eval_cal", m=636, c=c, bits=b, s=32),
        Workload("mc_eval_cal_population", m=636, c=c, bits=b, p=16, s=32),
    )


def card_provenance() -> Optional[Dict]:
    """The card a table was tuned on: ``torch.cuda.get_device_name(0)``
    and nvidia-smi's power limit (None where nvidia-smi is missing)."""
    if not torch.cuda.is_available():
        return None
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = None
    return {"name": torch.cuda.get_device_name(0), "power_limit": limit}


def tune(workloads: Optional[Iterable[Workload]] = None, *,
         backend: Optional[str] = None, reps: int = 100, warmup: int = 10,
         seed: int = 0, measure_fn: Optional[Callable] = None) -> Dict:
    """Measure every candidate tile of every workload and return the
    tuned table (``save_table`` gives its JSON form).

    ``measure_fn(entry, workload, block_m) -> us`` replaces the card's
    measurement (the tests inject one; a fixed set of measurements gives
    a byte-identical table). Without it a CUDA device is required: each
    candidate runs the entry's kernel callable (kernels/dispatch.py) on
    ``tuning_operands`` and is timed by ``device_us``. ``backend``
    defaults to ``current_backend()``."""
    from repro_torch.kernels import dispatch
    if measure_fn is None and not torch.cuda.is_available():
        raise RuntimeError("autotune measures on a CUDA device and none is "
                           "available; pass measure_fn to tune without one")
    backend = current_backend() if backend is None else backend
    entries: Dict[str, Dict] = {}
    for w in (workloads if workloads is not None else default_workloads()):
        entry = dispatch.get(w.entry)            # unknown entry: loud error
        cands = candidate_block_ms(w)
        if not cands:
            log.info("autotune %s[%s]: no whole-row tile fits a block; "
                     "left to the heuristic", w.entry, shape_class(w))
            continue
        run = None
        if measure_fn is None:
            (x, tables, *weights), spec = tuning_operands(w, seed)
            run = lambda bm: entry.kernel(  # noqa: E731
                x, tables, *weights, spec=spec, block_m=bm)
        heuristic = cost_model.heuristic_block_m(w)
        results: Dict[str, float] = {}
        best_bm, best_us = None, None
        for bm in cands:
            if measure_fn is not None:
                us = float(measure_fn(w.entry, w, bm))
            else:
                us = device_us(lambda: run(bm), reps, warmup)
            results[str(bm)] = us
            if best_us is None or us < best_us:     # tie -> smaller tile
                best_bm, best_us = bm, us
        key = shape_class(w)
        entries.setdefault(w.entry, {})[key] = {
            "block_m": best_bm, "us": best_us,
            "heuristic_block_m": heuristic,
            "heuristic_us": results[str(heuristic)],
            "workload": w.to_meta(), "candidates_us": results,
        }
        log.info("autotune %s[%s]: block_m=%d (%.2fus) vs heuristic %d "
                 "(%.2fus)", w.entry, key, best_bm, best_us, heuristic,
                 results[str(heuristic)])
    return {"version": TABLE_VERSION, "backend": backend,
            "device": card_provenance() if backend == "cuda" else None,
            "entries": entries}


def save_table(table: Dict, path=None) -> Path:
    """Persist a tuned table as sorted-key JSON (atomic replace), by
    default next to kernels/dispatch.py, and reset the dispatch layer's
    cached policy so that the next resolution re-reads the default
    table."""
    from repro_torch.kernels import dispatch
    path = Path(path) if path else DEFAULT_TABLE_PATH
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(table, indent=1, sort_keys=True) + "\n")
    os.replace(tmp, path)
    dispatch.reset_tuned_policy()
    return path


def load_table(path=None) -> Optional[Dict]:
    """Read and validate a tuned table (default: ``$REPRO_TORCH_TUNED_TABLE``
    or ``DEFAULT_TABLE_PATH``). Returns None (with a WARNING) for a
    corrupt table (unparseable, wrong schema or version) or a stale one
    (tuned for another backend than ``current_backend()``, or on another
    card), and None for a missing one: the dispatch layer then takes the
    heuristic."""
    path = Path(path) if path else Path(
        os.environ.get(TABLE_ENV_VAR, DEFAULT_TABLE_PATH))
    if not path.exists():
        return None
    try:
        table = json.loads(path.read_text())
    except (OSError, ValueError) as e:
        log.warning("tuned table %s is corrupt (%s): falling back to the "
                    "heuristic tiles", path, e)
        return None
    if (not isinstance(table, dict)
            or table.get("version") != TABLE_VERSION
            or not isinstance(table.get("entries"), dict)):
        log.warning("tuned table %s has an unknown schema or version: "
                    "falling back to the heuristic tiles", path)
        return None
    backend = current_backend()
    if table.get("backend") != backend:
        log.warning("tuned table %s is stale (tuned for backend=%r, "
                    "running %r): falling back to the heuristic tiles",
                    path, table.get("backend"), backend)
        return None
    card = (table.get("device") or {}).get("name")
    if (backend == "cuda" and card is not None and torch.cuda.is_available()
            and card != torch.cuda.get_device_name(0)):
        log.warning("tuned table %s is stale (tuned on %r, running on %r): "
                    "falling back to the heuristic tiles", path, card,
                    torch.cuda.get_device_name(0))
        return None
    return table


@dataclasses.dataclass(frozen=True)
class TablePolicy:
    """The ``dispatch.set_tuned_policy`` adapter over a loaded table:
    entry + shape class -> tuned block_m, else None (the heuristic)."""
    table: Dict

    def __call__(self, entry: str, w: Workload) -> Optional[int]:
        rec = self.table.get("entries", {}).get(entry, {}).get(
            shape_class(w))
        if not isinstance(rec, dict):
            return None
        bm = rec.get("block_m")
        return int(bm) if isinstance(bm, (int, float)) and bm >= 1 else None


def load_policy(path=None) -> Optional[TablePolicy]:
    """``load_table`` wrapped as a dispatch policy (None when the table
    is absent, corrupt or stale)."""
    table = load_table(path)
    return TablePolicy(table) if table is not None else None


def autotune(workloads: Optional[Sequence[Workload]] = None, *,
             write: bool = True, path=None, **kw) -> Dict:
    """Tune, persist and activate in one call, the form
    ``repro_torch.api.autotune`` exposes: the table is written to
    ``path`` (default ``DEFAULT_TABLE_PATH``) and installed as the
    dispatch layer's policy where it is valid here. ``write=False`` only
    measures. Returns the tuned table."""
    from repro_torch.kernels import dispatch
    table = tune(workloads, **kw)
    if write:
        path = save_table(table, path)
        dispatch.set_tuned_policy(load_policy(path))
    return table
