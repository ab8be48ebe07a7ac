"""Synthetic load generator for the classifier serving engine
(DESIGN.md §12). Counterpart of ``repro/launch/loadgen.py``, copied: it
is numpy only, and for every seed and traffic shape its traces
(payloads, arrival times, deadlines, rids) equal the reference's bit for
bit.

The target workloads are continuous streaming sensors (healthcare
wearables, always-on stress monitors), whose traffic bursts
(event-triggered windows) and breathes over the day (diurnal wear). The
generator builds an **open-loop** arrival process (arrivals independent
of service, the honest way to overload a server and watch it shed) as a
thinned non-homogeneous Poisson process under one of three rate
envelopes:

* ``uniform``: constant rate ``rate_rps``;
* ``bursty``: an ON/OFF square wave; a fraction of each period runs at
  ``burst_factor`` x the base rate, the rest proportionally below it, so
  the *mean* offered load stays ``rate_rps``;
* ``diurnal``: sinusoidal modulation around ``rate_rps`` (a compressed
  day).

Closed-loop traffic (each client waits for its response before the next
request) is the serving engine's ``serve_closed_loop`` mode; this module
only builds the request contents for it. Everything is deterministic
under ``seed``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

TRAFFIC_SHAPES = ("uniform", "bursty", "diurnal")


@dataclasses.dataclass(frozen=True)
class Request:
    """One client request: a small batch of sensor-sample rows bound for
    one tenant's deployed front, with an arrival time and a deadline
    (both seconds relative to stream start; ``deadline_s`` is absolute,
    i.e. ``arrival_s + deadline budget``)."""
    rid: int
    tenant: str
    arrival_s: float
    deadline_s: float
    x: np.ndarray                  # (rows, C) f32 tabular fronts;
                                   # (rows, W, C_raw) raw windows for
                                   # streaming feature-baked fronts

    @property
    def rows(self) -> int:
        return len(self.x)


def rate_envelope(t: np.ndarray, rate_rps: float, shape: str, *,
                  period_s: float = 4.0, burst_factor: float = 8.0,
                  burst_fraction: float = 0.125,
                  diurnal_amplitude: float = 0.75) -> np.ndarray:
    """Instantaneous arrival rate lambda(t) for each time in ``t``.

    Mean over a full period equals ``rate_rps`` for every shape, so
    sweeping shapes at one ``rate_rps`` compares equal offered loads."""
    if shape == "uniform":
        return np.full_like(t, rate_rps, dtype=np.float64)
    if shape == "bursty":
        # ON for burst_fraction of the period at burst_factor * base;
        # OFF at the complementary rate that keeps the mean at rate_rps
        on = (t % period_s) < burst_fraction * period_s
        off_rate = rate_rps * (1.0 - burst_factor * burst_fraction) / max(
            1.0 - burst_fraction, 1e-9)
        if off_rate < 0:
            raise ValueError(
                f"bursty envelope infeasible: burst_factor={burst_factor} x "
                f"burst_fraction={burst_fraction} exceeds 1; the OFF rate "
                f"would be negative")
        return np.where(on, burst_factor * rate_rps, off_rate)
    if shape == "diurnal":
        return rate_rps * (1.0 + diurnal_amplitude
                           * np.sin(2.0 * np.pi * t / period_s))
    raise ValueError(f"unknown traffic shape {shape!r}; "
                     f"pick one of {TRAFFIC_SHAPES}")


def arrival_times(num_requests: int, rate_rps: float, shape: str = "uniform",
                  *, seed: int = 0, **envelope_kw) -> np.ndarray:
    """(num_requests,) sorted arrival offsets (seconds) from a thinned
    non-homogeneous Poisson process with the named rate envelope —
    deterministic under ``seed``."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be positive, got {rate_rps}")
    rng = np.random.default_rng(seed)
    lam_max = rate_rps * max(envelope_kw.get("burst_factor", 8.0)
                             if shape == "bursty" else
                             (1.0 + envelope_kw.get("diurnal_amplitude", 0.75)
                              if shape == "diurnal" else 1.0), 1.0)
    out: List[float] = []
    t = 0.0
    while len(out) < num_requests:
        # candidate stream at the envelope's peak rate, thinned down to
        # lambda(t)/lambda_max — the standard NHPP construction
        t += float(rng.exponential(1.0 / lam_max))
        lam = float(rate_envelope(np.asarray([t]), rate_rps, shape,
                                  **envelope_kw)[0])
        if rng.random() < lam / lam_max:
            out.append(t)
    return np.asarray(out, np.float64)


def make_workload(x: np.ndarray, num_requests: int, *,
                  tenant: str = "default", rate_rps: float = 200.0,
                  request_size: int = 8, deadline_ms: float = 100.0,
                  shape: str = "uniform", seed: int = 0,
                  **envelope_kw) -> List[Request]:
    """An open-loop request trace for one tenant: ``num_requests``
    requests of ``request_size`` rows each, drawn with replacement from
    the dataset ``x``, arriving per the shaped Poisson process, each
    carrying an absolute deadline ``arrival + deadline_ms``. Fully
    deterministic under ``seed``."""
    rng = np.random.default_rng(seed)
    arrivals = arrival_times(num_requests, rate_rps, shape, seed=seed + 1,
                             **envelope_kw)
    idx = rng.integers(0, len(x), size=(num_requests, request_size))
    return [Request(rid=r, tenant=tenant, arrival_s=float(arrivals[r]),
                    deadline_s=float(arrivals[r]) + deadline_ms / 1e3,
                    x=np.asarray(x[idx[r]], np.float32))
            for r in range(num_requests)]


def merge_workloads(*workloads: Sequence[Request]) -> List[Request]:
    """Interleave per-tenant traces into one arrival-ordered stream,
    re-numbering rids so they stay unique across tenants (the original
    per-tenant ordering is preserved by the stable sort)."""
    merged = sorted((r for w in workloads for r in w),
                    key=lambda r: r.arrival_s)
    return [dataclasses.replace(r, rid=i) for i, r in enumerate(merged)]


def closed_loop_payloads(x: np.ndarray, clients: int,
                         requests_per_client: int, *,
                         tenant: str = "default", request_size: int = 8,
                         deadline_ms: float = 100.0,
                         seed: int = 0) -> List[List[Request]]:
    """Per-client request payloads for the engine's closed-loop mode
    (arrival/deadline are assigned at issue time by the engine; the
    ``deadline_s`` here is the *budget* in seconds, not absolute)."""
    rng = np.random.default_rng(seed)
    out = []
    rid = 0
    for c in range(clients):
        idx = rng.integers(0, len(x), size=(requests_per_client,
                                            request_size))
        reqs = []
        for r in range(requests_per_client):
            reqs.append(Request(rid=rid, tenant=tenant, arrival_s=0.0,
                                deadline_s=deadline_ms / 1e3,
                                x=np.asarray(x[idx[r]], np.float32)))
            rid += 1
        out.append(reqs)
    return out


def describe(workload: Sequence[Request]) -> Dict:
    """Quick JSON-able stats of a trace (the benchmark stamps these next
    to the measured SLO numbers so offered vs achieved load is one
    artifact)."""
    if not workload:
        return {"requests": 0}
    arrivals = np.asarray([r.arrival_s for r in workload])
    rows = int(sum(r.rows for r in workload))
    span = float(arrivals.max() - arrivals.min()) or 1e-9
    tenants = sorted({r.tenant for r in workload})
    return {"requests": len(workload), "rows": rows,
            "tenants": tenants,
            "span_s": span,
            "offered_rps": len(workload) / span,
            "offered_sps": rows / span}
