"""Production serving engine for deployed classifier fronts (DESIGN.md
§12). Counterpart of ``repro/launch/serving_engine.py``: asyncio
ingestion with per-request deadlines and shedding, per-tenant SLO
tracking, adaptive microbatch sizing, multi-tenant routing and a
fault-tolerant device pool, on the card through the hand-written bank
kernels (``kernels/csrc/qmlp_bank.cu``, one launch per microbatch and,
for a feature-baked front, per subsample group).

The control logic is the reference's, copied: the shed rule (a request
past its deadline at batch formation is shed, counted per tenant and
answered with ``None``, never dropped), the carry of a request larger
than the batch (its tail is never shed), tenant order by oldest enqueue,
the gather window and the AIMD ladder. Only the device lines are
PyTorch: a microbatch goes in with ``torch.from_numpy(xb).to(dev)`` and
comes out with ``torch.argmax(...).cpu()``, the copy that also waits
for the card, so a batch's latency covers the copy in, the kernel and
the copy out. The dispatch runs in a worker thread under
``torch.inference_mode()`` (grad mode is per thread); the bank wrapper
enters the input's CUDA device itself.

**The batch quantum.** As in the reference, the ladder's quantum is the
tuned tile the dispatch layer would pick for the tenant's bank at
``max_batch`` rows (``bank_quantum``): on the card, the bank kernel's
tuned rows from ``kernels/tuned_tables.json`` (perf/autotune.py), where
the table has the bank's shape class; otherwise, and on a CPU pool (the
plain version has no tile), the reference's off-table default,
``(32, "default")``, which is what the reference gives the cardio fixture
fronts on the CPU, so both packages build the same ladder there and, fed
the same latencies, follow the same trajectory. A tuned quantum changes
the batch shapes and so the latencies, never a response.

**The device pool.** ``DevicePool`` holds ``torch.device`` entries,
``[cuda]`` by default (raising without a card). Every tenant's bank is
``deploy.make_bank_fn(designs, device=pool.devices[0],
mesh=pool.mesh())``, rebuilt from the host arrays after each recovery; a
CPU entry serves through the plain versions, a CUDA entry through the
kernels. A pool made with ``sharded=True`` owns a mesh over its
survivors (``distributed/elastic.bank_pool_mesh``) while at least two
are alive: each bank's design axis is split over it, one bank launch
per shard, and a device loss re-meshes over the survivors, down to
unsharded serving on the last one. The report's ``devices.sharded`` is
true while a mesh is live.

**What a two-entry pool proves.** A device loss is injected as
``fault.DeviceLoss`` inside a bank launch. With a pool of two entries of
one device (``[cpu, cpu]`` in the tests, ``[cuda:0, cuda:0]`` in
``chip_smoke.py``) a run proves the recovery protocol: the lost entry
is dropped, every bank is rebuilt from host arrays on the survivor, the
bit-for-bit served == exported parity is re-asserted, the interrupted
microbatch is re-dispatched, no accepted in-deadline request is dropped,
and losing the last entry raises. It does not prove serving on a second
physical card.

**Calibrate-on-recovery.** A tenant on measured non-ideal hardware
(``Tenant.nonideal``) serves calibrated tables
(``deploy.calibrate_front``, DESIGN.md §15): measured instance 0 at
startup, and instance ``recoveries`` after each device loss (the
replacement is fresh hardware), re-baked before the parity re-assert,
which then compares against the calibrated front's accuracies on the
plain route (the CPU), as the reference compares its mesh with one
device.

**Raw windows.** ``Tenant.sample_shape`` is the front's
``DeployedClassifier.sample_shape``, so a feature-baked front serves raw
(W, C_raw) windows; padding pads only the row axis.

``run_workload`` / ``run_closed_loop`` are the synchronous entry points
(``launch/serve_classifier --driver async`` and ``api.serve_stream``).
"""
from __future__ import annotations

import asyncio
import dataclasses
import logging
import math
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import deploy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import elastic, fault
from repro_torch.distributed.fault import DeviceLoss
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.loadgen import Request
from repro_torch.models.mlp import mean_accuracy

log = logging.getLogger("repro_torch.serving")


# ------------------------------------------------------------ SLO tracking
def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest observed value such that at
    least ``q`` percent of the sample is <= it (rank ``ceil(q/100 * n)``,
    1-indexed). Exact on small samples, no interpolation."""
    n = len(values)
    if n == 0:
        return float("nan")
    rank = min(max(1, math.ceil(q / 100.0 * n)), n)
    return float(sorted(values)[rank - 1])


class SLOTracker:
    """Per-tenant request accounting: latencies of completed requests,
    shed (deadline-expired) and rejected (wrong-domain) counts, sample
    totals, snapshotted as the structured SLO report."""

    def __init__(self) -> None:
        self._lat: Dict[str, List[float]] = {}
        self._counts: Dict[str, Dict[str, int]] = {}

    def _tenant(self, tenant: str) -> Dict[str, int]:
        if tenant not in self._counts:
            self._counts[tenant] = {"completed": 0, "shed": 0,
                                    "rejected": 0, "samples": 0}
            self._lat[tenant] = []
        return self._counts[tenant]

    def record(self, tenant: str, latency_s: float, rows: int) -> None:
        c = self._tenant(tenant)
        c["completed"] += 1
        c["samples"] += rows
        self._lat[tenant].append(float(latency_s))

    def shed(self, tenant: str, n: int = 1) -> None:
        self._tenant(tenant)["shed"] += n

    def reject(self, tenant: str, n: int = 1) -> None:
        self._tenant(tenant)["rejected"] += n

    def latencies(self, tenant: str) -> List[float]:
        return list(self._lat.get(tenant, ()))

    def snapshot(self, wall_s: float) -> Dict[str, Dict]:
        """Per-tenant SLO metrics over the run: nearest-rank p50/p95/p99
        latency (ms), completed/shed/rejected counts, achieved
        throughput normalized by the serving wall time ``wall_s``."""
        out: Dict[str, Dict] = {}
        wall = max(wall_s, 1e-9)
        for tenant, c in self._counts.items():
            lat = self._lat[tenant]
            out[tenant] = {
                "requests": c["completed"] + c["shed"] + c["rejected"],
                "completed": c["completed"],
                "shed": c["shed"],
                "rejected": c["rejected"],
                "samples": c["samples"],
                "p50_ms": percentile(lat, 50) * 1e3,
                "p95_ms": percentile(lat, 95) * 1e3,
                "p99_ms": percentile(lat, 99) * 1e3,
                "max_ms": (max(lat) * 1e3 if lat else float("nan")),
                "requests_per_s": c["completed"] / wall,
                "samples_per_s": c["samples"] / wall,
            }
        return out


# -------------------------------------------------------- adaptive batching
class AdaptiveBatcher:
    """Target-latency microbatch controller (DESIGN.md §12).

    Batch sizes live on a power-of-two ladder ``quantum * 2^k`` clipped
    to ``[quantum, max_batch]``. An EWMA of observed batch latency steps
    the rung down when it overshoots ``target_latency_s``, and up when
    there is both latency headroom (< ``step_up_frac`` of target) and
    enough queued rows to fill the larger rung: growing the batch under
    a thin queue would only add padding and queue wait."""

    def __init__(self, *, quantum: int, max_batch: int = 1024,
                 target_latency_s: float = 0.05, ewma: float = 0.4,
                 step_up_frac: float = 0.25) -> None:
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.sizes: List[int] = []
        b = quantum
        while b <= max(max_batch, quantum):
            self.sizes.append(b)
            if b == max_batch:
                break
            b = min(b * 2, max_batch) if b * 2 <= max_batch else b * 2
            if self.sizes and b <= self.sizes[-1]:
                break
        if self.sizes[-1] > max_batch and len(self.sizes) > 1:
            self.sizes.pop()
        self._idx = 0
        self.target = float(target_latency_s)
        self._alpha = float(ewma)
        self._frac = float(step_up_frac)
        self._ewma: Optional[float] = None
        self.history: List[int] = []

    @property
    def batch(self) -> int:
        return self.sizes[self._idx]

    @property
    def latency_ewma(self) -> Optional[float]:
        return self._ewma

    def observe(self, batch_latency_s: float, queued_rows: int) -> int:
        """Feed one batch's wall time + current queue depth; returns the
        batch size to use next."""
        lat = float(batch_latency_s)
        self._ewma = (lat if self._ewma is None
                      else self._alpha * lat + (1 - self._alpha) * self._ewma)
        if self._ewma > self.target and self._idx > 0:
            self._idx -= 1
        elif (self._ewma < self.target * self._frac
              and self._idx + 1 < len(self.sizes)
              and queued_rows >= self.sizes[self._idx + 1]):
            self._idx += 1
        self.history.append(self.batch)
        return self.batch


def bank_quantum(designs: Sequence[deploy.DeployedClassifier],
                 max_batch: int, *, default: int = 32,
                 device: DeviceLike = None) -> Tuple[int, str]:
    """The batch-ladder quantum for a front: the tuned tile (rows) the
    dispatch layer would pick for this bank's shape class at
    ``max_batch`` rows (kernels/dispatch.py), else ``default``. A CPU
    ``device`` runs the plain version, which carries no tile, so it gets
    ``default``; ``None`` means the card, as everywhere in the port (the
    table is consulted without probing for one)."""
    from repro_torch.kernels import dispatch
    from repro_torch.perf.workload import Workload
    if device is not None and torch.device(device).type == "cpu":
        return int(default), "default"
    d0 = designs[0]
    c = d0.table.shape[0]
    if d0.kind == "mlp":
        h, o = d0.weights[0].shape[1], d0.weights[2].shape[1]
    else:
        h, o = 0, d0.weights[0].shape[1]
    w = Workload(entry=f"classifier_bank_{d0.kind}", m=max_batch, c=c,
                 bits=d0.bits, d=len(designs), h=h, o=o)
    bm, _ = dispatch.tuned_block_m(w.entry, w)
    if bm:
        return int(bm), "tuned"
    return int(default), "default"


# ------------------------------------------------------------- device pool
class DevicePool:
    """The serving devices, survivors only, and in sharded mode the mesh
    the design banks split over. ``fail()`` simulates a device loss; the
    engine then rebuilds every bank on ``devices[0]`` and, sharded, over
    the survivors' mesh."""

    def __init__(self, devices: Optional[Sequence[DeviceLike]] = None, *,
                 sharded: bool = False) -> None:
        self.sharded = bool(sharded)
        self.devices: List[torch.device] = [
            resolve_device(d) for d in (devices if devices is not None
                                        else [None])]
        if not self.devices:
            raise ValueError("device pool needs at least one device")
        self.lost: List[torch.device] = []

    @property
    def alive(self) -> int:
        return len(self.devices)

    def fail(self, index: int = 0) -> None:
        """Drop the device at position ``index`` of the *alive* list."""
        if not 0 <= index < len(self.devices):
            raise ValueError(f"no alive device at index {index} "
                             f"(pool has {len(self.devices)})")
        self.lost.append(self.devices.pop(index))
        if not self.devices:
            raise RuntimeError("device pool exhausted: no survivors to "
                               "rebuild the bank on")

    def mesh(self):
        """A mesh over the surviving devices, or None when the banks
        serve unsharded (the pool is not sharded, or one survivor is
        left)."""
        if not self.sharded or len(self.devices) < 2:
            return None
        return elastic.bank_pool_mesh(self.devices)


# ------------------------------------------------------------------ tenants
@dataclasses.dataclass
class Tenant:
    """One resident exported front: the routing key is the front's
    provenance (``front_meta``'s dataset name). ``parity_data`` is the
    (x_test, y_test) pair the recovery path re-asserts the bit-for-bit
    served==exported contract against. ``nonideal`` (a
    ``core.nonideal.NonIdealSpec``) marks the tenant's hardware as
    carrying measured non-idealities: the engine then serves calibrated
    tables and re-calibrates after every device-loss recovery."""
    name: str
    designs: Sequence[deploy.DeployedClassifier]
    parity_data: Optional[Tuple[np.ndarray, np.ndarray]] = None
    nonideal: Optional[object] = None        # core.nonideal.NonIdealSpec

    @property
    def channels(self) -> int:
        return self.designs[0].channels

    @property
    def sample_shape(self) -> Tuple[int, ...]:
        """Per-sample shape this tenant serves: (C,) for tabular fronts,
        (window, raw_channels) for feature-baked fronts; the per-request
        wrong-domain check compares against it."""
        return self.designs[0].sample_shape


class _TenantState:
    """Engine-internal per-tenant runtime: request queue, batcher, the
    live front and its bank closure on the pool's device."""

    def __init__(self, tenant: Tenant, *, target_latency_s: float,
                 max_batch: int, device: torch.device) -> None:
        self.tenant = tenant
        quantum, src = bank_quantum(tenant.designs, max_batch,
                                    device=device)
        self.quantum_source = src
        self.batcher = AdaptiveBatcher(quantum=quantum, max_batch=max_batch,
                                       target_latency_s=target_latency_s)
        self.queue: deque = deque()       # (Request, future, enq_wall_s)
        self.bank_fn = None               # rebuilt after every recovery
        # the LIVE front: the exported designs, or, for a tenant on
        # measured non-ideal hardware, their calibrated re-bake for the
        # current hardware instance (instance 0 at startup)
        self.designs: List[deploy.DeployedClassifier] = list(tenant.designs)
        self.calibrations = 0
        if tenant.nonideal is not None:
            self.calibrate(instance=0, device=device)

    @property
    def queued_rows(self) -> int:
        return sum(r.rows for r, _, _ in self.queue)

    def calibrate(self, instance: int, device: torch.device) -> None:
        """Re-bake the served front against the measured non-idealities
        of hardware instance ``instance`` (deploy.calibrate_front): at
        startup and after every device-loss recovery."""
        self.designs = deploy.calibrate_front(
            self.tenant.designs, self.tenant.nonideal,
            instance=instance, samples=instance + 1, device=device)
        self.calibrations += 1
        log.info("tenant %s: calibrated against measured instance %d "
                 "(calibration %d)", self.tenant.name, instance,
                 self.calibrations)

    def build_bank(self, device: torch.device, mesh=None) -> None:
        """The live bank on ``device``, design-sharded over ``mesh`` (the
        pool's, whose first device is ``device``) when one is live."""
        self.bank_fn = deploy.make_bank_fn(self.designs, device=device,
                                           mesh=mesh)

    def assert_parity(self, device: torch.device) -> None:
        """Re-assert the bit-for-bit contract on the rebuilt bank (on
        the new mesh, if the pool is sharded), the recovery protocol's
        exit criterion: the live bank's accuracies equal the exported
        ones, or, for a calibrated tenant, the calibrated front's
        reference accuracies."""
        if self.tenant.parity_data is None:
            return
        x, y = self.tenant.parity_data
        with torch.inference_mode():
            logits = self.bank_fn(torch.as_tensor(np.asarray(x, np.float32))
                                  .to(device))
            yd = torch.as_tensor(np.asarray(y)).to(logits.device)
            served = mean_accuracy(torch.argmax(logits, dim=-1)
                                   == yd[None, :]).cpu().numpy()
        if self.tenant.nonideal is not None:
            # the calibrated reference runs on the plain route, so a
            # kernel on the pool's device is held against another path
            expected = deploy.served_accuracies(self.designs, x, y,
                                                device="cpu")
            label = "calibrated reference"
        else:
            expected = np.array([d.accuracy for d in self.designs])
            label = "exported"
        if not np.array_equal(served, expected):
            raise RuntimeError(
                f"post-recovery parity violated for tenant "
                f"{self.tenant.name!r}: served {served} != {label} "
                f"{expected}")


# ------------------------------------------------------------------- engine
class ServingEngine:
    """The asyncio serving loop. One engine holds N resident tenants and
    one device pool; ``run_workload``/``run_closed_loop`` wrap the async
    interface for synchronous callers."""

    def __init__(self, tenants: Sequence[Tenant], *,
                 target_latency_ms: float = 50.0, max_batch: int = 512,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 sharded: bool = False, max_recoveries: int = 3,
                 gather_window_s: Optional[float] = None) -> None:
        if not tenants:
            raise ValueError("serving engine needs at least one tenant")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        self.pool = DevicePool(devices, sharded=sharded)
        self.slo = SLOTracker()
        self.watchdog = fault.StepWatchdog()
        self.max_recoveries = int(max_recoveries)
        self.recoveries = 0
        self.batches = 0
        self.launches = 0           # incl. failed launches (inject index)
        self.padded_rows = 0
        self.dispatched_rows = 0
        self._gather_s = (gather_window_s if gather_window_s is not None
                          else min(target_latency_ms / 4e3, 0.005))
        dev, mesh = self.pool.devices[0], self.pool.mesh()
        self._tenants: Dict[str, _TenantState] = {
            t.name: _TenantState(t, target_latency_s=target_latency_ms / 1e3,
                                 max_batch=max_batch, device=dev)
            for t in tenants}
        for ts in self._tenants.values():
            ts.build_bank(dev, mesh)
        self._work: Optional[asyncio.Event] = None        # set per run
        self._draining = False
        self._inject: Optional[Callable[[int], Optional[int]]] = None

    # ------------------------------------------------------------ ingestion
    def submit(self, req: Request, t0: float) -> "asyncio.Future":
        """Route one request (asyncio-side): validate tenant + sample
        shape, enqueue, wake the batcher. Returns a future resolving to
        the (D, rows) predicted classes, or None if shed/rejected."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        ts = self._tenants.get(req.tenant)
        if ts is None:
            self.slo.reject(req.tenant)
            log.warning("rejected request %d: unknown tenant %r "
                        "(resident: %s)", req.rid, req.tenant,
                        sorted(self._tenants))
            fut.set_result(None)
            return fut
        if tuple(req.x.shape[1:]) != ts.tenant.sample_shape:
            self.slo.reject(req.tenant)
            log.warning("rejected request %d: sample shape %s, tenant %r "
                        "serves %s (wrong-domain)", req.rid,
                        tuple(req.x.shape[1:]), req.tenant,
                        ts.tenant.sample_shape)
            fut.set_result(None)
            return fut
        ts.queue.append((req, fut, time.perf_counter() - t0))
        if self._work is not None:
            self._work.set()
        return fut

    # ------------------------------------------------------------- batching
    def _form_batch(self, ts: _TenantState, now_s: float
                    ) -> Tuple[Optional[np.ndarray], List[Tuple]]:
        """Drain the tenant queue into one microbatch: shed requests
        already past deadline (counted), continuous-batch the rest up to
        the controller's current size (a large request carries over)."""
        batch = ts.batcher.batch
        rows: List[np.ndarray] = []
        meta: List[Tuple] = []          # (req, fut, start_row, n_rows)
        filled = 0
        while filled < batch and ts.queue:
            req, fut, _enq = ts.queue[0]
            if now_s > req.deadline_s and not fut.done():
                ts.queue.popleft()
                self.slo.shed(req.tenant)
                log.info("shed request %d (tenant %s): %.1fms past "
                         "deadline", req.rid, req.tenant,
                         (now_s - req.deadline_s) * 1e3)
                fut.set_result(None)
                continue
            take = min(batch - filled, len(req.x))
            rows.append(req.x[:take])
            meta.append((req, fut, filled, take))
            filled += take
            if take < len(req.x):
                # carry: replace the head with the unserved tail (a
                # request we started serving is never shed mid-flight)
                ts.queue[0] = (dataclasses.replace(
                    req, x=req.x[take:],
                    deadline_s=float("inf")), fut, _enq)
            else:
                ts.queue.popleft()
        if not rows:
            return None, []
        xb = np.concatenate(rows, axis=0)
        pad = batch - len(xb)
        if pad:
            # pad only the row axis: samples may be (C,) or (W, C_raw)
            xb = np.pad(xb, ((0, pad),) + ((0, 0),) * (xb.ndim - 1))
            self.padded_rows += pad
        return xb, meta

    def _warmup(self) -> None:
        """Run each tenant's bank at its starting batch size before the
        serving clock starts (the first CUDA call builds and loads the
        kernels), so the SLO numbers time serving only."""
        dev = self.pool.devices[0]
        with torch.inference_mode():
            for ts in self._tenants.values():
                ts.bank_fn(torch.zeros((ts.batcher.batch,)
                                       + ts.tenant.sample_shape,
                                       dtype=torch.float32, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _dispatch(self, ts: _TenantState, xb: np.ndarray) -> np.ndarray:
        """One bank launch (runs in a worker thread). The injection hook
        models a device failing mid-launch: the exception surfaces here
        as a real device loss would."""
        launch = self.launches
        self.launches += 1
        if self._inject is not None:
            lost = self._inject(launch)
            if lost is not None:
                raise DeviceLoss(lost)
        dev = self.pool.devices[0]
        with torch.inference_mode():
            logits = ts.bank_fn(torch.from_numpy(xb).to(dev))
            return torch.argmax(logits, dim=-1).cpu().numpy()   # (D, batch)

    def _recover(self, e: DeviceLoss) -> None:
        """The fault.py recovery contract, serving flavor: drop the lost
        device, rebuild every tenant's bank from its host arrays on the
        survivor (re-meshed over the survivors for a sharded pool), and
        re-assert the bit-for-bit parity contract before serving resumes
        (the caller re-dispatches the interrupted microbatch)."""
        self.recoveries += 1
        if self.recoveries > self.max_recoveries:
            raise RuntimeError(
                f"{self.recoveries} device losses exceed "
                f"max_recoveries={self.max_recoveries}") from e
        self.pool.fail(e.device_index)
        dev, mesh = self.pool.devices[0], self.pool.mesh()
        log.warning("device %d lost mid-stream; rebuilding %d tenant "
                    "bank(s) on %s (%d survivor(s), %s, recovery %d/%d)",
                    e.device_index, len(self._tenants), dev,
                    self.pool.alive,
                    "unsharded" if mesh is None else mesh_lib.describe(mesh),
                    self.recoveries, self.max_recoveries)
        for ts in self._tenants.values():
            if ts.tenant.nonideal is not None:
                # the replacement hardware is a fresh measured instance:
                # re-bake the front before serving resumes (§15)
                ts.calibrate(instance=self.recoveries, device=dev)
            ts.build_bank(dev, mesh)
            ts.assert_parity(dev)
        self._warmup()
        log.info("recovery complete: parity re-asserted for %d tenant(s)",
                 len(self._tenants))

    async def _serve_one(self, ts: _TenantState, t0: float) -> None:
        now = time.perf_counter() - t0
        xb, meta = self._form_batch(ts, now)
        if xb is None:
            return
        while True:
            bt0 = time.perf_counter()
            try:
                preds = await asyncio.to_thread(self._dispatch, ts, xb)
                break
            except DeviceLoss as e:
                # recovery never drops the in-flight microbatch: the
                # same rows re-dispatch on the rebuilt bank
                await asyncio.to_thread(self._recover, e)
        batch_s = time.perf_counter() - bt0
        self.watchdog.observe(batch_s)
        self.batches += 1
        self.dispatched_rows += len(xb)
        done_s = time.perf_counter() - t0
        for req, fut, start, take in meta:
            chunk = preds[:, start:start + take]
            chunks = getattr(fut, "_chunks", None)
            if chunks is None:
                fut._chunks = chunks = []
            chunks.append(chunk)
            still_queued = any(f is fut for _, f, _ in ts.queue)
            if not still_queued and not fut.done():
                self.slo.record(req.tenant, done_s - req.arrival_s,
                                sum(c.shape[1] for c in chunks))
                fut.set_result(np.concatenate(chunks, axis=1))
        ts.batcher.observe(batch_s, ts.queued_rows)

    async def _consume(self, t0: float) -> None:
        while True:
            pending = [ts for ts in self._tenants.values() if ts.queue]
            if not pending:
                if self._draining:
                    return
                self._work.clear()
                await self._work.wait()
                continue
            # small gather window: under-full queues wait briefly for
            # more arrivals before paying a padded launch
            ts = min(pending, key=lambda s: s.queue[0][2])
            if (not self._draining and ts.queued_rows < ts.batcher.batch
                    and self._gather_s > 0):
                await asyncio.sleep(self._gather_s)
            await self._serve_one(ts, t0)

    # ------------------------------------------------------------- run APIs
    async def serve(self, workload: Sequence[Request], *,
                    inject_device_failure: Optional[Callable] = None
                    ) -> Dict:
        """Replay an open-loop workload trace: arrivals paced by each
        request's ``arrival_s``, deadlines enforced, SLO tracked.
        Returns the structured metrics snapshot."""
        self._inject = inject_device_failure
        self._work = asyncio.Event()
        self._draining = False
        self._warmup()
        t0 = time.perf_counter()
        consumer = asyncio.ensure_future(self._consume(t0))
        futures = []
        warm = sorted(workload, key=lambda r: r.arrival_s)
        for req in warm:
            delay = req.arrival_s - (time.perf_counter() - t0)
            if delay > 0:
                await asyncio.sleep(delay)
            futures.append(self.submit(req, t0))
        self._draining = True
        self._work.set()
        await consumer
        await asyncio.gather(*futures)
        return self.report(time.perf_counter() - t0, futures=futures,
                           workload=warm)

    async def serve_closed_loop(self, payloads: Sequence[Sequence[Request]],
                                *, think_s: float = 0.0) -> Dict:
        """Closed-loop mode: each client task issues its next request
        only after the previous response lands (deadlines are budgets
        applied at issue time). Measures capacity, never sheds under
        overload."""
        self._inject = None
        self._work = asyncio.Event()
        self._draining = False
        self._warmup()
        t0 = time.perf_counter()

        async def client(reqs: Sequence[Request]) -> None:
            for req in reqs:
                now = time.perf_counter() - t0
                live = dataclasses.replace(req, arrival_s=now,
                                           deadline_s=now + req.deadline_s)
                await self.submit(live, t0)
                if think_s:
                    await asyncio.sleep(think_s)

        consumer = asyncio.ensure_future(self._consume(t0))
        await asyncio.gather(*(client(r) for r in payloads))
        self._draining = True
        self._work.set()
        await consumer
        return self.report(time.perf_counter() - t0)

    def report(self, wall_s: float, futures=None, workload=None) -> Dict:
        """The structured metrics snapshot: per-tenant SLO stats plus
        engine-level batching and fault-tolerance counters."""
        rep = {
            "wall_s": wall_s,
            "tenants": self.slo.snapshot(wall_s),
            "batches": self.batches,
            "pad_fraction": (self.padded_rows
                             / max(self.dispatched_rows, 1)),
            "stragglers": self.watchdog.stragglers,
            "recoveries": self.recoveries,
            "calibrations": {name: ts.calibrations
                             for name, ts in self._tenants.items()
                             if ts.calibrations},
            "devices": {"alive": self.pool.alive,
                        "lost": len(self.pool.lost),
                        "sharded": self.pool.mesh() is not None},
            "batch_sizes": {
                name: {"quantum": ts.batcher.sizes[0],
                       "quantum_source": ts.quantum_source,
                       "ladder": ts.batcher.sizes,
                       "final": ts.batcher.batch,
                       "trajectory_tail": ts.batcher.history[-8:]}
                for name, ts in self._tenants.items()},
        }
        if futures is not None and workload is not None:
            responses = {req.rid: f.result()
                         for req, f in zip(workload, futures)}
            rep["responses"] = responses
        return rep


# ------------------------------------------------------------ sync wrappers
def run_workload(tenants: Sequence[Tenant], workload: Sequence[Request],
                 **kw) -> Dict:
    """Synchronous convenience: build an engine over ``tenants`` and
    replay an open-loop ``workload`` through it. Engine kwargs pass
    through (``devices`` included); ``inject_device_failure`` goes to
    ``serve``."""
    inject = kw.pop("inject_device_failure", None)
    engine = ServingEngine(tenants, **kw)
    return asyncio.run(engine.serve(workload,
                                    inject_device_failure=inject))


def run_closed_loop(tenants: Sequence[Tenant],
                    payloads: Sequence[Sequence[Request]], *,
                    think_s: float = 0.0, **kw) -> Dict:
    """Synchronous closed-loop driver (see ``serve_closed_loop``)."""
    engine = ServingEngine(tenants, **kw)
    return asyncio.run(engine.serve_closed_loop(payloads, think_s=think_s))
