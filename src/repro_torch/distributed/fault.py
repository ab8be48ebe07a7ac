"""Fault tolerance: watchdog, device-loss signalling and
retry-from-checkpoint recovery (DESIGN.md §4, §12). Counterpart of
``repro/distributed/fault.py``, copied: it needs neither JAX nor torch.

**What the classifier serving engine uses** (launch/serving_engine.py):
``StepWatchdog``, per-microbatch straggler detection with the same
factor-x-running-median rule as training steps, and ``DeviceLoss``, the
typed exception a failed bank launch surfaces as. The engine's recovery
path is the ``run_with_recovery`` contract applied to serving: catch the
loss, shrink the device pool, rebuild every bank on the survivor,
re-assert bit-for-bit parity and re-dispatch the interrupted microbatch,
bounded by ``max_recoveries`` as ``max_failures`` bounds crash loops
here.

``run_with_recovery`` itself is the every-K-steps checkpoint +
restore-from-latest + replay loop with deterministic per-step batches.
Its ``ckpt`` is a duck type: ``latest_step()``, ``restore(step, state,
shardings)``, ``save(step, state)`` and ``wait()``.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

log = logging.getLogger("repro_torch.fault")


class DeviceLoss(RuntimeError):
    """A device dropped out from under a launched computation.

    Real accelerator loss surfaces as a backend-specific RuntimeError
    mid-launch; tests and the serving engine's failure-injection hook
    raise this typed stand-in instead so recovery paths can be exercised
    deterministically. ``device_index`` is the position of the lost
    device in the *alive* pool at failure time."""

    def __init__(self, device_index: int, message: str = "") -> None:
        self.device_index = int(device_index)
        super().__init__(message or f"device {device_index} lost")


@dataclass
class StepWatchdog:
    """Flags steps slower than ``factor`` x running median."""
    factor: float = 3.0
    window: int = 50
    durations: List[float] = field(default_factory=list)
    stragglers: int = 0

    def observe(self, seconds: float) -> bool:
        self.durations.append(seconds)
        if len(self.durations) > self.window:
            self.durations.pop(0)
        med = sorted(self.durations)[len(self.durations) // 2]
        slow = len(self.durations) >= 5 and seconds > self.factor * med
        if slow:
            self.stragglers += 1
            log.warning("straggler step: %.2fs (median %.2fs)", seconds, med)
        return slow


def run_with_recovery(train_step: Callable, state, batch_fn: Callable,
                      *, start_step: int = 0, num_steps: int, ckpt,
                      ckpt_every: int = 100, shardings=None,
                      max_failures: int = 3,
                      inject_failure: Optional[Callable[[int], bool]] = None,
                      on_metrics: Optional[Callable] = None):
    """Run ``num_steps`` with checkpoint/restart recovery.

    train_step(state, batch, step) -> (state, metrics)
    batch_fn(step) -> batch                (deterministic per step!)
    inject_failure(step) -> bool           (tests exercise recovery paths)
    """
    watchdog = StepWatchdog()
    failures = 0
    step = start_step
    latest = ckpt.latest_step()
    if latest is not None and latest > step:
        state = ckpt.restore(latest, state, shardings)
        step = latest
        log.info("resumed from checkpoint step %d", step)
    while step < num_steps:
        try:
            t0 = time.time()
            if inject_failure is not None and inject_failure(step):
                raise RuntimeError(f"injected failure at step {step}")
            batch = batch_fn(step)
            state, metrics = train_step(state, batch, step)
            watchdog.observe(time.time() - t0)
            step += 1
            if on_metrics is not None:
                on_metrics(step, metrics)
            if step % ckpt_every == 0 or step == num_steps:
                ckpt.save(step, state)
        except KeyboardInterrupt:
            raise
        except Exception as e:                      # noqa: BLE001
            failures += 1
            log.error("step %d failed (%s); recovery %d/%d",
                      step, e, failures, max_failures)
            if failures > max_failures:
                raise
            latest = ckpt.latest_step()
            if latest is None:
                log.warning("no checkpoint yet; restarting from step 0 state")
                step = start_step
                continue
            ckpt.wait()
            state = ckpt.restore(latest, state, shardings)
            step = latest
    ckpt.wait()
    return state, {"failures": failures, "stragglers": watchdog.stragglers,
                   "final_step": step}
