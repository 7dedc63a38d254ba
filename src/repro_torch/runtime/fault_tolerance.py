"""Fault tolerance: preemption handling, heartbeats, straggler detection
(``repro.runtime.fault_tolerance``, copied).

At 1000+ nodes the failure model is: (a) planned preemption (SIGTERM with a
grace window) -> drain + checkpoint + exit; (b) hard node loss -> restart
from the latest atomic checkpoint, possibly on fewer hosts
(``repro_torch.runtime.elastic``); (c) stragglers -> detect
via per-host step heartbeats and flag/replace.  On the single-host container the multi-host
paths are exercised through the fault-injection harness in tests.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Callable, Optional


class FaultToleranceSupervisor:
    """Preemption-aware stop flag + heartbeat registry."""

    def __init__(self, grace_seconds: float = 30.0,
                 install_signal_handlers: bool = False):
        self.grace_seconds = grace_seconds
        self._stop = threading.Event()
        self._preempt_time: Optional[float] = None
        self._heartbeats: dict[int, float] = {}  # host -> last beat time
        self._steps: dict[int, int] = {}  # host -> last step
        self._lock = threading.Lock()
        if install_signal_handlers:
            signal.signal(signal.SIGTERM, self._on_preempt)
            signal.signal(signal.SIGINT, self._on_preempt)

    # -- preemption ----------------------------------------------------------
    def _on_preempt(self, signum, frame):
        self.request_stop()

    def request_stop(self):
        self._preempt_time = time.monotonic()
        self._stop.set()

    def should_stop(self) -> bool:
        return self._stop.is_set()

    def seconds_to_deadline(self) -> float:
        if self._preempt_time is None:
            return float("inf")
        return self.grace_seconds - (time.monotonic() - self._preempt_time)

    # -- heartbeats ------------------------------------------------------------
    def heartbeat(self, step: int, host: int = 0):
        with self._lock:
            self._heartbeats[host] = time.monotonic()
            self._steps[host] = step

    def dead_hosts(self, timeout: float) -> list[int]:
        now = time.monotonic()
        with self._lock:
            return [
                h for h, t in self._heartbeats.items() if now - t > timeout
            ]


@dataclasses.dataclass
class StragglerReport:
    host: int
    step_lag: int
    time_lag: float


class StragglerMonitor:
    """Flags hosts whose step counter lags the median by > ``lag_steps`` or
    whose step time exceeds ``slow_factor`` x the fleet median."""

    def __init__(self, lag_steps: int = 2, slow_factor: float = 3.0):
        self.lag_steps = lag_steps
        self.slow_factor = slow_factor
        self._step_times: dict[int, list[float]] = {}
        self._last_step: dict[int, tuple[int, float]] = {}

    def record(self, host: int, step: int, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        if host in self._last_step:
            prev_step, prev_t = self._last_step[host]
            if step > prev_step:
                dt = (now - prev_t) / (step - prev_step)
                self._step_times.setdefault(host, []).append(dt)
                self._step_times[host] = self._step_times[host][-32:]
        self._last_step[host] = (step, now)

    def stragglers(self) -> list[StragglerReport]:
        import numpy as np

        if not self._last_step:
            return []
        steps = {h: s for h, (s, _) in self._last_step.items()}
        median_step = float(np.median(list(steps.values())))
        med_times = {
            h: float(np.median(ts)) for h, ts in self._step_times.items() if ts
        }
        fleet_median = (
            float(np.median(list(med_times.values()))) if med_times else 0.0
        )
        out = []
        for h, s in steps.items():
            lag = int(median_step - s)
            tl = med_times.get(h, 0.0)
            slow = fleet_median > 0 and tl > self.slow_factor * fleet_median
            if lag >= self.lag_steps or slow:
                out.append(StragglerReport(h, lag, tl))
        return out


def run_with_restarts(
    make_trainer: Callable[[int], "object"],
    max_restarts: int = 3,
    inject_failure_at: Optional[int] = None,
):
    """Restart loop harness: (re)build the trainer from the latest
    checkpoint after each simulated failure; used by integration tests to
    prove checkpoint/restart round-trips bit-exactly."""
    restarts = 0
    while True:
        trainer = make_trainer(restarts)
        try:
            if inject_failure_at is not None and restarts == 0:
                trainer.run(inject_failure_at)
                raise RuntimeError("injected node failure")
            return trainer.run(10**9)
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
