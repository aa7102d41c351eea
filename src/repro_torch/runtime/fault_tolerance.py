"""Fault tolerance, as the JAX package's ``runtime/fault_tolerance.py``
has it: heartbeat watchdog, straggler detection, failure injection, and
the retry/restart training-loop driver.

Every rank runs the same program: the watchdog observes *local* step
completion, the straggler monitor keeps per-step wall-time statistics,
and the driver restarts from the last checkpoint on any step failure --
including elastic downscale to a smaller mesh via runtime/elastic.py
when ranks are gone for good. A failure is injected on every rank at the
same step; a failure of one rank alone, which leaves the others blocked
in a collective, is not handled here.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional


class HeartbeatMonitor:
    """Watchdog: flags a hang if no step completes within `timeout_s`."""

    def __init__(self, timeout_s: float = 300.0,
                 on_hang: Optional[Callable[[], None]] = None):
        self.timeout_s = timeout_s
        self.on_hang = on_hang
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._hung = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def beat(self, step: int = -1):
        self._last_beat = time.monotonic()

    @property
    def hung(self) -> bool:
        return self._hung.is_set()

    def _watch(self):
        while not self._stop.wait(min(self.timeout_s / 4, 5.0)):
            if time.monotonic() - self._last_beat > self.timeout_s:
                self._hung.set()
                if self.on_hang:
                    self.on_hang()
                return

    def stop(self):
        self._stop.set()


class StragglerMonitor:
    """Per-step wall-time ring buffer with z-score outlier flagging.

    On a real cluster each host reports its step time; hosts whose times
    are persistent outliers get flagged so the scheduler can migrate
    their data shards / drain them.
    """

    def __init__(self, window: int = 50, z_threshold: float = 3.0,
                 min_samples: int = 10):
        self.window = window
        self.z = z_threshold
        self.min_samples = min_samples
        self.times: Deque[float] = deque(maxlen=window)
        self.flagged_steps: List[int] = []
        self._step = 0

    def record(self, seconds: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        import math
        is_outlier = False
        if len(self.times) >= self.min_samples:
            mean = sum(self.times) / len(self.times)
            var = sum((t - mean) ** 2 for t in self.times) / len(self.times)
            std = math.sqrt(var)
            if std > 0 and (seconds - mean) / std > self.z:
                is_outlier = True
                self.flagged_steps.append(self._step)
        self.times.append(seconds)
        self._step += 1
        return is_outlier

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        return {"mean_s": sum(ts) / len(ts), "p50_s": ts[len(ts) // 2],
                "max_s": ts[-1], "n_flagged": len(self.flagged_steps)}


@dataclass
class FailureInjector:
    """Deterministic failure injection for tests/examples: raises at the
    configured steps to exercise the restart path."""
    fail_at_steps: tuple = ()
    exception: type = RuntimeError
    fired: set = field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise self.exception(f"injected failure at step {step}")


def run_with_restarts(train_steps: int, step_fn: Callable[[int], Any],
                      save_fn: Callable[[int], None],
                      restore_fn: Callable[[], int],
                      checkpoint_every: int = 50,
                      max_restarts: int = 3,
                      monitor: Optional[StragglerMonitor] = None,
                      heartbeat: Optional[HeartbeatMonitor] = None,
                      flush_fn: Optional[Callable[[], None]] = None):
    """Checkpoint/restart driver. step_fn(step) runs one step (stateful
    via closure); restore_fn() reloads the last checkpoint and returns
    the step to resume from.

    ``flush_fn`` (optional) is called on a step failure BEFORE
    restore_fn: a schedule that carries state across the step boundary
    (the cross-step optimizer pipeline) drains its in-flight epilogue
    there, so the last completed step's update is applied rather than
    silently dropped -- load-bearing when restore_fn has no checkpoint
    to fall back to and resumes from the live state. A flush_fn failure
    (e.g. the carry's buffers were donated by the step that died) is
    swallowed: the restore that follows re-establishes a consistent
    state either way.

    ``max_restarts`` bounds CONSECUTIVE failures, not lifetime failures:
    the counter resets after a full checkpoint interval completes
    cleanly (progress reached the next save without a failure), so a
    long run with sparse transient faults does not accumulate toward
    the limit. The returned ``restarts`` is still the lifetime total.
    """
    restarts = 0            # consecutive failures since the last clean
    #                         checkpoint interval -- compared to
    #                         max_restarts
    total_restarts = 0      # lifetime count, reported in the result
    step = restore_fn()
    safe_step = step        # last step persisted (or resumed from)
    while step < train_steps:
        try:
            t0 = time.monotonic()
            step_fn(step)
            dt = time.monotonic() - t0
            if monitor is not None:
                monitor.record(dt)
            if heartbeat is not None:
                heartbeat.beat(step)
            step += 1
            if step % checkpoint_every == 0 or step == train_steps:
                save_fn(step)
                if step - safe_step >= checkpoint_every:
                    restarts = 0    # a full interval ran clean: forgive
                    #                 earlier transient failures
                safe_step = step
        except Exception:
            restarts += 1
            total_restarts += 1
            if restarts > max_restarts:
                raise
            if flush_fn is not None:
                try:
                    flush_fn()
                except Exception:
                    pass
            step = restore_fn()
            safe_step = step
    return {"final_step": step, "restarts": total_restarts,
            "consecutive_restarts": restarts,
            "stragglers": monitor.summary() if monitor else {}}
