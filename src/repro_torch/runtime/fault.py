"""Fault tolerance & straggler mitigation for long-running loops.

A copy of the JAX package's ``runtime/fault.py`` (pure Python): the same
calls give the same restart budgets, backoff delays and heartbeat files.

Pieces:
* ``StepWatchdog`` — EMA step timer; flags stragglers (> k x EMA) and keeps
  counters a scheduler can act on (on multi-host deployments the hook is
  where slow-host re-dispatch / hot-spare promotion plugs in; on one host it
  records and logs).
* ``RestartBudget`` / ``Backoff`` — the restart policy pieces: a retry
  budget that REFILLS after sustained forward progress (a fixed lifetime
  budget inevitably exhausts on long runs with occasional preemptions) and
  exponential sleep-between-restarts with an injectable clock so tests run
  at full speed.
* ``run_with_restarts`` — supervised execution: a step function that raises
  is retried from the latest checkpoint under the budget/backoff policy
  (simulated-preemption tests exercise this path).  The full supervised
  sampling driver (health guards, rollback, engine degradation) is
  ``runtime/supervisor.py``; it shares these policy pieces.
* ``Heartbeat`` — wall-clock liveness file other processes can monitor.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

__all__ = ["StepWatchdog", "RestartBudget", "Backoff", "run_with_restarts",
           "Heartbeat"]


class StepWatchdog:
    def __init__(self, slow_factor: float = 3.0, ema: float = 0.9):
        self.slow_factor = slow_factor
        self.ema_coef = ema
        self.ema_time: Optional[float] = None
        self.straggler_steps = 0
        self.total_steps = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        dt = time.monotonic() - self._t0
        self.total_steps += 1
        if self.ema_time is None:
            self.ema_time = dt
        else:
            if dt > self.slow_factor * self.ema_time:
                self.straggler_steps += 1
                self.on_straggler(dt)
            self.ema_time = (self.ema_coef * self.ema_time
                             + (1 - self.ema_coef) * dt)
        return False

    def on_straggler(self, dt: float):
        """Override/hook: slow-step handler (re-dispatch, alerting, ...)."""
        print(f"[watchdog] straggler step: {dt*1e3:.1f} ms "
              f"(ema {self.ema_time*1e3:.1f} ms)")

    def stats(self):
        return {"ema_step_s": self.ema_time,
                "stragglers": self.straggler_steps,
                "steps": self.total_steps}


class RestartBudget:
    """Retry budget that refreshes on forward progress.

    ``consume()`` spends one restart (raising ``exhausted`` beforehand is
    the caller's job via :attr:`exhausted`); ``note_success()`` records one
    successfully completed step — after ``refresh_after`` *consecutive*
    successes the spent budget refills, so a long run with occasional,
    well-separated preemptions never dies of old age while a crash loop
    (restarts with no progress between them) still exhausts quickly.
    ``refresh_after=None`` keeps the old fixed-lifetime semantics.
    """

    def __init__(self, max_restarts: int, refresh_after: Optional[int] = 8):
        self.max_restarts = max_restarts
        self.refresh_after = refresh_after
        self.used = 0
        self.total = 0
        self._streak = 0

    @property
    def exhausted(self) -> bool:
        return self.used > self.max_restarts

    def consume(self) -> int:
        """Spend one restart; returns the total restart count."""
        self.used += 1
        self.total += 1
        self._streak = 0
        return self.total

    def note_success(self):
        self._streak += 1
        if (self.refresh_after is not None
                and self._streak >= self.refresh_after):
            self.used = 0
            self._streak = 0


class Backoff:
    """Exponential backoff between restarts with an injectable clock.

    ``wait()`` sleeps ``base * factor**(consecutive_failures - 1)`` capped
    at ``max_delay``; ``reset()`` (call on success) zeroes the failure
    streak.  ``sleep_fn`` is the test clock injection point.
    """

    def __init__(self, base: float = 0.5, factor: float = 2.0,
                 max_delay: float = 30.0,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.base = base
        self.factor = factor
        self.max_delay = max_delay
        self.sleep_fn = sleep_fn
        self.failures = 0

    def next_delay(self) -> float:
        return min(self.base * self.factor ** self.failures, self.max_delay)

    def wait(self) -> float:
        delay = self.next_delay()
        self.failures += 1
        if delay > 0.0:
            self.sleep_fn(delay)
        return delay

    def reset(self):
        self.failures = 0


def run_with_restarts(make_state: Callable[[], object],
                      step_fn: Callable[[object, int], object],
                      *, num_steps: int, max_restarts: int = 3,
                      on_restart: Optional[Callable[[int], object]] = None,
                      refresh_after: Optional[int] = 8,
                      backoff_base: float = 0.0, backoff_factor: float = 2.0,
                      backoff_max: float = 30.0,
                      sleep_fn: Callable[[float], None] = time.sleep):
    """Run ``num_steps`` of ``step_fn(state, step) -> state`` restarting on
    exceptions.  ``make_state()`` builds initial state; ``on_restart(step)``
    (if given) must return (state, resume_step) — typically a checkpoint
    restore.  Returns (state, restarts) with ``restarts`` the total number
    of restarts taken.

    The retry budget refills after ``refresh_after`` consecutive successful
    steps (:class:`RestartBudget`) — only a crash *loop* exhausts it, not a
    long run's accumulated one-off preemptions.  ``backoff_base > 0``
    enables exponential sleep between restarts (:class:`Backoff`;
    ``sleep_fn`` injects a test clock)."""
    budget = RestartBudget(max_restarts, refresh_after)
    backoff = Backoff(backoff_base, backoff_factor, backoff_max, sleep_fn)
    state = make_state()
    step = 0
    while step < num_steps:
        try:
            state = step_fn(state, step)
            step += 1
            budget.note_success()
            backoff.reset()
        except Exception as e:   # noqa: BLE001 — supervision boundary
            budget.consume()
            if budget.exhausted:
                raise
            print(f"[fault] step {step} failed ({type(e).__name__}: {e}); "
                  f"restart {budget.used}/{budget.max_restarts} "
                  f"(total {budget.total})")
            backoff.wait()
            if on_restart is not None:
                state, step = on_restart(step)
            else:
                state = make_state()
                step = 0
    return state, budget.total


class Heartbeat:
    def __init__(self, path: str, interval_s: float = 30.0):
        self.path = path
        self.interval = interval_s
        self._last = 0.0

    def beat(self, step: int, **info):
        now = time.time()
        if now - self._last < self.interval:
            return
        self._last = now
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"time": now, "step": step, **info}, f)
        os.replace(tmp, self.path)
