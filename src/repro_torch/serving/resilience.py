"""Serving resilience: admission control, circuit breakers, supervised
driver.

The paper's minibatch knob is a principled quality ladder — an overloaded
or unhealthy server can trade fidelity for availability instead of
hanging or crashing.  This module holds the host-side control machinery
the :class:`~repro_torch.serving.pool.ChainPool` consults on the *answer*
path; none of it ever touches a device array, so the sweep hot path stays
sync-free (the breaker's health verdicts come from the one host read the
freshness gate already performs at the snapshot boundary).

Three pieces:

* :class:`AdmissionController` — a bounded in-flight budget.  ``admit``
  partitions a batch into admitted and shed queries, dropping
  lowest-priority first, and never blocks; shed queries get a structured
  ``Answer(status='shed')`` from the pool, not an unbounded queue.
* :class:`CircuitBreaker` — the classic closed → open → half-open state
  machine, per serving lane, fed by committed-chunk health (sticky
  ``bad_state`` + windowed acceptance from telemetry).  While open the
  lane's last healthy snapshot is quarantined and served stale; after
  ``cooldown_s`` one probe chunk decides re-close vs re-open.  The clock
  is injectable so tests never sleep (same pattern as
  ``runtime/fault.py``).
* :class:`SupervisedDriver` — the background pool driver wrapped in the
  runtime's restart discipline: ``RestartBudget`` + ``Backoff`` restarts
  on crash, a heartbeat timestamp a watchdog can read, and a structured
  ``driver_giveup`` event when the budget is spent (the driver thread
  previously died silently).

A copy of the JAX package's ``serving/resilience.py`` (pure Python): the
same call sequences give the same admissions, breaker transitions and
driver restarts.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from ..runtime.fault import Backoff, RestartBudget

__all__ = ["AdmissionPolicy", "AdmissionController", "BreakerPolicy",
           "CircuitBreaker", "DegradePolicy", "SupervisedDriver"]


# -- admission control ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Bounds for the admission queue.

    ``max_pending``: in-flight query budget across all submitters; a batch
    that would push past it is partially shed (lowest priority first).
    ``default_deadline_ms``: deadline applied to queries that do not carry
    their own (None = no implicit deadline).
    """
    max_pending: int = 1024
    default_deadline_ms: Optional[float] = None

    def __post_init__(self):
        if self.max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, "
                             f"got {self.max_pending}")


class AdmissionController:
    """Non-blocking bounded admission: admit up to the in-flight budget,
    shed the rest by ascending priority (FIFO within a priority)."""

    def __init__(self, policy: AdmissionPolicy = AdmissionPolicy()):
        self.policy = policy
        self._lock = threading.Lock()
        self._in_flight = 0

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight

    def admit(self, priorities: Sequence[int]
              ) -> Tuple[List[int], List[int]]:
        """Reserve slots for a batch; returns (admitted, shed) index
        lists into ``priorities``.  Callers must ``release`` the admitted
        count when done (a try/finally around the serve)."""
        with self._lock:
            room = max(0, self.policy.max_pending - self._in_flight)
            if room >= len(priorities):
                self._in_flight += len(priorities)
                return list(range(len(priorities))), []
            # stable sort: highest priority first, FIFO among equals
            order = sorted(range(len(priorities)),
                           key=lambda i: (-int(priorities[i]), i))
            admitted = sorted(order[:room])
            shed = sorted(order[room:])
            self._in_flight += len(admitted)
            return admitted, shed

    def release(self, n: int):
        with self._lock:
            self._in_flight = max(0, self._in_flight - int(n))


# -- circuit breaker --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BreakerPolicy:
    """When a lane's breaker opens and how it recovers.

    ``open_after``: consecutive unhealthy committed chunks before opening.
    ``cooldown_s``: seconds the breaker stays open before offering one
    half-open probe chunk.  ``acceptance_floor``: windowed acceptance
    below this counts as unhealthy even without a latched ``bad_state``
    (0.0 disables the floor; MH-style engines only).
    """
    open_after: int = 2
    cooldown_s: float = 0.0
    acceptance_floor: float = 0.0

    def __post_init__(self):
        if self.open_after < 1:
            raise ValueError(f"open_after must be >= 1, "
                             f"got {self.open_after}")
        if self.cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, "
                             f"got {self.cooldown_s}")


class CircuitBreaker:
    """Per-lane closed → open → half-open state machine.

    ``record(healthy)`` feeds one committed-chunk verdict; ``allow_probe``
    asks whether an open breaker may run its single half-open probe.
    State is guarded by the owning lane's lock in the pool, so this class
    itself is lock-free; the clock is injectable for deterministic tests.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
    # numeric encoding for the breaker_state gauge
    GAUGE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}

    def __init__(self, policy: BreakerPolicy = BreakerPolicy(), *,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy
        self.clock = clock
        self.state = self.CLOSED
        self.strikes = 0          # consecutive unhealthy chunks
        self.opened_at: Optional[float] = None
        self.open_count = 0       # lifetime opens (metrics/tests)

    def unhealthy(self, report: dict) -> bool:
        """Map a freshness/health report to one chunk verdict."""
        if report.get("bad_state"):
            return True
        floor = self.policy.acceptance_floor
        if floor > 0.0:
            acc = report.get("win_acceptance")
            if acc is not None and acc < floor:
                return True
        return False

    def record(self, healthy: bool) -> Optional[str]:
        """Feed one committed-chunk verdict; returns 'open'/'close' when
        the state changes that way, else None."""
        if self.state == self.HALF_OPEN:
            if healthy:
                self.state, self.strikes = self.CLOSED, 0
                self.opened_at = None
                return "close"
            self._open()
            return "open"
        if healthy:
            self.strikes = 0
            return None
        self.strikes += 1
        if self.state == self.CLOSED and \
                self.strikes >= self.policy.open_after:
            self._open()
            self.open_count += 1
            return "open"
        return None

    def _open(self):
        self.state = self.OPEN
        self.opened_at = self.clock()

    def allow_probe(self) -> bool:
        """True exactly once per cooldown expiry: transitions open →
        half-open, reserving the single probe chunk for this caller."""
        if self.state != self.OPEN:
            return False
        if self.clock() - self.opened_at < self.policy.cooldown_s:
            return False
        self.state = self.HALF_OPEN
        return True

    @property
    def gauge(self) -> float:
        return self.GAUGE[self.state]


# -- degradation ladder configuration ---------------------------------------

@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """Bounds for the graceful-degradation ladder.

    ``max_stale_sweeps``: staleness ceiling (sweeps since the served
    snapshot was published) for the stale rung; beyond it the ladder
    falls through to exact enumeration.  ``exact_max_states``: joint
    state-space ceiling per connected component for the exact rung
    (hetero-pairs-24 components are D^2 = 16 states — far under this).
    """
    max_stale_sweeps: int = 4096
    exact_max_states: int = 1 << 16


# -- supervised background driver -------------------------------------------

class SupervisedDriver:
    """The pool's background advance loop under restart discipline.

    ``body(stop_event)`` is the drive loop (runs until it raises or the
    stop event is set).  On a crash the driver records a structured
    event, waits out the backoff, and restarts while the budget allows;
    ``beat()`` must be called by the body each iteration so ``alive``
    reflects real progress, not just a running thread.
    """

    def __init__(self, body: Callable[[threading.Event], None], *,
                 budget: Optional[RestartBudget] = None,
                 backoff: Optional[Backoff] = None,
                 clock: Callable[[], float] = time.monotonic,
                 recorder=None, labels: Optional[dict] = None):
        self._body = body
        self.budget = budget or RestartBudget(max_restarts=3,
                                              refresh_after=64)
        self.backoff = backoff or Backoff(base=0.05, max_delay=2.0)
        self.clock = clock
        self._rec = recorder
        self._labels = dict(labels or {})
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.restarts = 0
        self.gave_up = False
        self.heartbeat_at: Optional[float] = None

    def beat(self):
        self.heartbeat_at = self.clock()

    def alive(self, max_age_s: float = 30.0) -> bool:
        """Thread running and heartbeat younger than ``max_age_s``."""
        if self._thread is None or not self._thread.is_alive():
            return False
        return (self.heartbeat_at is not None
                and self.clock() - self.heartbeat_at <= max_age_s)

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pool-driver")
        self._thread.start()

    def stop(self, timeout: float = 30.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def note_progress(self):
        """Call after each committed chunk: refills the restart budget
        after sustained forward progress and resets the backoff streak."""
        self.budget.note_success()
        self.backoff.reset()

    def _run(self):
        while not self._stop.is_set():
            try:
                self.beat()
                self._body(self._stop)
                return                      # clean exit (stop requested)
            except Exception as e:          # noqa: BLE001 — must not die
                if self._rec is not None:
                    self._rec.event("driver_crash", error=repr(e),
                                    restarts=self.restarts, **self._labels)
                if self._stop.is_set():
                    return
                self.budget.consume()
                if self.budget.exhausted:
                    self.gave_up = True
                    if self._rec is not None:
                        self._rec.event("driver_giveup",
                                        restarts=self.restarts,
                                        **self._labels)
                    return
                self.restarts += 1
                if self._rec is not None:
                    self._rec.count("driver_restarts_total", 1,
                                    **self._labels)
                self.backoff.wait()
