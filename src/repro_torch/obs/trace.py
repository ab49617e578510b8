"""Chrome trace-event / Perfetto-compatible span buffer.

A copy of the JAX package's ``obs/trace.py`` (pure Python): the same calls
give the same trace JSON.

Events follow the trace-event JSON array format understood by
``chrome://tracing`` and https://ui.perfetto.dev: the written file is
``{"traceEvents": [...]}`` where each event carries ``ph`` (``"X"`` for
complete spans with ``ts``+``dur``, ``"i"`` for instants), microsecond
timestamps from one monotonic ``perf_counter_ns`` origin, and pid/tid so
worker-thread activity (async checkpoint writes, pool lanes) lands on
its own track.

Spans here are *host-side* wall-clock brackets around already-synced
work (a dispatched chunk plus the health read that retires it, a
checkpoint write, one serving query).  Device-side phase attribution is
a different mechanism entirely — ``torch.profiler.record_function``
ranges around the engine's sweep call and its telemetry update
(``recorder.annotate``), which record only under an active
``torch.profiler`` capture (``Recorder.profile``), where the profiler
places each kernel launch inside the range that issued it — precisely so
that tracing never forces a host sync the hot path didn't already have.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import List, Optional

__all__ = ["TraceBuffer"]


class TraceBuffer:
    """Thread-safe in-memory trace-event accumulator."""

    def __init__(self, process_name: str = "repro"):
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._t0 = time.perf_counter_ns()
        self._pid = os.getpid()
        self._events.append({
            "ph": "M", "name": "process_name", "pid": self._pid, "tid": 0,
            "args": {"name": process_name},
        })

    def now_us(self) -> float:
        """Microseconds since this buffer's origin (monotonic)."""
        return (time.perf_counter_ns() - self._t0) / 1e3

    def _tid(self) -> int:
        return threading.get_ident() % 2**31

    @contextmanager
    def span(self, name: str, **args):
        """Bracket a block as a complete ("X") event."""
        t0 = self.now_us()
        try:
            yield
        finally:
            t1 = self.now_us()
            self.complete(name, t0, t1 - t0, **args)

    def complete(self, name: str, ts_us: float, dur_us: float, **args):
        """Record a complete event with explicit timestamps (µs).

        Used where the span's start predates the code that closes it —
        e.g. a query's queue wait measured from its submit timestamp.
        """
        ev = {"ph": "X", "name": name, "ts": ts_us, "dur": max(dur_us, 0.0),
              "pid": self._pid, "tid": self._tid()}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, **args):
        """Record an instant ("i") event, e.g. a fault or rollback."""
        ev = {"ph": "i", "name": name, "ts": self.now_us(), "s": "p",
              "pid": self._pid, "tid": self._tid()}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def write(self, path: str, extra_meta: Optional[dict] = None):
        """Write ``{"traceEvents": [...]}`` atomically (tmp + rename)."""
        doc = {"traceEvents": self.events(), "displayTimeUnit": "ms"}
        if extra_meta:
            doc["metadata"] = extra_meta
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
