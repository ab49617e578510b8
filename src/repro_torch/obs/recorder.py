"""The one emit point: spans, events, and metrics behind a single object.

The JAX package's ``obs/recorder.py`` on the port's engines.
``Recorder`` composes a :class:`~repro_torch.obs.trace.TraceBuffer` and a
:class:`~repro_torch.obs.metrics.MetricsRegistry` and is what the engine
and the launcher talk to.  ``NullRecorder`` is the default and is *total*
no-op — every method returns immediately, spans are ``nullcontext`` — so
an uninstrumented run pays nothing, and an instrumented one pays host-side
timers only: no host sync (``chip_smoke.py`` runs the loop under
``torch.cuda.set_sync_debug_mode("error")``) and no added launch.

Module-level plumbing (``get_recorder``/``set_recorder``/``using``/
``configure``) keeps call sites one import away from the active
recorder without threading it through every signature.  ``annotate``
names a device phase for the profiler regardless of recorder: a
``torch.profiler.record_function`` range while a profiler is recording,
and a shared ``nullcontext`` otherwise (one C call to ask, no operation
dispatched), so it is safe on the sweep call's host-bound path.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, Optional

import torch

from .metrics import MetricsRegistry
from .trace import TraceBuffer

__all__ = ["Recorder", "NullRecorder", "get_recorder", "set_recorder",
           "using", "configure", "annotate", "PROFILE_FILE"]

# the Chrome trace ``Recorder.profile`` writes into ``profile_dir``
PROFILE_FILE = "profile_trace.json"
_NULL_SCOPE = nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def annotate(name: str):
    """A named range for device-side phase attribution.

    Under an active ``torch.profiler`` capture (``Recorder.profile``) this
    is a ``torch.profiler.record_function`` range, and the profiler puts
    every kernel launched inside it under ``name``.  Otherwise it is a
    shared ``nullcontext``: no operation is dispatched and the check costs
    one C call, so it is safe on the sweep hot path with the null recorder
    active.
    """
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL_SCOPE


class NullRecorder:
    """All-no-op recorder; the default when observability is off."""

    enabled = False

    def span(self, name: str, **args):
        return nullcontext()

    def complete(self, name, ts_us, dur_us, **args):
        pass

    def now_us(self) -> float:
        return 0.0

    def instant(self, name: str, **args):
        pass

    def event(self, kind: str, **info):
        pass

    def count(self, name: str, value: float = 1.0, **labels):
        pass

    def gauge(self, name: str, value: float, **labels):
        pass

    def histogram(self, name: str, value: float, **labels):
        pass

    def register_engine(self, eng, *, workload: str = "",
                        chains: int = 0) -> Dict[str, str]:
        return {"engine": getattr(eng, "name", ""),
                "backend": getattr(eng, "backend", ""),
                "schedule": "", "workload": workload}

    def snapshot(self):
        pass

    def profile(self):
        return nullcontext()

    def close(self):
        pass


class Recorder(NullRecorder):
    """Active recorder writing trace + metrics files.

    ``metrics_dir``  directory for ``metrics.jsonl`` (one snapshot per
                     line) and ``metrics.prom`` (rewritten each snapshot)
                     and ``events.jsonl`` (one structured event per line).
    ``trace_path``   Chrome trace-event JSON output (written on close and
                     after every snapshot, atomically).
    ``profile_dir``  enables ``profile()`` → a ``torch.profiler`` capture
                     (CPU, plus CUDA where there is a card) written as a
                     Chrome trace to ``profile_dir/profile_trace.json``.
    """

    enabled = True

    def __init__(self, metrics_dir: Optional[str] = None,
                 trace_path: Optional[str] = None,
                 profile_dir: Optional[str] = None,
                 process_name: str = "repro"):
        self.metrics = MetricsRegistry()
        self.trace = TraceBuffer(process_name=process_name)
        self.metrics_dir = metrics_dir
        self.trace_path = trace_path
        self.profile_dir = profile_dir
        self._io_lock = threading.Lock()
        if metrics_dir:
            os.makedirs(metrics_dir, exist_ok=True)

    # -- tracing ----------------------------------------------------------
    def span(self, name: str, **args):
        """Host-side span: trace event + seconds/calls accumulators."""
        return _Span(self, name, args)

    def complete(self, name, ts_us, dur_us, **args):
        self.trace.complete(name, ts_us, dur_us, **args)
        self.metrics.count("span_seconds_total", dur_us / 1e6, span=name)
        self.metrics.count("span_calls_total", 1, span=name)

    def now_us(self) -> float:
        return self.trace.now_us()

    def instant(self, name: str, **args):
        self.trace.instant(name, **args)

    def event(self, kind: str, **info):
        """A structured incident: instant trace event + counter + one
        ``events.jsonl`` line."""
        self.trace.instant(kind, **info)
        self.metrics.count("events_total", 1,
                           help="structured incident events", kind=kind)
        if self.metrics_dir:
            line = json.dumps({"ts_us": self.trace.now_us(), "kind": kind,
                               **info}, default=str)
            with self._io_lock:
                with open(os.path.join(self.metrics_dir,
                                       "events.jsonl"), "a") as f:
                    f.write(line + "\n")

    # -- metrics ----------------------------------------------------------
    def count(self, name: str, value: float = 1.0, **labels):
        self.metrics.count(name, value, **labels)

    def gauge(self, name: str, value: float, **labels):
        self.metrics.gauge(name, value, **labels)

    def histogram(self, name: str, value: float, **labels):
        self.metrics.histogram(name, value, **labels)

    def register_engine(self, eng, *, workload: str = "",
                        chains: int = 0) -> Dict[str, str]:
        """Publish an engine's identity + analytic cost gauges; returns the
        standard label set callers attach to their own series."""
        labels = {"engine": eng.name, "backend": eng.backend,
                  "schedule": eng.schedule.describe(), "workload": workload}
        self.metrics.gauge("engine_updates_per_call", eng.updates_per_call,
                           help="site updates per sweep call", **labels)
        if chains:
            self.metrics.gauge("engine_chains", chains,
                               help="resident chains", **labels)
        n = int(eng.graph.n)
        cost = _sweep_cost(eng, chains or 1, n)
        self.metrics.gauge("sweep_flops_per_call", cost["flops_per_call"],
                           help="analytic flops per sweep call", **labels)
        self.metrics.gauge("sweep_bytes_per_call", cost["bytes_per_call"],
                           help="analytic bytes per sweep call", **labels)
        foot = _psum_footprint(eng, chains or 1, n)
        self.metrics.gauge("psum_payload_bytes", foot["psum_payload_bytes"],
                           help="dist collective payload per sweep call",
                           **labels)
        self.metrics.gauge("collectives_per_sweep",
                           foot["collectives_per_sweep"],
                           help="collectives per sweep call", **labels)
        return labels

    # -- export -----------------------------------------------------------
    def snapshot(self):
        """Flush current metric values to disk (JSONL append + .prom
        rewrite) and refresh the trace file.  Called only at existing
        host-sync boundaries — never from inside the sweep path."""
        if self.metrics_dir:
            series = self.metrics.snapshot()
            with self._io_lock:
                with open(os.path.join(self.metrics_dir,
                                       "metrics.jsonl"), "a") as f:
                    f.write(json.dumps({"ts": time.time(),
                                        "series": series}) + "\n")
                prom = self.metrics.to_prometheus()
                path = os.path.join(self.metrics_dir, "metrics.prom")
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    f.write(prom)
                os.replace(tmp, path)
        if self.trace_path:
            self.trace.write(self.trace_path)

    def profile(self):
        """Opt-in ``torch.profiler`` capture (requires profile_dir)."""
        if not self.profile_dir:
            return nullcontext()
        return _torch_profile(self.profile_dir)

    def close(self):
        self.snapshot()


class _Span:
    """``Recorder.span``'s context manager: the JAX package's generator
    span as a class, which costs the per-call host path a few microseconds
    less."""
    __slots__ = ("rec", "name", "args", "t0")

    def __init__(self, rec: Recorder, name: str, args: dict):
        self.rec, self.name, self.args = rec, name, args

    def __enter__(self):
        self.t0 = self.rec.trace.now_us()

    def __exit__(self, *exc):
        rec, name = self.rec, self.name
        dur = rec.trace.now_us() - self.t0
        rec.trace.complete(name, self.t0, dur, **self.args)
        rec.metrics.count("span_seconds_total", dur / 1e6,
                          help="total wall seconds inside span", span=name)
        rec.metrics.count("span_calls_total", 1, help="span entry count",
                          span=name)
        return False


@contextmanager
def _torch_profile(profile_dir: str):
    """``torch.profiler.profile`` over the block (CPU activity, and CUDA
    where a card is present), exported as a Chrome trace on exit."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(profile_dir, PROFILE_FILE))


# -- cost helpers (tolerant: identity gauges must never break a run) -------

def _sweep_cost(eng, chains: int, n: int) -> Dict[str, float]:
    from .costmodel import sweep_cost
    try:
        return sweep_cost(eng.name, chains=chains, n=n, D=eng.graph.D,
                          sweep=eng.updates_per_call, params=eng.params)
    except Exception:
        return {"flops_per_call": 0.0, "bytes_per_call": 0.0}


def _psum_footprint(eng, chains: int, n: int) -> Dict[str, float]:
    """Collectives and their payload per sweep call: none off the dist
    backend; on it ``dist_gibbs.psum_footprint``'s numbers."""
    if eng.backend != "dist":
        return {"collectives_per_sweep": 0, "psum_payload_bytes": 0}
    try:
        from ..runtime.dist_gibbs import psum_footprint
        desc = eng.schedule.describe()
        if desc.startswith("chromatic"):
            return psum_footprint("chromatic", C=chains, D=eng.graph.D,
                                  n=n, n_colors=eng.schedule.n_colors)
        sweep = getattr(eng.schedule, "sweep_len", eng.updates_per_call)
        return psum_footprint(eng.name, C=chains, D=eng.graph.D, S=sweep)
    except Exception:
        return {"collectives_per_sweep": 0, "psum_payload_bytes": 0}


# -- module-level active recorder ------------------------------------------

_active: NullRecorder = NullRecorder()


def get_recorder() -> NullRecorder:
    """The process-wide active recorder (NullRecorder unless configured)."""
    return _active


def set_recorder(rec) -> NullRecorder:
    global _active
    prev, _active = _active, rec
    return prev


@contextmanager
def using(rec):
    """Scope ``rec`` as the active recorder for a ``with`` block."""
    prev = set_recorder(rec)
    try:
        yield rec
    finally:
        set_recorder(prev)


def configure(metrics_dir: Optional[str] = None,
              trace_path: Optional[str] = None,
              profile_dir: Optional[str] = None,
              process_name: str = "repro"):
    """Build and activate a Recorder when any output is requested;
    otherwise leave/restore the NullRecorder.  Returns the active one."""
    if not (metrics_dir or trace_path or profile_dir):
        set_recorder(NullRecorder())
        return get_recorder()
    rec = Recorder(metrics_dir=metrics_dir, trace_path=trace_path,
                   profile_dir=profile_dir, process_name=process_name)
    set_recorder(rec)
    return rec
