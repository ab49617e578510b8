"""Unified observability: metrics export, trace spans, profiler hooks.

The JAX package's ``obs`` on the port.  One recorder object
(:class:`Recorder`, default :class:`NullRecorder`) is the emit point for
the engine's sweeps and the launcher.  Design invariant: nothing in this
package adds a host sync or a kernel launch to the sweep path; metrics
snapshots and span closes happen only at host-sync boundaries the caller
already has.

Typical wiring::

    from repro_torch import obs
    rec = obs.configure(metrics_dir="m", trace_path="m/trace.json")
    labels = rec.register_engine(eng, workload="hetero-pairs-24", chains=16)
    with rec.span("sweep_chunk", **labels):
        state, tel = eng.sweep(state, tel)
    err = float(error)                     # the existing host read
    rec.snapshot()                         # piggybacks that read
    rec.close()
"""
from .metrics import MetricsRegistry, prometheus_escape
from .trace import TraceBuffer
from .recorder import (Recorder, NullRecorder, annotate, configure,
                       get_recorder, set_recorder, using)

__all__ = ["MetricsRegistry", "prometheus_escape", "TraceBuffer",
           "Recorder", "NullRecorder", "annotate", "configure",
           "get_recorder", "set_recorder", "using"]
