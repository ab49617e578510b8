"""Labeled counters/gauges with JSONL and Prometheus text exposition.

A copy of the JAX package's ``obs/metrics.py`` (pure Python): the same
calls give the same JSONL series and the same Prometheus text.

The registry is deliberately dumb: a dict of ``(name, labels) -> float``
updated under one lock, snapshotted on an explicit cadence by the
:class:`~repro_torch.obs.recorder.Recorder`.  Nothing here ever touches a
device tensor — callers read device values at a host-sync boundary that
already exists (the launcher's log line, a supervisor's health read, a
benchmark's ``torch.cuda.synchronize()``) and hand plain floats in.
That is the whole design: metrics piggyback existing host syncs and never
add one (DESIGN.md §observability).

Export formats:
  * ``snapshot()``  — a JSON-safe list of series, one dict per labeled
    series; the Recorder appends one ``{"ts": ..., "series": [...]}`` line
    per snapshot to ``metrics.jsonl``;
  * ``to_prometheus()`` — the text exposition format (one ``# HELP`` /
    ``# TYPE`` header per metric, label-escaped sample lines; histograms
    as cumulative ``_bucket{le=...}`` plus ``_sum``/``_count``), rewritten
    atomically to ``metrics.prom`` each snapshot so a node exporter /
    file-sd scraper always sees a complete file.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["MetricsRegistry", "prometheus_escape", "DEFAULT_BUCKETS"]

LabelSet = Tuple[Tuple[str, str], ...]

# default fixed buckets for latency-shaped histograms (seconds): sub-ms
# queue waits through multi-second freshness sweeps
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def prometheus_escape(v: str) -> str:
    """Escape a label value for the text exposition format."""
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _labelset(labels: Dict[str, object]) -> LabelSet:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Thread-safe labeled counter/gauge store.

    ``count`` accumulates (monotone, Prometheus ``counter``); ``gauge``
    overwrites (``gauge``); ``histogram`` bins observations into fixed
    buckets (the bounds are set by the metric's first observation and
    stay fixed for its lifetime).  A metric name keeps one kind for its
    lifetime — mixing kinds under one name raises, so the exposition
    stays honest.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._kinds: Dict[str, str] = {}
        self._help: Dict[str, str] = {}
        self._vals: Dict[Tuple[str, LabelSet], float] = {}
        self._buckets: Dict[str, Tuple[float, ...]] = {}
        # (name, labels) -> [per-bucket counts (+Inf last), sum of values]
        self._hist: Dict[Tuple[str, LabelSet], list] = {}

    def _touch(self, name: str, kind: str, help_: Optional[str]):
        have = self._kinds.get(name)
        if have is None:
            self._kinds[name] = kind
        elif have != kind:
            raise ValueError(f"metric {name!r} is a {have}, not a {kind}")
        if help_:
            self._help.setdefault(name, help_)

    def count(self, name: str, value: float = 1.0, *,
              help: Optional[str] = None, **labels):
        """Add ``value`` to counter ``name`` for this label set."""
        with self._lock:
            self._touch(name, "counter", help)
            key = (name, _labelset(labels))
            self._vals[key] = self._vals.get(key, 0.0) + float(value)

    def gauge(self, name: str, value: float, *,
              help: Optional[str] = None, **labels):
        """Set gauge ``name`` to ``value`` for this label set."""
        with self._lock:
            self._touch(name, "gauge", help)
            self._vals[(name, _labelset(labels))] = float(value)

    def histogram(self, name: str, value: float, *,
                  buckets: Optional[Sequence[float]] = None,
                  help: Optional[str] = None, **labels):
        """Observe ``value`` into fixed-bucket histogram ``name``.

        ``buckets`` are ascending upper bounds (``le`` semantics; an
        implicit ``+Inf`` bucket is appended).  The first observation of a
        metric fixes its bounds — later calls must omit ``buckets`` or
        pass the same ones.
        """
        with self._lock:
            self._touch(name, "histogram", help)
            have = self._buckets.get(name)
            if have is None:
                have = tuple(float(b) for b in (buckets or DEFAULT_BUCKETS))
                if list(have) != sorted(have):
                    raise ValueError(f"histogram {name!r} buckets must be "
                                     f"ascending: {have}")
                self._buckets[name] = have
            elif buckets is not None and tuple(
                    float(b) for b in buckets) != have:
                raise ValueError(f"histogram {name!r} already has buckets "
                                 f"{have}")
            key = (name, _labelset(labels))
            h = self._hist.get(key)
            if h is None:
                h = self._hist[key] = [[0] * (len(have) + 1), 0.0]
            h[0][bisect.bisect_left(have, float(value))] += 1
            h[1] += float(value)

    def value(self, name: str, **labels) -> Optional[float]:
        """Current value of one labeled series (None if never written)."""
        with self._lock:
            return self._vals.get((name, _labelset(labels)))

    def histogram_value(self, name: str, **labels) -> Optional[dict]:
        """One labeled histogram as ``{"buckets", "counts", "sum",
        "count"}`` (None if never observed)."""
        with self._lock:
            h = self._hist.get((name, _labelset(labels)))
            if h is None:
                return None
            return {"buckets": list(self._buckets[name]),
                    "counts": list(h[0]), "sum": h[1],
                    "count": int(sum(h[0]))}

    def histogram_quantile(self, name: str, q: float, **labels
                           ) -> Optional[float]:
        """Approximate quantile ``q`` in [0, 1] by linear interpolation
        within the owning bucket (the Prometheus ``histogram_quantile``
        estimate); None if never observed."""
        h = self.histogram_value(name, **labels)
        if h is None or h["count"] == 0:
            return None
        bounds = h["buckets"]
        target = q * h["count"]
        acc = 0.0
        for i, c in enumerate(h["counts"]):
            if acc + c >= target and c > 0:
                hi = bounds[i] if i < len(bounds) else bounds[-1]
                lo = bounds[i - 1] if i > 0 else 0.0
                return lo + (hi - lo) * max(target - acc, 0.0) / c
            acc += c
        return bounds[-1]

    def snapshot(self) -> List[dict]:
        """JSON-safe view: one dict per labeled series."""
        with self._lock:
            out = [{"name": name, "kind": self._kinds[name],
                    "labels": dict(ls), "value": val}
                   for (name, ls), val in sorted(self._vals.items())]
            out.extend(
                {"name": name, "kind": "histogram", "labels": dict(ls),
                 "buckets": list(self._buckets[name]), "counts": list(h[0]),
                 "sum": h[1], "count": int(sum(h[0]))}
                for (name, ls), h in sorted(self._hist.items()))
            return out

    def to_prometheus(self, prefix: str = "repro_") -> str:
        """Text exposition; every metric name gets ``prefix`` prepended."""
        with self._lock:
            by_name: Dict[str, List[Tuple[LabelSet, float]]] = {}
            for (name, ls), val in sorted(self._vals.items()):
                by_name.setdefault(name, []).append((ls, val))
            lines: List[str] = []
            for name, series in by_name.items():
                full = prefix + name
                help_ = self._help.get(name, name.replace("_", " "))
                lines.append(f"# HELP {full} {help_}")
                lines.append(f"# TYPE {full} {self._kinds[name]}")
                for ls, val in series:
                    if ls:
                        lbl = ",".join(
                            f'{k}="{prometheus_escape(v)}"' for k, v in ls)
                        lines.append(f"{full}{{{lbl}}} {val:g}")
                    else:
                        lines.append(f"{full} {val:g}")
            hist_by_name: Dict[str, List[Tuple[LabelSet, list]]] = {}
            for (name, ls), h in sorted(self._hist.items()):
                hist_by_name.setdefault(name, []).append((ls, h))
            for name, series in hist_by_name.items():
                full = prefix + name
                help_ = self._help.get(name, name.replace("_", " "))
                lines.append(f"# HELP {full} {help_}")
                lines.append(f"# TYPE {full} histogram")
                bounds = self._buckets[name]
                for ls, (counts, total) in series:
                    base = ",".join(
                        f'{k}="{prometheus_escape(v)}"' for k, v in ls)
                    sep = "," if base else ""
                    acc = 0
                    for bound, c in zip(bounds, counts):
                        acc += c
                        lines.append(f'{full}_bucket{{{base}{sep}'
                                     f'le="{bound:g}"}} {acc}')
                    acc += counts[-1]
                    lines.append(f'{full}_bucket{{{base}{sep}le="+Inf"}} '
                                 f'{acc}')
                    lbl = f"{{{base}}}" if base else ""
                    lines.append(f"{full}_sum{lbl} {total:g}")
                    lines.append(f"{full}_count{lbl} {acc}")
            return "\n".join(lines) + "\n"
