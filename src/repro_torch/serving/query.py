"""Query/Answer types of the marginal-inference serving layer.

A :class:`Query` asks a registered workload's resident chains for marginal
distributions (or MAP values) at some sites, optionally conditioned on
evidence ``x[site] = value``; an :class:`Answer` carries the estimate plus
the freshness verdict and staleness the caller needs to decide whether to
trust it.  Both are plain host-side containers — everything device-shaped
lives in :mod:`.pool`.

A copy of the JAX package's ``serving/query.py`` (numpy only): the same
query gives the same signature, and the same answer the same JSON.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = ["Query", "Answer"]

_KINDS = ("marginal", "map")


@dataclasses.dataclass(frozen=True)
class Query:
    """One marginal/MAP request against a registered workload.

    ``sites``: sites whose marginals to return (None = all unobserved
    sites).  ``evidence``: ``((site, value), ...)`` observations to clamp —
    queries with the same evidence set share one conditioned lane
    regardless of ordering, so evidence is normalized to a sorted tuple.
    ``kind``: 'marginal' (full (|sites|, D) distributions) or 'map'
    (argmax values only).  ``deadline_ms``: answer-by budget measured from
    submit; past it the pool stops sweeping for freshness and degrades
    (it never blocks past the deadline to polish an answer).
    ``priority``: higher sheds later under admission pressure.
    """
    workload: str
    sites: Optional[Tuple[int, ...]] = None
    evidence: Tuple[Tuple[int, int], ...] = ()
    kind: str = "marginal"
    deadline_ms: Optional[float] = None
    priority: int = 0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, "
                             f"got {self.kind!r}")
        if self.deadline_ms is not None:
            if not float(self.deadline_ms) >= 0.0:
                raise ValueError(f"deadline_ms must be >= 0, "
                                 f"got {self.deadline_ms!r}")
            object.__setattr__(self, "deadline_ms", float(self.deadline_ms))
        object.__setattr__(self, "priority", int(self.priority))
        ev = tuple(sorted((int(s), int(v)) for s, v in self.evidence))
        if len({s for s, _ in ev}) != len(ev):
            raise ValueError(f"duplicate evidence sites in {ev}")
        object.__setattr__(self, "evidence", ev)
        if self.sites is not None:
            object.__setattr__(self, "sites",
                               tuple(int(s) for s in self.sites))

    @property
    def signature(self) -> Tuple[Tuple[int, int], ...]:
        """The conditioned-lane routing key: the normalized evidence set
        (empty = the resident unconditional lane)."""
        return self.evidence


@dataclasses.dataclass
class Answer:
    """What the pool returns for one :class:`Query`.

    ``fresh`` is the telemetry gate's verdict (``report`` holds the full
    measurements); a refused answer (``status='refused'``) carries
    ``marginals=None`` — never a silently biased estimate.
    ``staleness_sweeps`` counts sweeps the serving lane has started since
    the snapshot answering this query was published; ``sweeps`` is the
    lane's total at that snapshot.

    ``status`` is the structural outcome: 'ok' (an estimate, fresh or
    degraded), 'shed' (admission control dropped it before any work),
    'refused' (every ladder rung exhausted), or 'error' (an unexpected
    exception was converted into a structured answer).  ``source`` names
    the degradation-ladder rung that produced the estimate: 'fresh',
    'stale', or 'exact' (None when there is no estimate).
    """
    query: Query
    fresh: bool
    report: Dict[str, Any]
    staleness_sweeps: int
    sweeps: int
    marginals: Optional[np.ndarray] = None    # (|sites|, D) float64
    map_values: Optional[np.ndarray] = None   # (|sites|,) int64
    status: str = "ok"
    source: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe rendering (the launcher's --out / CI artifact)."""
        return {
            "workload": self.query.workload,
            "kind": self.query.kind,
            "sites": None if self.query.sites is None
            else list(self.query.sites),
            "evidence": [list(e) for e in self.query.evidence],
            "fresh": bool(self.fresh),
            "report": self.report,
            "staleness_sweeps": int(self.staleness_sweeps),
            "sweeps": int(self.sweeps),
            "marginals": None if self.marginals is None
            else np.asarray(self.marginals).tolist(),
            "map_values": None if self.map_values is None
            else np.asarray(self.map_values).tolist(),
            "status": self.status,
            "source": self.source,
        }
