"""Deterministic fault injection for the supervised sampling runtime.

The JAX package's ``runtime/faultinject.py`` on torch states: the plans,
their JSON and their per-step generators are the JAX package's (one plan
file drives both packages), and ``inject_state_fault`` picks the same
chain, site and code from the same generator.

A :class:`FaultPlan` is a seed-driven script of failures — every failure
mode the supervisor (``runtime/supervisor.py``) must survive, made
reproducible so crash-resume tests and the CI chaos smoke are exact
replays rather than flaky chaos monkeys:

  * ``preempt``      raise :class:`SimulatedPreemption` at outer step k
                     (SIGKILL-shaped: the step function dies mid-run);
  * ``corrupt``      flip bytes in / truncate the *latest* checkpoint's
                     ``arrays.npz`` or ``manifest.json`` — exercises
                     ``checkpoint.verify`` + ``latest_good_step`` fallback;
  * ``nan``          inject NaN/Inf into the chain state's cached energy
                     (``target="cache"``) or an out-of-domain code into the
                     site values (``target="x"`` — x is integral, so
                     degenerate weights/corruption surface as invalid codes)
                     on seed-chosen chains; trips the in-graph health guards;
  * ``device-loss``  raise :class:`SimulatedDeviceLoss(keep=m)`: the
                     supervisor must restart on an m-device mesh and restore
                     the checkpoint elastically.

Faults fire ONCE (by default) at their outer step and are then spent — a
rollback replaying the same step numbers does not re-fire them, which is
what makes "faulted run ends bit-identical to the fault-free run"
assertable.  Plans serialize to/from JSON for the launcher's
``--fault-plan`` flag (inline JSON or a path).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["Fault", "FaultPlan", "SimulatedPreemption", "SimulatedDeviceLoss",
           "corrupt_checkpoint", "inject_state_fault"]

KINDS = ("preempt", "corrupt", "nan", "device-loss")


class SimulatedPreemption(RuntimeError):
    """Injected preemption: the step function dies as if SIGKILLed."""


class SimulatedDeviceLoss(RuntimeError):
    """Injected device loss: only ``keep`` devices survive the restart."""

    def __init__(self, keep: int):
        super().__init__(f"simulated device loss: {keep} devices remain")
        self.keep = keep


@dataclasses.dataclass
class Fault:
    """One scripted failure.

    ``step``   outer step index at which it fires (before the step runs);
    ``kind``   one of :data:`KINDS`;
    ``target`` corrupt: "arrays" | "manifest"; nan: "x" | "cache";
    ``mode``   nan fault payload: "nan" | "inf" (cache) — ignored for "x";
    ``keep``   device-loss: devices remaining after the loss;
    ``once``   spent after firing (default) — ``False`` re-fires on replay.
    """
    step: int
    kind: str
    target: str = ""
    mode: str = "nan"
    keep: int = 0
    once: bool = True

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.kind == "corrupt" and self.target not in ("arrays",
                                                          "manifest"):
            raise ValueError("corrupt fault needs target='arrays'|'manifest'")
        if self.kind == "nan" and self.target not in ("x", "cache"):
            raise ValueError("nan fault needs target='x'|'cache'")
        if self.kind == "device-loss" and self.keep < 1:
            raise ValueError("device-loss fault needs keep >= 1")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class FaultPlan:
    """A deterministic schedule of :class:`Fault`\\ s keyed by outer step.

    ``take(step)`` returns the faults due at ``step`` and marks them spent
    (unless ``once=False``); ``fired`` records what actually fired, for
    assertions and the incident log.
    """

    def __init__(self, faults: List[Fault], seed: int = 0):
        self.faults = [f if isinstance(f, Fault) else Fault(**f)
                       for f in faults]
        self.seed = int(seed)
        self._spent: set = set()
        self.fired: List[Dict[str, Any]] = []

    # -- scheduling ---------------------------------------------------------

    def take(self, step: int) -> List[Fault]:
        due = []
        for i, f in enumerate(self.faults):
            if f.step == step and i not in self._spent:
                if f.once:
                    self._spent.add(i)
                due.append(f)
                self.fired.append({"step": step, **f.to_dict()})
        return due

    def pending(self) -> List[Fault]:
        return [f for i, f in enumerate(self.faults) if i not in self._spent]

    # -- serialization ------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "faults": [f.to_dict() for f in self.faults]},
                          indent=1)

    @classmethod
    def from_json(cls, text_or_path: str) -> "FaultPlan":
        """Parse a plan from inline JSON or from a file path."""
        text = text_or_path
        if not text_or_path.lstrip().startswith(("{", "[")):
            with open(text_or_path) as f:
                text = f.read()
        obj = json.loads(text)
        if isinstance(obj, list):                 # bare fault list
            obj = {"faults": obj}
        return cls([Fault(**f) for f in obj.get("faults", [])],
                   seed=obj.get("seed", 0))

    def rng(self, step: int) -> np.random.Generator:
        """The per-step deterministic generator fault application uses."""
        return np.random.default_rng([self.seed, step])


# ---------------------------------------------------------------------------
# Fault application helpers (host-side; the supervisor calls these)
# ---------------------------------------------------------------------------

def corrupt_checkpoint(ckpt_dir: str, target: str,
                       rng: Optional[np.random.Generator] = None) -> str:
    """Damage the newest ``step_*`` dir under ``ckpt_dir`` in place.

    ``target="arrays"`` flips bytes in the middle of ``arrays.npz`` (and
    truncates its tail, so both checksum and load paths can trip);
    ``target="manifest"`` overwrites ``manifest.json`` with junk.  Returns
    the damaged file's path.  No-op ("") when no checkpoint exists yet.
    """
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".corrupt")
                   ) if os.path.isdir(ckpt_dir) else []
    if not steps:
        return ""
    path = os.path.join(ckpt_dir, steps[-1],
                        "arrays.npz" if target == "arrays"
                        else "manifest.json")
    if target == "manifest":
        with open(path, "w") as f:
            f.write("{ not json")
        return path
    size = os.path.getsize(path)
    rng = rng or np.random.default_rng(0)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        f.write(rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
        f.truncate(max(size - 16, size // 2 + 64))
    return path


def inject_state_fault(state, fault: Fault, rng: np.random.Generator, *,
                       chains: Optional[int] = None, chain0: int = 0):
    """Return ``state`` with the NaN/garbage fault applied to a seed-chosen
    chain (on the state's device, no host sync: this runs at a supervisor
    boundary, never in the sweep loop).

    ``chains`` / ``chain0``: a rank of the dist backend holds chains
    ``chain0 .. chain0 + C_loc - 1`` of ``chains``; the chain (and cache
    entry) is drawn over all of them, as on one device, and only the rank
    that holds it writes it -- every model shard of that data shard the
    same code, since they hold the same x."""
    # adaptive wrappers (AdaptiveState / DistAdaptiveState) hold the chain
    # state in .inner; x/cache there are read-only forwarding properties
    if fault.target not in getattr(state, "_fields", ()) \
            and hasattr(state, "inner"):
        return state._replace(inner=inject_state_fault(
            state.inner, fault, rng, chains=chains, chain0=chain0))
    if fault.target == "cache":
        cache = state.cache.clone()
        flat = cache.view(-1)
        total = flat.shape[0] if chains is None else chains
        idx = int(rng.integers(0, total)) - chain0
        if 0 <= idx < flat.shape[0]:
            flat[idx] = math.inf if fault.mode == "inf" else math.nan
        return state._replace(cache=cache)
    x = state.x.clone()
    total = x.shape[0] if chains is None else chains
    c = int(rng.integers(0, total)) - chain0
    i = int(rng.integers(0, x.shape[-1]))
    if 0 <= c < x.shape[0]:
        x[c, ..., i] = np.iinfo(np.int32).min // 2     # out-of-domain code
    return state._replace(x=x)
