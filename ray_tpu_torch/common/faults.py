"""Deterministic fault injection at named points (port of
``ray_tpu/common/faults.py``, cut to the points the LLM engine declares).

A place that may fail declares a *named fault point*::

    from ray_tpu_torch.common import faults
    faults.fault_point("serve.llm.prefix_match")

With nothing armed — the production state — ``fault_point`` is one
module-level flag check and a return. When a schedule is armed for the
name, the call raises :class:`FaultInjected` (a ``ConnectionError``)
according to the schedule:

* ``once``        — fire on the first hit only
* ``nth:K``       — fire on the K-th hit only (1-based)
* ``every:K``     — fire on every K-th hit
* ``always``      — fire on every hit (alias for ``every:1``)
* ``prob:P[:S]``  — fire with probability P from a seeded RNG (seed S,
  default 0)

Arm with :func:`inject`, disarm and reset the counters with :func:`clear`
(same process only).
"""

from __future__ import annotations

import random
import threading
from typing import Dict

__all__ = ["FAULT_POINTS", "FaultInjected", "fault_point", "inject",
           "clear", "hits", "fired"]


class FaultInjected(ConnectionError):
    """Raised at an armed fault point; a ``ConnectionError``, so a caller
    that handles a torn connection handles it the same way."""

    def __init__(self, point: str):
        super().__init__(f"injected fault at {point}")
        self.point = point

    def __reduce__(self):
        return (FaultInjected, (self.point,))


# name -> where it fires
FAULT_POINTS: Dict[str, str] = {
    "serve.llm.prefix_match": (
        "LLM engine admission, before walking the radix prefix cache — "
        "the lookup is skipped and the request degrades to a cold "
        "prefill with a typed counter bump (prefix_match_faults)"),
    "serve.llm.prefix_insert": (
        "LLM engine, before sharing a finished prefill's blocks into the "
        "radix tree — the insert is skipped whole with a typed counter "
        "bump (prefix_insert_faults); the blocks stay owned by the slot"),
}

# _ACTIVE is the hot-path gate; all mutation happens under _lock
_ACTIVE = False
_lock = threading.Lock()
_schedules: Dict[str, "_Schedule"] = {}
_hit_counts: Dict[str, int] = {}
_fired_counts: Dict[str, int] = {}


class _Schedule:
    """One armed fault point's firing rule. Mutated under _lock only."""

    __slots__ = ("spec", "kind", "k", "prob", "rng", "hits", "done")

    def __init__(self, spec: str):
        self.spec = spec
        self.hits = 0
        self.done = False
        kind, _, rest = spec.partition(":")
        kind = kind.strip().lower()
        if kind == "once":
            self.kind, self.k = "nth", 1
        elif kind == "always":
            self.kind, self.k = "every", 1
        elif kind in ("nth", "every"):
            self.kind, self.k = kind, int(rest)
            if self.k < 1:
                raise ValueError(f"{kind}:K needs K >= 1, got {spec!r}")
        elif kind == "prob":
            p, _, seed = rest.partition(":")
            self.kind = "prob"
            self.prob = float(p)
            if not 0.0 <= self.prob <= 1.0:
                raise ValueError(f"prob:P needs 0 <= P <= 1, got {spec!r}")
            self.rng = random.Random(int(seed) if seed else 0)
        else:
            raise ValueError(
                f"unknown fault schedule {spec!r} "
                "(want once | nth:K | every:K | always | prob:P[:seed])")

    def should_fire(self) -> bool:
        self.hits += 1
        if self.kind == "nth":
            if self.done or self.hits != self.k:
                return False
            self.done = True
            return True
        if self.kind == "every":
            return self.hits % self.k == 0
        return self.rng.random() < self.prob


def inject(point: str, schedule: str = "once") -> None:
    """Arm one fault point in this process."""
    global _ACTIVE
    if point not in FAULT_POINTS:
        raise ValueError(
            f"unknown fault point {point!r}; known: {sorted(FAULT_POINTS)}")
    sched = _Schedule(schedule)
    with _lock:
        _schedules[point] = sched
        _ACTIVE = True


def clear() -> None:
    """Disarm everything and reset the counters."""
    global _ACTIVE
    with _lock:
        _schedules.clear()
        _hit_counts.clear()
        _fired_counts.clear()
        _ACTIVE = False


def hits(point: str) -> int:
    """How many times an armed ``fault_point(point)`` was reached."""
    with _lock:
        return _hit_counts.get(point, 0)


def fired(point: str) -> int:
    """How many times ``fault_point(point)`` raised."""
    with _lock:
        return _fired_counts.get(point, 0)


def fault_point(name: str) -> None:
    """Declare a named fault point; raise if a fault is armed for it."""
    if not _ACTIVE:
        return
    with _lock:
        sched = _schedules.get(name)
        if sched is None:
            return
        _hit_counts[name] = _hit_counts.get(name, 0) + 1
        if not sched.should_fire():
            return
        _fired_counts[name] = _fired_counts.get(name, 0) + 1
    raise FaultInjected(name)
