"""Deterministic fault injection at named points (port of
``ray_tpu/common/faults.py``, cut to the points the port declares: the
runtime's get/put/lease path, Serve and the LLM engine).

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

Configuration, in precedence order:

1. :func:`inject` / :func:`clear` (same process only).
2. ``RT_FAULTS`` — comma-separated ``point=schedule`` pairs, inherited by
   spawned worker processes, e.g. ``RT_FAULTS=transfer.pull.recv=once``.
3. The ``testing_faults`` config flag (same syntax), so a test cluster can
   arm its children through ``system_config``.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Dict

__all__ = ["FAULT_POINTS", "FaultInjected", "fault_point", "inject",
           "clear", "configure", "hits", "fired", "active_points"]


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
    "transfer.server.send": (
        "TransferServer response path, before any bytes of the payload "
        "are written back — the puller sees a dead/early-EOF holder"),
    "transfer.pull.connect": (
        "pull_object leader, before connecting to the holder — "
        "connection refused / holder unreachable"),
    "transfer.pull.recv": (
        "pull_object leader, after the request is sent and before the "
        "response header is read — mid-pull holder death"),
    "transfer.pull.dedup_wait": (
        "pull_object follower, before waiting on the leader's event — "
        "exercises the follower deadline/error propagation path"),
    "gcs.rpc.send": (
        "GcsClient, before dispatching any RPC to the control plane — "
        "GCS unreachable"),
    "raylet.lease.request": (
        "NormalTaskSubmitter, before sending request_worker_lease(s) "
        "to a raylet — raylet died before granting"),
    "raylet.lease.return": (
        "NormalTaskSubmitter, before sending return_worker to a raylet "
        "— raylet died holding our lease"),
    "worker.task.push": (
        "NormalTaskSubmitter, before pushing a task to a leased worker "
        "— worker crashed between lease grant and task delivery"),
    "rl.fragment.push": (
        "Podracer Sebulba runner, after sealing a fragment batch and "
        "before pushing its ref into the runner's fragment channel — "
        "the handoff dies; the runner counts the drop and keeps acting"),
    "rl.params.broadcast": (
        "Podracer Sebulba learner, before writing a weights broadcast "
        "to one runner's param channel — that runner misses the version "
        "(policy lag grows) and catches up on the next broadcast"),
    "spill.write": (
        "ShmObjectStore spill engine, before writing a spill file — "
        "disk full / IO error on the spill path"),
    "pubsub.publish": (
        "Publisher.publish — the message is silently DROPPED (not "
        "raised) to model a lost control-plane event"),
    "graph.channel.write": (
        "ShmChannel.write, before serializing the payload into the "
        "mutable shm segment — a compiled-pipeline hop dies mid-stream "
        "(both stage exec loops and the driver's execute() cross it)"),
    "graph.channel.read": (
        "ShmChannel.read, before waiting on the segment's version bump — "
        "the reading end of a pipeline hop dies / loses the segment"),
    "serve.replica.call": (
        "Serve replica harness, before invoking the user callable for a "
        "unary or micro-batched request — the whole call fails like a "
        "torn transport; the proxy re-routes to a fresh replica"),
    "serve.replica.stream": (
        "Serve replica harness, before the streaming generator yields "
        "its first item — mid-stream replica death; the proxy surfaces "
        "a clean `event: error` SSE frame"),
    "serve.proxy.write": (
        "ProxyActor HTTP write path, before response/chunk bytes hit "
        "the socket — the client connection tears mid-write; the "
        "listener and other connections stay healthy"),
    "serve.controller.probe": (
        "ServeController health probe, before pinging a replica — a "
        "lost/slow probe; flap damping requires failure_threshold "
        "consecutive misses before ejecting the replica"),
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


def _parse_spec_string(spec: str) -> Dict[str, "_Schedule"]:
    """``"a=once,b=nth:3"`` -> {point: schedule}. Unknown point names are
    rejected: a typo'd RT_FAULTS that arms nothing tests nothing."""
    out: Dict[str, _Schedule] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, sched = part.partition("=")
        name = name.strip()
        if not sep:
            raise ValueError(
                f"bad RT_FAULTS entry {part!r} (want point=schedule)")
        if name not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {name!r}; known: {sorted(FAULT_POINTS)}")
        out[name] = _Schedule(sched.strip())
    return out


def configure(spec: str) -> None:
    """Replace the armed set from a spec string (RT_FAULTS syntax)."""
    global _ACTIVE
    parsed = _parse_spec_string(spec)
    with _lock:
        _schedules.clear()
        _schedules.update(parsed)
        _ACTIVE = bool(_schedules)


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


def active_points() -> Dict[str, str]:
    """Currently armed {point: spec} (for diagnostics)."""
    with _lock:
        return {name: s.spec for name, s in _schedules.items()}


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


def _load_from_env() -> None:
    """Arm from RT_FAULTS / testing_faults at import (each process)."""
    spec = os.environ.get("RT_FAULTS", "")
    if not spec:
        # config is imported lazily: faults must import without it
        try:
            from ray_tpu_torch.common.config import GLOBAL_CONFIG
            spec = GLOBAL_CONFIG.get("testing_faults") or ""
        except Exception:  # noqa: BLE001 - config unavailable = faults off
            spec = ""
    if spec:
        configure(spec)


_load_from_env()
