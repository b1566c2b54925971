"""State API (reference ``python/ray/util/state/api.py`` — StateApiClient,
list_actors:783, list_tasks:1010; server side ``state_aggregator.py`` +
``gcs_task_manager.cc``).

Queries the GCS directly; every listing returns plain dicts.
``chrome_tracing_dump`` renders task events as a chrome://tracing JSON
array exactly like the reference's ``ray timeline``
(``_private/state.py:438``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


def _gcs():
    from ray_tpu_torch.core_worker.worker import CoreWorker

    return CoreWorker.current_or_raise().gcs


def list_nodes() -> List[Dict[str, Any]]:
    out = []
    for n in _gcs().get_all_nodes():
        out.append({
            "node_id": n["node_id"].hex() if isinstance(n["node_id"], bytes)
            else n["node_id"],
            "state": "ALIVE" if n["alive"] else "DEAD",
            "address": tuple(n["address"]),
            "resources_total": n["resources"]["total"],
            "resources_available": n["resources"]["available"],
            "labels": n["resources"].get("labels", {}),
        })
    return out


def list_actors() -> List[Dict[str, Any]]:
    return _gcs().call("list_actors")


def list_jobs() -> List[Dict[str, Any]]:
    return _gcs().call("get_all_jobs")


def list_placement_groups() -> List[Dict[str, Any]]:
    return _gcs().call("list_placement_groups")


def list_tasks(job_id: Optional[bytes] = None,
               limit: int = 10_000) -> List[Dict[str, Any]]:
    return _gcs().call("get_task_events", job_id=job_id, limit=limit)


def summarize_tasks() -> Dict[str, Dict[str, Any]]:
    """Per-task-name counts + latency stats (reference ``ray summary
    tasks``)."""
    summary: Dict[str, Dict[str, Any]] = {}
    for ev in list_tasks():
        s = summary.setdefault(ev.get("name", "task"), {
            "count": 0, "failed": 0, "total_s": 0.0, "max_s": 0.0})
        dur = max(0.0, ev.get("end_ts", 0) - ev.get("start_ts", 0))
        s["count"] += 1
        s["failed"] += ev.get("state") == "FAILED"
        s["total_s"] += dur
        s["max_s"] = max(s["max_s"], dur)
    for s in summary.values():
        s["mean_s"] = s["total_s"] / max(s["count"], 1)
    return summary


def chrome_tracing_dump(path: Optional[str] = None) -> List[dict]:
    """Task events → chrome://tracing 'X' (complete) events. Tracing
    spans recorded in THIS process (util/tracing.py) render in the same
    file, under their own 'trace' process lane."""
    from ray_tpu_torch.util import tracing as _tracing

    events = _tracing.spans_to_chrome_events(
        _tracing.recorder().snapshot())
    for ev in list_tasks():
        events.append({
            "name": ev.get("name", "task"),
            "cat": "actor_task" if ev.get("actor_task") else "task",
            "ph": "X",
            "ts": ev.get("start_ts", 0) * 1e6,
            "dur": max(0.0, ev.get("end_ts", 0) - ev.get("start_ts", 0))
            * 1e6,
            "pid": ev.get("node_id", "")[:8],
            "tid": ev.get("worker_id", "")[:8],
            "args": {"task_id": ev.get("task_id", ""),
                     "state": ev.get("state", "")},
        })
    if path is not None:
        with open(path, "w") as f:
            json.dump(events, f)
    return events
