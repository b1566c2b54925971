"""Structured export events for external tooling.

Reference: the reference's export API (``src/ray/util/event.cc`` +
``src/ray/protobuf/export_api/export_*.proto``): state transitions of
tasks/actors/nodes/jobs/PGs are written as self-describing JSON lines to
per-resource files under the session dir, so external systems can tail
them without speaking the internal RPC protocol.

Event envelope (append-only schema, ``schema_version`` bumps on change):

    {"event_id": str, "timestamp": float, "schema_version": 1,
     "source_type": "EXPORT_ACTOR" | "EXPORT_NODE" | "EXPORT_JOB" |
                    "EXPORT_PLACEMENT_GROUP",
     "event_data": {...resource-specific...}}

Files: ``<session>/export_events/event_EXPORT_<TYPE>.log`` (JSONL).
Enabled by the ``enable_export_api`` config flag; writes are buffered
through a lock and never raise into the control plane.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any, Dict, Optional

SCHEMA_VERSION = 1

SOURCE_TYPES = ("EXPORT_ACTOR", "EXPORT_NODE", "EXPORT_JOB",
                "EXPORT_PLACEMENT_GROUP")


class ExportEventLogger:
    """One logger per process; one file per source type."""

    def __init__(self, session_dir: str):
        self._dir = os.path.join(session_dir, "export_events")
        os.makedirs(self._dir, exist_ok=True)
        self._lock = threading.Lock()
        self._files: Dict[str, Any] = {}

    def _file(self, source_type: str):
        f = self._files.get(source_type)
        if f is None:
            path = os.path.join(self._dir,
                                f"event_{source_type}.log")
            f = open(path, "a", buffering=1)
            self._files[source_type] = f
        return f

    def emit(self, source_type: str, event_data: Dict[str, Any]) -> None:
        if source_type not in SOURCE_TYPES:
            raise ValueError(f"unknown export source type {source_type!r}")
        record = {
            "event_id": uuid.uuid4().hex,
            "timestamp": time.time(),
            "schema_version": SCHEMA_VERSION,
            "source_type": source_type,
            "event_data": event_data,
        }
        try:
            with self._lock:
                self._file(source_type).write(
                    json.dumps(record, default=str) + "\n")
        except Exception:  # noqa: BLE001 — observability must never
            pass           # take down the control plane

    def close(self):
        with self._lock:
            for f in self._files.values():
                try:
                    f.close()
                except Exception:  # noqa: BLE001
                    pass
            self._files.clear()


def read_export_events(session_dir: str,
                       source_type: Optional[str] = None) -> list:
    """Test/tooling helper: load export events back as dicts."""
    out = []
    d = os.path.join(session_dir, "export_events")
    if not os.path.isdir(d):
        return out
    for fname in sorted(os.listdir(d)):
        if source_type is not None and source_type not in fname:
            continue
        with open(os.path.join(d, fname)) as f:
            for line in f:
                if line.strip():
                    out.append(json.loads(line))
    return out
