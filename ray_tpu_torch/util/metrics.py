"""Metrics API (reference ``python/ray/util/metrics.py`` — Counter/Gauge/
Histogram backed by the C++ OpenCensus pipeline, SURVEY.md §5).

Here: a per-process registry; workers push snapshots to the GCS internal
KV under the ``metrics`` namespace (keyed by worker id), and
``collect_cluster_metrics`` aggregates — the role of the reference's
per-node metrics agent + Prometheus scrape, without the HTTP hop.
``prometheus_text`` renders the standard exposition format.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: Dict[Tuple[str, tuple], "_Metric"] = {}


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._values: Dict[tuple, float] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            _registry[(name, self.tag_keys)] = self

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _tagkey(self, tags: Optional[Dict[str, str]]) -> tuple:
        merged = {**self._default_tags, **(tags or {})}
        return tuple(merged.get(k, "") for k in self.tag_keys)

    def snapshot(self) -> dict:
        with self._lock:
            values = {",".join(k): v for k, v in self._values.items()}
        return {"name": self.name, "kind": self.kind,
                "description": self.description,
                "tag_keys": list(self.tag_keys), "values": values}


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("counters only increase")
        k = self._tagkey(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values[self._tagkey(tags)] = float(value)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = (),
                 tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries) or [0.1, 1, 10, 100]
        self._counts: Dict[tuple, List[int]] = {}
        self._sums: Dict[tuple, float] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        k = self._tagkey(tags)
        with self._lock:
            counts = self._counts.setdefault(
                k, [0] * (len(self.boundaries) + 1))
            counts[bisect.bisect_left(self.boundaries, value)] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value

    def snapshot(self) -> dict:
        with self._lock:
            return {"name": self.name, "kind": self.kind,
                    "description": self.description,
                    "tag_keys": list(self.tag_keys),
                    "boundaries": self.boundaries,
                    "counts": {",".join(k): v
                               for k, v in self._counts.items()},
                    "sums": {",".join(k): v for k, v in self._sums.items()}}


def local_snapshots() -> List[dict]:
    with _registry_lock:
        metrics = list(_registry.values())
    return [m.snapshot() for m in metrics]


def push_metrics() -> None:
    """Push this process's metrics to the GCS (worker→agent equivalent)."""
    from ray_tpu_torch.core_worker.worker import CoreWorker

    cw = CoreWorker.current_or_raise()
    payload = json.dumps({"ts": time.time(),
                          "metrics": local_snapshots()}).encode()
    cw.gcs.kv_put("metrics", cw.worker_id.hex(), payload, overwrite=True)


def collect_cluster_metrics() -> Dict[str, List[dict]]:
    """Aggregate every worker's pushed snapshots (agent scrape role)."""
    from ray_tpu_torch.core_worker.worker import CoreWorker

    gcs = CoreWorker.current_or_raise().gcs
    out: Dict[str, List[dict]] = {}
    for key in gcs.kv_keys("metrics"):
        blob = gcs.kv_get("metrics", key)
        if blob is None:
            continue
        snap = json.loads(blob)
        for m in snap["metrics"]:
            out.setdefault(m["name"], []).append(m)
    return out


def prometheus_text() -> str:
    """Local registry in Prometheus exposition format."""
    lines = []
    for m in local_snapshots():
        name = m["name"].replace(".", "_")
        if m["description"]:
            lines.append(f"# HELP {name} {m['description']}")
        lines.append(f"# TYPE {name} {m['kind'] if m['kind'] != 'histogram' else 'histogram'}")  # noqa: E501
        if m["kind"] == "histogram":
            for tagv, counts in m.get("counts", {}).items():
                labels = _labels(m["tag_keys"], tagv)
                cum = 0
                for bound, c in zip(m["boundaries"] + [float("inf")],
                                    counts):
                    cum += c
                    le = "+Inf" if bound == float("inf") else repr(bound)
                    sep = "," if labels else ""
                    lines.append(
                        f'{name}_bucket{{{labels}{sep}le="{le}"}} {cum}')
                lines.append(f"{name}_count{{{labels}}} {cum}")
                lines.append(
                    f"{name}_sum{{{labels}}} {m['sums'].get(tagv, 0.0)}")
        else:
            for tagv, v in m.get("values", {}).items():
                lines.append(f"{name}{{{_labels(m['tag_keys'], tagv)}}} {v}")
    # RPC handler loop timings (IoContext.record) as cumulative counters —
    # rate(rt_rpc_handler_seconds_sum[1m]) is per-handler loop load
    try:
        from ray_tpu_torch.rpc.rpc import IoContext

        io = IoContext._singleton
        stats = dict(io.stats) if io is not None else {}
    except Exception:  # noqa: BLE001
        stats = {}
    if stats:
        lines.append("# TYPE rt_rpc_handler_seconds summary")
        for handler, (count, total) in sorted(stats.items()):
            h = handler.replace('"', "")
            lines.append(
                f'rt_rpc_handler_seconds_count{{handler="{h}"}} {count}')
            lines.append(
                f'rt_rpc_handler_seconds_sum{{handler="{h}"}} {total:.6f}')
    return "\n".join(lines) + "\n"


def _labels(tag_keys: List[str], tagv: str) -> str:
    vals = tagv.split(",") if tagv else []
    return ",".join(f'{k}="{v}"' for k, v in zip(tag_keys, vals))
