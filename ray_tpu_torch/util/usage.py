"""Usage stats (reference: ``python/ray/_private/usage/usage_lib.py`` +
``usage.proto`` — opt-out cluster metadata pings).

This environment is zero-egress, so the reference's HTTPS ping becomes a
local JSON report in the session directory — same schema intent (what
ran, which libraries, cluster shape), same opt-out contract
(``RT_usage_stats_enabled=0`` / ``RAY_USAGE_STATS_ENABLED=0``), no
network I/O ever. Operators aggregate the files themselves if they want
fleet data.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, Set

_lock = threading.Lock()
_library_usages: Set[str] = set()
_feature_usages: Set[str] = set()


def usage_stats_enabled() -> bool:
    for var in ("RT_usage_stats_enabled", "RAY_USAGE_STATS_ENABLED"):
        v = os.environ.get(var)
        if v is not None:
            return v not in ("0", "false", "False")
    return True


def record_library_usage(name: str) -> None:
    """Libraries note first use (reference: record_library_usage calls
    sprinkled through data/train/tune/serve/rllib __init__s)."""
    with _lock:
        _library_usages.add(name)


def record_feature_usage(name: str) -> None:
    with _lock:
        _feature_usages.add(name)


def _cluster_shape() -> Dict[str, Any]:
    try:
        import ray_tpu_torch

        res = ray_tpu_torch.cluster_resources()
        return {"total_resources": res,
                "num_gpus": res.get("GPU", 0)}
    except Exception:  # noqa: BLE001 — no cluster
        return {}


def build_report() -> Dict[str, Any]:
    from ray_tpu_torch import __version__

    # torch only if this process loaded it: the report imports nothing
    torch = sys.modules.get("torch")
    with _lock:
        libs = sorted(_library_usages)
        feats = sorted(_feature_usages)
    return {
        "schema_version": 1,
        "timestamp": time.time(),
        "ray_tpu_torch_version": __version__,
        "python_version": sys.version.split()[0],
        "torch_version": torch.__version__ if torch is not None else None,
        "library_usages": libs,
        "feature_usages": feats,
        **_cluster_shape(),
    }


def write_report(session_dir: str) -> str:
    """Called at shutdown by the driver (no-op when opted out)."""
    if not usage_stats_enabled():
        return ""
    try:
        os.makedirs(session_dir, exist_ok=True)
        path = os.path.join(session_dir, "usage_stats.json")
        with open(path, "w") as f:
            json.dump(build_report(), f, indent=2, sort_keys=True)
        return path
    except Exception:  # noqa: BLE001 — telemetry must never break exit
        return ""
