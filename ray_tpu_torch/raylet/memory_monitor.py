"""Memory monitor + OOM worker-killing policy.

Reference: ``src/ray/common/memory_monitor.h`` (threshold check against
cgroup/system usage on a refresh interval) and
``src/ray/raylet/worker_killing_policy_group_by_owner.cc`` (victim
selection: prefer retriable work, then newest). The raylet kills a worker
BEFORE the kernel OOM-killer fires — a kernel OOM takes out an arbitrary
process (possibly the raylet itself); a policy kill converts it into one
retriable task failure with an attributable cause.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, List, Optional, Tuple

logger = logging.getLogger(__name__)

_CGROUP_V1_LIMIT = "/sys/fs/cgroup/memory/memory.limit_in_bytes"
_CGROUP_V1_USAGE = "/sys/fs/cgroup/memory/memory.usage_in_bytes"
_CGROUP_V2_LIMIT = "/sys/fs/cgroup/memory.max"
_CGROUP_V2_USAGE = "/sys/fs/cgroup/memory.current"
# cgroup files report this when unconstrained
_UNLIMITED = 1 << 60


def _read_int(path: str) -> Optional[int]:
    try:
        with open(path) as f:
            raw = f.read().strip()
        return None if raw == "max" else int(raw)
    except (OSError, ValueError):
        return None


def system_memory() -> Tuple[int, int]:
    """(used_bytes, total_bytes) — cgroup limits win over /proc/meminfo
    (inside a container the host total is a lie)."""
    for limit_path, usage_path in ((_CGROUP_V2_LIMIT, _CGROUP_V2_USAGE),
                                   (_CGROUP_V1_LIMIT, _CGROUP_V1_USAGE)):
        limit = _read_int(limit_path)
        usage = _read_int(usage_path)
        if limit is not None and usage is not None and limit < _UNLIMITED:
            return usage, limit
    total = avail = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
    except OSError:
        pass
    if total is None or avail is None:
        return 0, 1
    return total - avail, total


def process_rss(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError):
        pass
    return 0


class MemoryMonitor:
    """Polls usage; above the threshold, picks a victim worker.

    ``usage_fn`` is injectable for tests (default: real system memory).
    """

    def __init__(self, threshold: float,
                 usage_fn: Callable[[], Tuple[int, int]] = system_memory,
                 min_interval_s: float = 0.25):
        self.threshold = threshold
        self._usage_fn = usage_fn
        self._min_interval = min_interval_s
        self._last_check = 0.0
        self._last_result = (0, 1)

    def is_pressured(self) -> Tuple[bool, float]:
        now = time.monotonic()
        if now - self._last_check >= self._min_interval:
            self._last_check = now
            self._last_result = self._usage_fn()
        used, total = self._last_result
        frac = used / max(total, 1)
        return frac >= self.threshold, frac


def pick_victim(workers: List, rss_fn: Callable[[int], int] = process_rss):
    """Reference policy (worker_killing_policy_group_by_owner.cc): among
    killable workers, prefer (1) retriable leased tasks over actors,
    (2) the NEWEST work first (LIFO — it has lost the least progress),
    breaking ties by largest RSS so one kill actually relieves pressure."""
    candidates = []
    for w in workers:
        if w.state not in ("LEASED", "ACTOR") or w.pid is None:
            continue
        if not w.alive():
            continue
        retriable = w.state == "LEASED"  # tasks retry; actors restart at cost
        rss = rss_fn(w.pid)
        candidates.append((retriable, w.idle_since, rss, w))
    if not candidates:
        return None
    candidates.sort(key=lambda t: (not t[0], -t[1], -t[2]))
    return candidates[0][3]
