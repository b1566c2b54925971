"""Per-worker cgroup resource isolation.

Reference: ``src/ray/common/cgroup2/`` (cgroup manager placing worker
processes into a node-scoped cgroup subtree with memory limits, so a
runaway worker is contained by the kernel instead of taking down the
raylet). Enabled via config flag ``cgroup_isolation_enabled``; degrades to
a no-op when the cgroup filesystem isn't writable (non-root, or cgroup
delegation not granted) — the memory monitor remains the fallback line of
defense either way.

Supports cgroup v1 (memory controller dir) and v2 (unified hierarchy).
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Optional

logger = logging.getLogger(__name__)

_V1_ROOT = "/sys/fs/cgroup/memory"
_V2_ROOT = "/sys/fs/cgroup"


class CgroupManager:
    def __init__(self, node_id_hex: str):
        self._base: Optional[str] = None
        self._v2 = False
        base_name = f"rtt_{node_id_hex[:12]}"
        if os.path.isdir(_V1_ROOT):
            base = os.path.join(_V1_ROOT, base_name)
        elif os.path.exists(os.path.join(_V2_ROOT, "cgroup.controllers")):
            base = os.path.join(_V2_ROOT, base_name)
            self._v2 = True
        else:
            logger.info("no cgroup hierarchy found; isolation disabled")
            return
        try:
            os.makedirs(base, exist_ok=True)
            self._base = base
        except OSError as e:
            logger.info("cgroup fs not writable (%s); isolation disabled", e)

    @property
    def enabled(self) -> bool:
        return self._base is not None

    def create_worker_cgroup(self, worker_id_hex: str,
                             memory_bytes: Optional[int] = None) -> Optional[str]:
        """Returns the cgroup dir, or None when disabled/failed."""
        if self._base is None:
            return None
        path = os.path.join(self._base, f"w_{worker_id_hex[:12]}")
        try:
            os.makedirs(path, exist_ok=True)
            if memory_bytes:
                limit_file = "memory.max" if self._v2 \
                    else "memory.limit_in_bytes"
                with open(os.path.join(path, limit_file), "w") as f:
                    f.write(str(int(memory_bytes)))
            return path
        except OSError as e:
            logger.warning("worker cgroup setup failed: %s", e)
            return None

    @staticmethod
    def attach(path: str, pid: int) -> bool:
        try:
            with open(os.path.join(path, "cgroup.procs"), "w") as f:
                f.write(str(pid))
            return True
        except OSError as e:
            logger.warning("cgroup attach of pid %s failed: %s", pid, e)
            return False

    def remove_worker_cgroup(self, worker_id_hex: str) -> None:
        if self._base is None:
            return
        path = os.path.join(self._base, f"w_{worker_id_hex[:12]}")
        try:  # a cgroup dir with dead members removes with rmdir
            os.rmdir(path)
        except OSError:
            pass

    def cleanup(self) -> None:
        if self._base is None:
            return
        for name in os.listdir(self._base):
            try:
                os.rmdir(os.path.join(self._base, name))
            except OSError:
                pass
        try:
            os.rmdir(self._base)
        except OSError:
            pass
        self._base = None
