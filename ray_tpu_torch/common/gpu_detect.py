"""GPU autodetection (the port's counterpart of ``tpu_detect.py``).

Reference: ``python/ray/_private/accelerators/nvidia_gpu.py`` — GPUs are
counted from ``CUDA_VISIBLE_DEVICES`` when it is set, else from the
driver's device list. Here the order is ``CUDA_VISIBLE_DEVICES``, then
``/proc/driver/nvidia/gpus/*``, then ``nvidia-smi -L`` under a timeout.

Detection never initialises CUDA: ``torch.cuda.is_available()`` calls
``cuInit``, and a CUDA context created in a process before ``fork`` breaks
every forked child ("Cannot re-initialize CUDA in forked subprocess").
The raylet and the worker factory run this before they fork workers.
"""

from __future__ import annotations

import glob
import os
import subprocess
from typing import List, Optional


def visible_device_ids(env: Optional[dict] = None) -> Optional[List[str]]:
    """The entries of ``CUDA_VISIBLE_DEVICES`` (indices or UUIDs), or None
    when it is unset. An empty value hides every GPU."""
    env = os.environ if env is None else env
    raw = env.get("CUDA_VISIBLE_DEVICES")
    if raw is None:
        return None
    ids = [d.strip() for d in raw.split(",") if d.strip()]
    # CUDA stops at the first invalid entry ("-1" is the usual way to hide)
    out = []
    for d in ids:
        if d.lstrip("-").isdigit() and int(d) < 0:
            break
        out.append(d)
    return out


def _nvidia_smi_count(timeout: float) -> Optional[int]:
    try:
        res = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=timeout, check=False)
    except (OSError, subprocess.SubprocessError):
        return None
    if res.returncode != 0:
        return None
    return sum(1 for line in res.stdout.splitlines()
               if line.startswith("GPU "))


def detect(timeout: float = 10.0) -> int:
    """Number of GPUs this node offers; 0 on a machine without one."""
    ids = visible_device_ids()
    if ids is not None:
        return len(ids)
    procs = glob.glob("/proc/driver/nvidia/gpus/*")
    if procs:
        return len(procs)
    return _nvidia_smi_count(timeout) or 0


def device_ids_for(instances, node_visible: Optional[List[str]]) -> list:
    """The device ids a worker granted the node's GPU ``instances`` must
    name in its ``CUDA_VISIBLE_DEVICES``: instance ``i`` is the ``i``-th
    device the node itself sees (``node_visible``, its own
    ``CUDA_VISIBLE_DEVICES``, when set). A count declared beyond those
    devices (``init(num_gpus=...)`` on a CPU host) names the index."""
    vis = node_visible or []
    return [vis[int(i)] if int(i) < len(vis) else int(i)
            for i in instances]
