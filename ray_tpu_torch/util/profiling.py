"""Kernel-level profiling hooks (reference: Ray exposes torch/nsight
profilers via runtime hooks). On the GPU the profiler is
``torch.profiler``, whose chrome traces open in Perfetto or
chrome://tracing and show each CUDA kernel beside the host code that
launched it.

Three entry points:

- :func:`profile` — context manager around a training/serving region;
  writes one chrome trace of the region (CPU and, where this process sees
  a GPU, CUDA activity) into ``logdir``: the evidence artifact for perf
  work.
- :func:`annotate` — named sub-region (a ``torch.profiler`` range and an
  NVTX range) so framework phases (data load, step, collective) are
  visible between kernels.
- :func:`device_memory_stats` — live device memory of this process's
  current GPU, from ``torch.cuda.memory_stats``.

``profile`` and ``annotate`` degrade to no-ops where the profiler cannot
start, so library code can call them unconditionally.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from typing import Iterator, Optional

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def profile(logdir: str) -> Iterator[str]:
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``logdir`` (one ``trace_<pid>_<ms>.json`` per capture). Returns the
    logdir so callers can print/record the artifact path."""
    os.makedirs(logdir, exist_ok=True)
    prof = None
    try:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    except Exception as e:  # noqa: BLE001 — no profiler here: no-op
        logger.debug("profiler unavailable: %s", e)
        prof = None
    t0 = time.monotonic()
    try:
        yield logdir
    finally:
        if prof is not None:
            try:
                prof.stop()
                path = os.path.join(
                    logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}"
                    ".json")
                prof.export_chrome_trace(path)
                logger.info("profile trace (%.1fs) written to %s",
                            time.monotonic() - t0, path)
            except Exception as e:  # noqa: BLE001
                logger.warning("profiler stop failed: %s", e)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a capture (a host-side bar above the device
    kernels it launched), and an NVTX range where CUDA is up."""
    with contextlib.ExitStack() as stack:
        try:
            import torch

            stack.enter_context(torch.profiler.record_function(name))
            if torch.cuda.is_available():
                stack.enter_context(torch.cuda.nvtx.range(name))
        except Exception:  # noqa: BLE001
            pass
        yield


def device_memory_stats() -> Optional[dict]:
    """Live memory of this process's current GPU (bytes in use by
    tensors, the card's total, the peak in use), or None where this
    process has not brought CUDA up. Cheap enough to poll from monitors:
    it never initialises CUDA itself."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    try:
        dev = torch.cuda.current_device()
        stats = torch.cuda.memory_stats(dev)
        return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "bytes_limit":
                    torch.cuda.get_device_properties(dev).total_memory,
                "peak_bytes_in_use":
                    stats.get("allocated_bytes.all.peak", 0),
                "platform": "gpu"}
    except Exception:  # noqa: BLE001
        return None
