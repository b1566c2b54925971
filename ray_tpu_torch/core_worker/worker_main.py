"""Worker process entrypoint, forked by the raylet.

Reference analogue: python/ray/_private/workers/default_worker.py — connects
back to its raylet, registers, then serves tasks until told to exit.

Log streaming (reference: python/ray/_private/log_monitor.py): stdout and
stderr stay redirected to the per-worker session log file (the raylet set
that up at fork), and are additionally tee'd — batched on a flusher thread,
never on the task's critical path — to the GCS ``worker_log`` pubsub
channel, which subscribed drivers print with a ``(pid=…)`` prefix.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from ray_tpu_torch.common.ids import NodeID, WorkerID
from ray_tpu_torch.rpc.rpc import RetryableRpcClient


class _LogPublisher:
    """Batches tee'd lines and ships them to the GCS off the hot path."""

    def __init__(self, gcs_address, worker_id_hex: str):
        self._gcs_address = gcs_address
        self._worker_id = worker_id_hex
        self._lock = threading.Lock()
        self._bufs = {"stdout": [], "stderr": []}
        self._partial = {"stdout": "", "stderr": ""}
        self._client = None
        t = threading.Thread(target=self._flush_loop, daemon=True,
                             name="rt-log-pub")
        t.start()

    @staticmethod
    def _context():
        """(job_hex, actor_name) of whatever this worker is running."""
        from .worker import CoreWorker

        cw = CoreWorker._current
        if cw is None:
            return "", ""
        inst = getattr(cw, "_actor_instance", None)
        return (getattr(cw, "current_job_hex", "") or "",
                type(inst).__name__ if inst is not None else "")

    def feed(self, stream: str, text: str):
        with self._lock:
            whole = self._partial[stream] + text
            lines = whole.split("\n")
            self._partial[stream] = lines.pop()  # tail w/o newline
            self._bufs[stream].extend(ln for ln in lines if ln)

    def _flush_loop(self):
        from ray_tpu_torch.common.config import GLOBAL_CONFIG

        interval = GLOBAL_CONFIG.get("worker_log_flush_interval_s")
        while True:
            time.sleep(interval)
            with self._lock:
                batches = {s: b for s, b in self._bufs.items() if b}
                for s in batches:
                    self._bufs[s] = []
            if not batches:
                continue
            job_hex, actor_name = self._context()
            try:
                if self._client is None:
                    self._client = RetryableRpcClient(self._gcs_address,
                                                      deadline_s=5.0)
                for stream, lines in batches.items():
                    self._client.call(
                        "publish_worker_log", job_id=job_hex,
                        pid=os.getpid(), worker_id=self._worker_id[:8],
                        stream=stream, lines=lines[:1000],
                        actor_name=actor_name)
            except Exception:  # noqa: BLE001 — log relay is best-effort
                self._client = None


class _TeeStream:
    """File-like wrapper: pass-through to the log file + feed the relay."""

    def __init__(self, base, name: str, publisher: _LogPublisher):
        self._base = base
        self._name = name
        self._pub = publisher

    def write(self, s):
        n = self._base.write(s)
        try:
            self._pub.feed(self._name, s)
        except Exception:  # noqa: BLE001
            pass
        return n

    def flush(self):
        self._base.flush()

    def fileno(self):
        return self._base.fileno()

    def isatty(self):
        return False

    @property
    def encoding(self):
        return getattr(self._base, "encoding", "utf-8")


def main():
    logging.basicConfig(
        level=os.environ.get("RT_LOG_LEVEL", "INFO"),
        format=f"[worker {os.getpid()}] %(levelname)s %(name)s: %(message)s",
    )
    # SIGUSR1 → all-thread stack dump to the worker log (stderr), the
    # equivalent of the reference's `ray stack` debugging entry point.
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    worker_id = WorkerID.from_hex(os.environ["RT_WORKER_ID"])
    raylet_host, _, raylet_port = os.environ["RT_RAYLET_ADDR"].partition(":")
    gcs_host, _, gcs_port = os.environ["RT_GCS_ADDR"].partition(":")
    node_id = NodeID.from_hex(os.environ["RT_NODE_ID"])

    from ray_tpu_torch.common.config import GLOBAL_CONFIG

    if GLOBAL_CONFIG.get("log_to_driver"):
        import sys

        pub = _LogPublisher((gcs_host, int(gcs_port)), worker_id.hex())
        sys.stdout = _TeeStream(sys.stdout, "stdout", pub)
        sys.stderr = _TeeStream(sys.stderr, "stderr", pub)

    from .worker import MODE_WORKER, CoreWorker

    # boot timing: the warm-pool supply rate IS this path (worker_factory
    # fork → CoreWorker init → register); keep it observable
    t_boot = time.monotonic()
    cw = CoreWorker(
        mode=MODE_WORKER,
        gcs_address=(gcs_host, int(gcs_port)),
        raylet_address=(raylet_host, int(raylet_port)),
        node_id=node_id,
        worker_id=worker_id,
    )
    t_cw = time.monotonic()
    # Raylet-death watchdog — started BEFORE registration: a worker
    # forked moments before its raylet was SIGKILLed (multi-process
    # shape crash) would otherwise sit in the registration retry loop as
    # an orphan. A crashed raylet never runs its worker-reaping stop
    # path, and factory-forked workers aren't even its direct children,
    # so this probe is the only reaper. Three consecutive failures ≈
    # raylet gone, not merely busy (loop p99 under churn is ~30 ms).
    period = GLOBAL_CONFIG.get("worker_raylet_death_check_s")
    if period > 0:
        threading.Thread(
            target=_raylet_death_watchdog,
            args=((raylet_host, int(raylet_port)), period),
            daemon=True, name="raylet-death-watch").start()
    raylet = RetryableRpcClient((raylet_host, int(raylet_port)))
    reply = raylet.call(
        "register_worker", worker_id=worker_id.binary(),
        address=cw.server.address,
        # advertised to lease holders for the native task-dispatch channel
        fast_port=cw._fast_port)
    spawn_t = float(os.environ.get("RT_SPAWN_T") or t_boot)
    child_t = float(os.environ.get("RT_CHILD_T") or t_boot)
    logging.getLogger(__name__).info(
        "worker boot: spawn-to-fork %.0fms, fork-to-entry %.0fms, "
        "core_worker %.0fms, register %.0fms",
        1e3 * (child_t - spawn_t), 1e3 * (t_boot - child_t),
        1e3 * (t_cw - t_boot), 1e3 * (time.monotonic() - t_cw))
    if not reply.get("ok"):
        return  # raylet doesn't know us: die quietly
    while True:
        time.sleep(3600)


def _raylet_death_watchdog(raylet_addr, period: float) -> None:
    from ray_tpu_torch.rpc.rpc import RpcClient

    misses = 0
    probe = None
    while True:
        time.sleep(period)
        try:
            if probe is None:
                probe = RpcClient(raylet_addr)
            probe.call("health_check", timeout=max(3.0, period))
            misses = 0
        except Exception:  # noqa: BLE001 — count toward the threshold
            try:
                if probe is not None:
                    probe.close()
            except Exception:  # noqa: BLE001
                pass
            probe = None
            misses += 1
            if misses >= 3:
                logging.getLogger(__name__).warning(
                    "raylet unreachable x%d; worker exiting", misses)
                os._exit(1)


if __name__ == "__main__":
    main()
