"""Forkserver-style worker factory.

Reference: the raylet's worker pool forks language workers on demand
(``src/ray/raylet/worker_pool.h``); CPython's cost there is dominated by
interpreter + import boot (~0.2-0.4 s per worker on this class of host,
measured in PERF_PLAN.md). The factory is a single warm Python process that
pre-imports the worker runtime and then ``os.fork()``s per request —
converting worker creation into a ~10 ms fork + registration handshake,
which is what the reference achieves with its prestarted worker cache.

Protocol (unix stream socket, length-prefixed pickle):
  request  {"env": {...}, "log_path": str, "cwd": str}
  reply    {"pid": int} | {"error": str}

The forked child closes the factory's sockets, replaces its environment,
redirects stdout/stderr into the per-worker session log, and runs the
normal ``worker_main.main()``. The factory reaps its children on a waitpid
thread so liveness probes (``os.kill(pid, 0)``) in the raylet never see
stale zombies. Runtime envs that swap the Python executable (pip/conda)
cannot ride a fork and keep the exec path in the raylet.

The factory never touches CUDA, and it starts with no GPU visible (the
raylet passes ``CUDA_VISIBLE_DEVICES=""``): a CUDA context created before
``fork`` breaks every child ("Cannot re-initialize CUDA in forked
subprocess"). It pre-imports the runtime but not torch, so a worker loads
torch only when a value it handles holds a tensor. The raylet starts it
with ``subprocess.Popen`` (an exec), never by forking the driver, whose
CUDA may be initialised already.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import sys
import threading


def _recv_msg(conn: socket.socket):
    head = b""
    while len(head) < 4:
        chunk = conn.recv(4 - len(head))
        if not chunk:
            return None
        head += chunk
    (n,) = struct.unpack("<I", head)
    body = b""
    while len(body) < n:
        chunk = conn.recv(n - len(body))
        if not chunk:
            return None
        body += chunk
    return pickle.loads(body)


def _send_msg(conn: socket.socket, obj) -> None:
    blob = pickle.dumps(obj)
    conn.sendall(struct.pack("<I", len(blob)) + blob)


def _reap_loop():
    while True:
        try:
            pid, _status = os.waitpid(-1, 0)
            if pid == 0:
                break
        except ChildProcessError:
            import time

            time.sleep(0.2)
        except OSError:
            return


def _child_main(req: dict, listener: socket.socket,
                conn: socket.socket) -> None:
    """Runs in the forked child: become a clean worker process."""
    import time as _time

    t_fork = _time.monotonic()
    listener.close()
    conn.close()
    os.setsid()  # own process group: raylet signals don't hit the factory
    log_fd = os.open(req["log_path"],
                     os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    os.dup2(log_fd, 1)
    os.dup2(log_fd, 2)
    os.close(log_fd)
    os.environ.clear()
    os.environ.update(req["env"])
    os.environ["RT_CHILD_T"] = repr(t_fork)  # worker_main logs the split
    if req.get("cwd"):
        os.chdir(req["cwd"])
    # flag values cached in the warm parent may disagree with this
    # worker's env (RT_* overrides arrive via req["env"])
    from ray_tpu_torch.common.config import GLOBAL_CONFIG

    GLOBAL_CONFIG._cache.clear()

    import ray_tpu_torch.core_worker.worker_main as wm

    try:
        wm.main()
    finally:
        os._exit(0)


def main(sock_path: str) -> None:
    # Pre-import everything the worker boot path needs: this is the whole
    # point — children inherit a warm interpreter.
    import asyncio  # noqa: F401
    import logging  # noqa: F401

    import cloudpickle  # noqa: F401
    import numpy  # noqa: F401

    import ray_tpu_torch.core_worker.worker  # noqa: F401
    import ray_tpu_torch.core_worker.worker_main  # noqa: F401
    import ray_tpu_torch.rpc.rpc  # noqa: F401

    # Pre-dlopen the native extensions: children inherit the mappings,
    # cutting ~10-15 ms of per-worker boot (fastloop server + shm arena
    # open both dlopen these on first use). Load only — no sockets, no
    # arena handles, no threads from these libs cross the fork.
    from ray_tpu_torch.rpc.native import load_fastloop, load_fastspec

    load_fastloop()
    load_fastspec()
    try:
        from ray_tpu_torch.object_store import shm as _shm

        _shm._load()
    except Exception:  # noqa: BLE001 — workers just dlopen themselves
        pass

    threading.Thread(target=_reap_loop, daemon=True,
                     name="factory-reap").start()

    def _orphan_watch(parent=os.getppid()):
        # the factory is a direct child of the raylet: if the raylet is
        # SIGKILLed (multi-process-shape crash) nobody shuts the factory
        # down — reparenting is the death signal
        import time as _t

        while True:
            _t.sleep(2.0)
            if os.getppid() != parent:
                os._exit(0)

    threading.Thread(target=_orphan_watch, daemon=True,
                     name="factory-orphan-watch").start()
    if os.path.exists(sock_path):
        os.unlink(sock_path)
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(sock_path)
    listener.listen(64)
    import time as _time

    while True:
        try:
            conn, _ = listener.accept()
        except OSError:
            return
        try:
            t_acc = _time.monotonic()
            req = _recv_msg(conn)
            if req is None:
                continue
            if req.get("op") == "shutdown":
                _send_msg(conn, {"ok": True})
                return
            t_req = _time.monotonic()
            pid = os.fork()
            if pid == 0:
                _child_main(req, listener, conn)  # never returns
            if os.environ.get("RT_BOOT_TRACE"):
                print(f"factory: recv {1e3*(t_req-t_acc):.1f}ms fork "
                      f"{1e3*(_time.monotonic()-t_req):.1f}ms pid {pid}",
                      flush=True)
            _send_msg(conn, {"pid": pid})
        except Exception as e:  # noqa: BLE001 — keep serving
            try:
                _send_msg(conn, {"error": repr(e)})
            except OSError:
                pass
        finally:
            try:
                conn.close()
            except OSError:
                pass


class MultiFactoryClient:
    """Round-robin over several forkserver processes. fork(2) copies the
    parent's page tables under mm-wide locks — ONE warm factory tops out
    at ~70-80 forks/s on this class of host, which caps sustained actor
    creation (every actor consumes a worker). K independent factories
    fork in parallel from separate address spaces."""

    def __init__(self, clients):
        self._clients = list(clients)
        self._i = 0
        self._lock = threading.Lock()

    def spawn(self, env: dict, log_path: str, cwd: str,
              timeout: float = 10.0) -> int:
        with self._lock:
            i = self._i
            self._i += 1
        last: Exception = RuntimeError("no factory processes")
        for k in range(len(self._clients)):
            c = self._clients[(i + k) % len(self._clients)]
            try:
                return c.spawn(env, log_path, cwd, timeout)
            except FactoryUnavailable as e:
                # connect-phase failure: this factory never saw the
                # request, safe to try the next one
                last = e
            # anything past connect (send/recv timeout etc.) may have
            # ALREADY forked the child — retrying on another factory
            # would double-spawn the same RT_WORKER_ID; propagate
        raise last

    def shutdown(self):
        for c in self._clients:
            c.shutdown()


class FactoryUnavailable(OSError):
    """The factory socket could not be reached (connect-phase failure):
    the request never arrived, so failing over to another factory cannot
    double-spawn."""


class FactoryClient:
    """Raylet-side handle: spawn workers through the factory socket."""

    def __init__(self, sock_path: str):
        self._path = sock_path

    def spawn(self, env: dict, log_path: str, cwd: str,
              timeout: float = 10.0) -> int:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(timeout)
        try:
            try:
                conn.connect(self._path)
            except OSError as e:
                raise FactoryUnavailable(str(e)) from e
            _send_msg(conn, {"env": env, "log_path": log_path, "cwd": cwd})
            reply = _recv_msg(conn)
        finally:
            conn.close()
        if reply is None or "pid" not in reply:
            raise RuntimeError(
                f"worker factory spawn failed: {reply!r}")
        return reply["pid"]

    def shutdown(self):
        try:
            conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            conn.settimeout(2.0)
            conn.connect(self._path)
            _send_msg(conn, {"op": "shutdown"})
            conn.close()
        except OSError:
            pass


if __name__ == "__main__":
    main(sys.argv[1])
