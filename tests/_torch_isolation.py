"""Module teardown for the port's test files (``tests/test_torch_*.py``).

Each of those files imports :func:`_module_isolation_guard`, which then
stands in for tests/conftest.py's fixture of the same name in that file.
At the file's end it shuts down whichever package this process started
(``ray_tpu`` or ``ray_tpu_torch``, each package's Serve first), then ends
the stray processes that descend from this pytest process, found by
walking ``/proc/*/stat`` parent links down from ``os.getpid()``. It never
signals a process outside that tree: under xdist, the other workers'
clusters are not this file's to end.

While the file runs, every STALL_DUMP_S seconds ``faulthandler`` writes
every thread's stack to file descriptor 2: a file that stalls names where
it stopped, in the captured stderr of the test that was running (shown
when that test fails) well before the whole run's time limit. A file that
passes ends long before the first dump.
"""

import faulthandler
import importlib
import os
import signal
import sys
import time

import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")
# the slowest port test file takes about 60 s alone and a few times that
# under the parallel tier-1 run
STALL_DUMP_S = 240


def _children() -> dict:
    """{parent pid: [child pids]} of every live process."""
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] != "Z":
            out.setdefault(int(fields[1]), []).append(int(name))
    return out


def descendants(root: int = None) -> list:
    """Pids of the live processes below ``root`` (default: this one)."""
    tree = _children()
    found, stack = [], [os.getpid() if root is None else root]
    while stack:
        for pid in tree.get(stack.pop(), ()):
            found.append(pid)
            stack.append(pid)
    return found


def reap_descendants(grace_s: float = 2.0) -> list:
    """SIGTERM this process's descendants, then SIGKILL those still alive
    after ``grace_s``; returns the pids that were signalled."""
    pids = descendants()
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in pids:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline and set(pids) & set(descendants()):
            time.sleep(0.05)
        if not set(pids) & set(descendants()):
            break
    return pids


def shutdown_started_packages() -> None:
    """Shut down Serve and the runtime of each package this process has
    initialized; a failure here never fails the module."""
    for name in PACKAGES:
        if name not in sys.modules:
            continue
        pkg = sys.modules[name]
        try:
            if not pkg.is_initialized():
                continue
            if f"{name}.serve.api" in sys.modules:
                importlib.import_module(f"{name}.serve.api").shutdown()
        except Exception:  # noqa: BLE001 — the guard must never fail
            pass
        try:
            pkg.shutdown()
        except Exception:  # noqa: BLE001
            pass


@pytest.fixture(autouse=True, scope="module")
def _module_isolation_guard():
    """Module teardown: stop what this process started, reap only its
    descendants (replaces tests/conftest.py's machine-wide pkill); the
    stall dump is armed while the file runs."""
    faulthandler.dump_traceback_later(STALL_DUMP_S, repeat=True, file=2)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
    shutdown_started_packages()
    reap_descendants()
