"""Framework exceptions (reference: src/ray/common/status.h + python/ray/exceptions.py)."""

from __future__ import annotations


class RtError(Exception):
    """Base class for all framework errors."""


class RtTimeoutError(RtError, TimeoutError):
    pass


class RtConnectionError(RtError, ConnectionError):
    pass


class RtSystemError(RtError):
    """Internal invariant violation."""


class ControlPlaneDiedError(RtError):
    """A dedicated control-plane process (GCS server or raylet) died while
    the cluster was in use (multi-process deployment shape,
    ``control_plane_procs``).  Raised by new control-plane operations —
    task submission, actor creation — after the supervisor detects the
    death; already-dispatched work on live workers is unaffected."""

    def __init__(self, component: str, detail: str = ""):
        self.component = component
        self.detail = detail
        super().__init__(
            f"control-plane process {component!r} died"
            + (f": {detail}" if detail else ""))

    def __reduce__(self):  # two-arg __init__: default reduce would break
        return (ControlPlaneDiedError, (self.component, self.detail))


class TaskError(RtError):
    """A task raised an exception; re-raised at `get` on the caller."""

    def __init__(self, task_id=None, cause: BaseException | None = None, traceback_str: str = ""):
        self.task_id = task_id
        self.cause = cause
        self.traceback_str = traceback_str
        super().__init__(f"task {task_id} failed: {cause!r}\n{traceback_str}")


class TaskCancelledError(RtError):
    """The task was cancelled via cancel(); raised at `get` on its refs
    (reference: python/ray/exceptions.py TaskCancelledError)."""

    def __init__(self, message: str = "the task was cancelled"):
        super().__init__(message)


class WorkerCrashedError(RtError):
    """The worker executing the task died unexpectedly."""


class ActorDiedError(RtError):
    def __init__(self, actor_id=None, reason: str = ""):
        self.actor_id = actor_id
        self.reason = reason
        super().__init__(f"actor {actor_id} died: {reason}")


class ActorUnavailableError(RtError):
    """Actor temporarily unreachable (restarting); call may be retried."""


class ObjectLostError(RtError):
    def __init__(self, object_id=None, reason: str = ""):
        self.object_id = object_id
        self.reason = reason
        super().__init__(f"object {object_id} lost: {reason}")

    def __reduce__(self):  # default reduce would re-wrap the message as
        # the object_id on every pickle hop, nesting "object object ..."
        return (ObjectLostError, (self.object_id, self.reason))


class SpillFailedError(RtError):
    """A spill write to external storage failed (disk full, unwritable
    dir, dead mount) — the primary copy could NOT be demoted to disk.

    Deliberately NOT an OSError subclass: the spill paths' historical
    ``except OSError`` guards (arena-full retries, best-effort cleanup)
    must not swallow it.  Raised by the shm spill engine at the next
    spill operation after a writer-thread failure, and synchronously by
    ``put_or_spill``/the demotion loop when the write is refused up
    front; ``CoreWorker._pack_result`` lets it surface as a task error
    instead of silently dropping the node-durability guarantee."""


class ObjectStoreFullError(RtError):
    pass


class PlacementGroupError(RtError):
    pass


class RuntimeEnvSetupError(RtError):
    pass


class PendingCallsLimitExceeded(RtError):
    pass


# What of the JAX package's runtime a later slice of the port brings, by
# its ROADMAP.md item; each entry point refuses with not_ported(name).
WAITING = {
    "control_plane": "queue A item 11, the control-plane processes "
                     "(RT_control_plane_procs=1)",
    "gcs_failover": "queue A item 11, GCS failover (gcs/failover.py)",
    "client": "queue A item 11, the ray:// client",
    "dashboard": "queue A item 11, the dashboard",
    "job": "queue A item 11, jobs",
    "autoscaler": "queue A item 11, the autoscaler",
    "cli": "queue A item 11, the CLI (python -m ray_tpu_torch start)",
}


def not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} is not ported to ray_tpu_torch yet "
        f"(ROADMAP.md, {WAITING[name]})")
