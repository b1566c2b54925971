"""Public API (reference surface: python/ray/_private/worker.py:1331 ray.init,
:2726 get, :2879 put, :2944 wait; remote_function.py:314 @ray.remote).

``init()`` with no address starts a single-node cluster in-process (GCS +
raylet on the shared IO loop; workers are real child processes forked by
the worker factory). ``init(address="host:port")`` connects to an existing
cluster's GCS. GPUs are a leased resource: ``init(num_gpus=...)`` sets the
node's count, else ``common/gpu_detect.py`` counts them without
initialising CUDA, and a ``num_gpus`` task or actor sees its grant as
``CUDA_VISIBLE_DEVICES``.

``.bind`` on a remote function builds a compiled-graph node
(``ray_tpu_torch.graph``). What the JAX package's ``api.py`` also reaches
(the ray:// client, the control-plane processes, the dashboard) waits for
a later slice and raises ``NotImplementedError`` naming its ROADMAP item
(``common/status.py::WAITING``).
"""

from __future__ import annotations

import atexit
import functools
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch.common.config import GLOBAL_CONFIG
from ray_tpu_torch.common.ids import ActorID, NodeID
from ray_tpu_torch.common.status import not_ported
from ray_tpu_torch.core_worker.actor import (
    ActorClass,
    ActorHandle,
    _resources_from_options,
    _strategy_from_options,
)
from ray_tpu_torch.core_worker.generator import ObjectRefGenerator
from ray_tpu_torch.core_worker.reference import ObjectRef

logger = logging.getLogger(__name__)

_global_lock = threading.RLock()
_head: Optional[dict] = None  # {"gcs": GcsServer, "raylet": Raylet} when we started them


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    labels: Optional[Dict[str, str]] = None,
    system_config: Optional[dict] = None,
    job_name: str = "",
    runtime_env: Optional[dict] = None,
    dashboard: bool = False,
) -> dict:
    """Start or connect. Returns {"gcs_address": (host, port), "node_id": hex}.

    With no ``address``, ``RT_ADDRESS`` (exported by the job supervisor for
    submitted drivers — reference: RAY_ADDRESS) connects to the running
    cluster; a submitted job's runtime env becomes the driver's job-level
    default via ``RT_JOB_RUNTIME_ENV``.
    """
    global _head
    import json as _json
    import os as _os

    from ray_tpu_torch.core_worker.worker import MODE_DRIVER, CoreWorker

    if address is None:
        address = _os.environ.get("RT_ADDRESS")
    if address is not None and address.startswith("ray://"):
        raise not_ported("client")
    if dashboard:
        raise not_ported("dashboard")
    if GLOBAL_CONFIG.get("control_plane_procs") or (
            system_config or {}).get("control_plane_procs"):
        raise not_ported("control_plane")
    if GLOBAL_CONFIG.get("autoscaling_enabled") or (
            system_config or {}).get("autoscaling_enabled"):
        raise not_ported("autoscaler")
    if runtime_env is None and _os.environ.get("RT_JOB_RUNTIME_ENV"):
        runtime_env = _json.loads(_os.environ["RT_JOB_RUNTIME_ENV"])
    if runtime_env:
        # validate BEFORE any daemon starts: failing after GcsServer/Raylet
        # are up would leak a running head the caller can't shut down
        from ray_tpu_torch.runtime_env.runtime_env import validate as _validate_env

        _validate_env(runtime_env)
    with _global_lock:
        if CoreWorker._current is not None:
            raise RuntimeError("ray_tpu_torch.init() already called; call shutdown() first")
        if system_config:
            GLOBAL_CONFIG.initialize(system_config)
            GLOBAL_CONFIG.reset_cache()
        if address is None:
            node_resources = dict(resources or {})
            node_labels = dict(labels or {})
            if num_cpus is not None:
                node_resources["CPU"] = num_cpus
            if num_gpus is not None:
                node_resources["GPU"] = num_gpus
            elif "GPU" not in node_resources:
                # counted without initialising CUDA (reference
                # accelerators/nvidia_gpu.py): the raylet forks workers
                from ray_tpu_torch.common.gpu_detect import detect

                node_resources["GPU"] = float(detect())
            from ray_tpu_torch.gcs.server import GcsServer
            from ray_tpu_torch.raylet.raylet import Raylet

            gcs = GcsServer()
            gcs.start()
            raylet = Raylet(gcs.address, resources=node_resources,
                            labels=node_labels)
            # before start(): the node's own ALIVE registration must
            # land in the export log too
            gcs.attach_export_logger(raylet.session_dir)
            raylet.start()
            _head = {"gcs": gcs, "raylet": raylet,
                     "session_dir": raylet.session_dir,
                     "node_id": raylet.node_id}
            gcs_address = gcs.address
            raylet_address = raylet.server.address
            node_id = raylet.node_id
        else:
            host, _, port = address.partition(":")
            gcs_address = (host, int(port))
            from ray_tpu_torch.gcs.client import GcsClient

            probe = GcsClient(gcs_address)
            nodes_info = probe.get_all_nodes()
            probe.close()
            alive = [n for n in nodes_info if n["alive"]]
            if not alive:
                raise ConnectionError(f"no alive nodes in cluster at {address}")
            raylet_address = tuple(alive[0]["address"])
            node_id = NodeID(alive[0]["node_id"])

        try:
            cw = CoreWorker(
                mode=MODE_DRIVER,
                gcs_address=gcs_address,
                raylet_address=raylet_address,
                node_id=node_id,
            )
            cw.job_runtime_env = dict(runtime_env) if runtime_env else None
            if GLOBAL_CONFIG.get("log_to_driver"):
                _subscribe_worker_logs(cw)
            atexit.register(_shutdown_atexit)
            return {"gcs_address": gcs_address, "node_id": node_id.hex()}
        except BaseException:
            # a failure after the head came up must not leak it (the
            # raylet's workers would outlive the driver's interest)
            if _head is not None:
                _head["raylet"].stop()
                _head["gcs"].stop()
                _head = None
            if CoreWorker._current is not None:
                CoreWorker._current.shutdown()
            raise


def _subscribe_worker_logs(cw) -> None:
    """Print worker stdout/stderr lines this job produced, ``(pid=…)``
    prefixed (reference log_monitor.py → driver UX)."""
    import sys as _sys

    my_job = cw.job_id.hex()

    def on_log(_key, msg):
        if msg.get("job_id") not in ("", my_job):
            return  # another driver's workers
        name = msg.get("actor_name") or ""
        tag = (f"{name} pid={msg.get('pid')}" if name
               else f"pid={msg.get('pid')}")
        out = _sys.stderr if msg.get("stream") == "stderr" else _sys.stdout
        for line in msg.get("lines", []):
            print(f"({tag}) {line}", file=out)

    try:
        cw.gcs.subscriber.subscribe("worker_log", on_log)
    except Exception:  # noqa: BLE001 — log relay is best-effort
        logger.debug("worker-log subscription failed", exc_info=True)


def _shutdown_atexit():
    try:
        shutdown()
    except Exception:  # noqa: BLE001
        pass


def shutdown() -> None:
    global _head
    from ray_tpu_torch.core_worker.worker import CoreWorker

    with _global_lock:
        cw = CoreWorker._current
        if cw is not None:
            if _head is not None and getattr(cw, "_control_plane_error",
                                             None) is None:
                # before cw.shutdown(): the report snapshots cluster
                # shape through the still-live core worker (skipped when
                # the control plane is already dead — nothing to snapshot)
                from ray_tpu_torch.util import usage

                usage.write_report(_head["session_dir"])
            if getattr(cw, "_control_plane_error", None) is None:
                try:
                    cw.gcs.finish_job(cw.job_id)
                except Exception:  # noqa: BLE001
                    pass
            cw.shutdown()
        if _head is not None:
            node_id = _head["node_id"]
            _head["raylet"].stop()
            _head["gcs"].stop()
            from ray_tpu_torch.object_store.shm import node_shm_name
            from ray_tpu_torch.object_store.shm import unlink as shm_unlink

            shm_unlink(node_shm_name(node_id))
            # reap spill state orphaned by DEAD processes (crashed
            # sessions, SIGKILLed workers): stale rtt_spill_*/
            # rttshm_spill_* dirs and .tmp.<pid> write fragments. Live
            # sessions sharing the dir are untouched (pid / segment
            # liveness checks).
            try:
                from ray_tpu_torch.object_store.shm import gc_spill_dirs

                gc_spill_dirs()
            except Exception:  # noqa: BLE001 — shutdown is best-effort
                pass
            # same sweep for transfer-service scratch: half-landed arena
            # allocations (.pull.<pid> markers) whose puller process died
            # mid-download are aborted so their spans don't pin the arena
            try:
                from ray_tpu_torch.object_store.transfer import gc_transfer_scratch

                gc_transfer_scratch()
            except Exception:  # noqa: BLE001 — shutdown is best-effort
                pass
            _head = None


def is_initialized() -> bool:
    from ray_tpu_torch.core_worker.worker import CoreWorker

    return CoreWorker._current is not None


def _core_worker():
    from ray_tpu_torch.core_worker.worker import CoreWorker

    return CoreWorker.current_or_raise()


# ----------------------------------------------------------------- remote API

class RemoteFunction:
    def __init__(self, fn, default_options: Optional[dict] = None):
        self._fn = fn
        self._options = default_options or {}
        functools.update_wrapper(self, fn)
        self._serialized = None

    def remote(self, *args, **kwargs):
        return self._invoke(args, kwargs, self._options)

    def options(self, **opts):
        merged = dict(self._options)
        merged.update(opts)
        return _RemoteFunctionOptions(self, merged)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.graph.dag import FunctionNode

        return FunctionNode(self, args, kwargs, self._options)

    def _invoke(self, args, kwargs, opts):
        import cloudpickle

        cw = _core_worker()
        if self._serialized is None:
            self._serialized = cloudpickle.dumps(self._fn)
        num_returns = opts.get("num_returns", 1)
        streaming = num_returns == "streaming"
        refs = cw.submit_task(
            self._fn,
            args,
            kwargs,
            num_returns=0 if streaming else num_returns,
            streaming=streaming,
            resources=_resources_from_options(opts),
            label_selector=opts.get("label_selector"),
            scheduling_strategy=_strategy_from_options(opts),
            max_retries=opts.get("max_retries"),
            name=opts.get("name", self._fn.__name__),
            serialized_func=self._serialized,
            runtime_env=opts.get("runtime_env"),
        )
        if streaming:
            return refs  # an ObjectRefGenerator
        if num_returns == 1:
            return refs[0]
        return refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._fn.__name__!r} cannot be called directly; "
            f"use .remote()")


class _RemoteFunctionOptions:
    def __init__(self, rf: RemoteFunction, opts: dict):
        self._rf = rf
        self._opts = opts

    def remote(self, *args, **kwargs):
        return self._rf._invoke(args, kwargs, self._opts)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.graph.dag import FunctionNode

        return FunctionNode(self._rf, args, kwargs, self._opts)


def remote(*args, **options):
    """``@remote`` / ``@remote(num_cpus=..., num_gpus=..., ...)`` on functions
    and classes."""
    if len(args) == 1 and callable(args[0]) and not options:
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target)
        return RemoteFunction(target)
    if args:
        raise TypeError("@remote takes keyword options only")

    def wrap(target):
        if isinstance(target, type):
            return ActorClass(target, options)
        return RemoteFunction(target, options)

    return wrap


def method(**opts):
    """Decorator for actor methods (num_returns)."""

    def wrap(fn):
        fn.__rt_method_opts__ = opts
        return fn

    return wrap


# -------------------------------------------------------------------- core ops

def put(value: Any, *, _tensor_transport: Optional[str] = None):
    """Store an object. ``_tensor_transport="device"`` keeps torch.Tensor
    leaves resident on their device in this process and ships only a
    marker; consumers on other workers pull the tensors out-of-band
    (reference: experimental/gpu_object_manager 'RDT')."""
    return _core_worker().put(value, tensor_transport=_tensor_transport)


def get(refs, *, timeout: Optional[float] = None):
    single = isinstance(refs, ObjectRef)
    ref_list = [refs] if single else list(refs)
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
    values = _core_worker().get(ref_list, timeout)
    return values[0] if single else values


async def get_async(ref: "ObjectRef", *, timeout: Optional[float] = None):
    """Awaitable single-ref ``get`` for async actors and event-loop code:
    resolves on the calling loop with no executor thread parked on a
    condition variable (reference: ``await object_ref`` / CoreWorker
    GetAsync)."""
    if not isinstance(ref, ObjectRef):
        raise TypeError(f"get_async() expects an ObjectRef, got {type(ref)}")
    return await _core_worker().get_async(ref, timeout)


def wait(refs, *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    return _core_worker().wait(list(refs), num_returns, timeout, fetch_local)


def kill(actor, *, no_restart: bool = True):
    _core_worker().kill_actor(actor._actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False):
    """Cancel the task that produces ``ref`` (reference:
    python/ray/_private/worker.py cancel → CoreWorker::CancelTask).

    Best-effort: a queued task is removed and its refs resolve to
    :class:`TaskCancelledError`; a running sync task gets the error raised
    asynchronously in its thread (blocking C calls need ``force``); a
    running ``async def`` actor call is asyncio-cancelled; a streaming
    generator stops at its next yield. ``force=True`` kills the executing
    worker process. Already-finished tasks are unaffected."""
    return _core_worker().cancel_task(ref, force=force)


def get_actor(name: str, namespace: str = "default"):
    info = _core_worker().gcs.get_actor_by_name(name, namespace)
    if info is None or info["state"] == "DEAD":
        raise ValueError(f"no alive actor named {name!r}")
    return ActorHandle(ActorID.from_hex(info["actor_id"]))


# ----------------------------------------------------------------- inspection

def nodes() -> List[dict]:
    out = []
    for n in _core_worker().gcs.get_all_nodes():
        out.append({
            "NodeID": NodeID(n["node_id"]).hex(),
            "Alive": n["alive"],
            "Address": n["address"],
            "Resources": n["resources"]["total"],
            "Available": n["resources"]["available"],
            "Labels": n["resources"]["labels"],
        })
    return out


def cluster_resources() -> Dict[str, float]:
    return _core_worker().gcs.cluster_resources()["total"]


def available_resources() -> Dict[str, float]:
    return _core_worker().gcs.cluster_resources()["available"]


def timeline() -> List[dict]:
    """Chrome-trace events for completed tasks (reference: ray.timeline)."""
    return _core_worker().gcs.call("get_task_events")


class RuntimeContext:
    def __init__(self, cw):
        self._cw = cw

    @property
    def job_id(self):
        return self._cw.job_id

    @property
    def node_id(self):
        return self._cw.node_id

    @property
    def worker_id(self):
        return self._cw.worker_id

    def get_task_id(self):
        return self._cw.current_task_id()

    def get_actor_id(self):
        return self._cw._actor_id

    @property
    def gcs_address(self):
        return self._cw.gcs_address


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(_core_worker())
