"""CoreWorker — the runtime embedded in every driver and worker process.

Equivalent of the reference's core worker library (src/ray/core_worker/
core_worker.cc + the Cython bridge _raylet.pyx): task submission and
execution, object put/get/wait, ownership (each object's owner is the worker
that created it; the owner holds value/location/lineage and drives recovery),
actor creation/calls, and the worker-side RPC service (PushTask equivalent).

Failure semantics implemented here:
- push failure → retry with fresh lease while ``max_retries`` remains;
- fetch-from-holder failure → owner reconstructs the object by re-executing
  the creating task from lineage (reference: object_recovery_manager.h:43);
- actor restart → unacked calls resent in order (actor_task_submitter.cc).
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import os
import pickle
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import contextvars

import cloudpickle

from ray_tpu_torch.common.config import GLOBAL_CONFIG
from ray_tpu_torch.common.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    TaskID,
    WorkerID,
    _Counter,
)
from ray_tpu_torch.common.status import (
    ObjectLostError,
    RtError,
    RtTimeoutError,
    SpillFailedError,
    TaskCancelledError,
    TaskError,
)
from ray_tpu_torch.common.task_spec import (
    DefaultStrategy,
    FunctionDescriptor,
    TaskArg,
    TaskSpec,
    TaskType,
    _FastArgs,
)
from ray_tpu_torch.gcs.client import GcsClient
from ray_tpu_torch.rpc.rpc import (IoContext, RemoteMethodError,
                             RetryableRpcClient, RpcClient, RpcServer)
from ray_tpu_torch.common.resources import ResourceRequest
from ray_tpu_torch.util import tracing as _tracing
from . import serialization as _serialization
from .memory_store import MemoryStore
from .reference import ObjectRef, install_borrow_sinks, install_release_sink
from .submitter import ActorTaskSubmitter, NormalTaskSubmitter

logger = logging.getLogger(__name__)

MODE_DRIVER = "driver"
MODE_WORKER = "worker"


def _cuda_may_be_fixed() -> bool:
    """True when this process may already have read CUDA_VISIBLE_DEVICES:
    torch is loaded (``torch.cuda.is_available()`` runs cuInit without
    ``torch.cuda.is_initialized()`` turning true) or the CUDA driver is
    mapped, whoever loaded it."""
    if "torch" in sys.modules:
        return True
    try:
        with open("/proc/self/maps") as f:
            return any("libcuda.so" in line for line in f)
    except OSError:
        return False


class _TaskContext:
    """Current-task binding backed by a contextvar: isolated per pool thread
    (sync tasks) AND per asyncio task (async actor calls interleaving on one
    loop thread). Child-task/put INDEX counters deliberately do NOT live
    here — they are shared per parent task on the CoreWorker so concurrent
    contexts never mint colliding IDs."""

    _task_id = contextvars.ContextVar("rt_task_id", default=None)

    @property
    def task_id(self) -> Optional[TaskID]:
        return self._task_id.get()

    @task_id.setter
    def task_id(self, v) -> None:
        self._task_id.set(v)


class CoreWorker:
    """One per process. Thread-safe public API; internals on the IO loop."""

    _current: Optional["CoreWorker"] = None

    @classmethod
    def current_or_raise(cls) -> "CoreWorker":
        if cls._current is None:
            raise RuntimeError("ray_tpu_torch.init() must be called first")
        return cls._current

    def __init__(
        self,
        mode: str,
        gcs_address: Tuple[str, int],
        raylet_address: Tuple[str, int],
        node_id: NodeID,
        job_id: Optional[JobID] = None,
        worker_id: Optional[WorkerID] = None,
        port: int = 0,
    ):
        self.mode = mode
        self.worker_id = worker_id or WorkerID.from_random()
        self.node_id = node_id
        self.gcs_address = tuple(gcs_address)
        self.raylet_address = tuple(raylet_address)
        self._io = IoContext.current()

        # boot-phase tracing (RT_BOOT_TRACE=1): worker supply rate bounds
        # actors_per_second, so the init hot spots must stay findable
        _bt0 = time.monotonic()
        _bt = (lambda tag, _l=[_bt0]:
               (logger.info("boot-trace %s %.1fms", tag,
                            1e3 * (time.monotonic() - _l[0])),
                _l.__setitem__(0, time.monotonic()))
               ) if os.environ.get("RT_BOOT_TRACE") else (lambda tag: None)

        self.server = RpcServer(port=port)
        for name in (
            "push_task", "create_actor", "get_object", "free_object",
            "reconstruct_object", "set_visible_devices", "ping", "exit_worker",
            "actor_method_metadata", "object_info", "get_object_chunk",
            "incref_inflight", "borrow_ack", "borrow_release", "drop_copy",
            "handoff_done", "device_object_get", "report_generator_item",
            "cancel_task", "cancel_running_task", "configure_worker",
        ):
            self.server.register(name, getattr(self, f"h_{name}"))
        self.server.start()
        _bt("rpc-server")

        self.gcs = GcsClient(self.gcs_address, client_id=f"worker-{self.worker_id.hex()[:8]}")
        self.memory_store = MemoryStore()
        from ray_tpu_torch.object_store.device import DeviceObjectStore

        # device-resident objects (torch.Tensors kept on their device; see
        # ray_tpu_torch/object_store/device.py for the transfer tiers)
        self.device_store = DeviceObjectStore()
        import collections as _collections

        # consumer-side LRU of resolved remote device objects
        self._device_obj_cache: "_collections.OrderedDict" = \
            _collections.OrderedDict()
        self._device_cache_lock = threading.Lock()
        _bt("stores")
        self.submitter = NormalTaskSubmitter(self)
        self._actor_submitters: Dict[ActorID, ActorTaskSubmitter] = {}
        self._actor_sub_lock = threading.Lock()
        self._actor_events_subscribed = False
        # cancellation: executor side tracks what is running (thread ident
        # for pool tasks, concurrent future for async actor calls) so a
        # cancel_running_task RPC can interrupt it; owner side remembers
        # cancelled task ids so retries/reconstruction never revive them.
        # Bounded: day-scale drivers must not grow these forever.
        from ray_tpu_torch.common.containers import BoundedSet

        self._running_tasks: Dict[bytes, dict] = {}
        self._cancel_requested = BoundedSet()
        self._cancelled_tasks = BoundedSet()

        _bt("submitters")
        if mode == MODE_DRIVER:
            self.job_id = job_id or JobID(self.gcs.call("get_next_job_id"))
            self.gcs.register_job(self.job_id, self.server.address)
        else:
            self.job_id = job_id or JobID.nil()

        self._ctx = _TaskContext()
        # the parent task of code outside any task: the driver's script, or
        # a thread a worker's task started (a Tune trial's trainable, whose
        # trainer creates actors); a worker's is its own
        self._driver_task_id = (
            TaskID.for_driver(self.job_id) if mode == MODE_DRIVER
            else TaskID.for_worker_thread(self.job_id, self.worker_id))
        self._actor_counter = _Counter()
        # unnamed-actor registration batcher (one register_actors RPC per
        # loop tick instead of one RPC per .remote())
        self._pending_actor_regs: list = []
        self._actor_reg_lock = threading.Lock()
        self._actor_reg_flush_scheduled = False
        self._empty_args_payload: Optional[bytes] = None
        self._index_counters: Dict[Any, _Counter] = {}
        self._index_lock = threading.Lock()

        # streaming generator returns (owner side): task_id -> _StreamState;
        # _stream_heal: in-flight lineage reconstructs of streamed items
        # whose generator was already dropped (task_id -> {object_ids})
        self._generators: Dict[TaskID, Any] = {}
        self._stream_heal: Dict[TaskID, set] = {}

        # ownership state (owner side)
        self.lineage: Dict[ObjectID, TaskSpec] = {}
        self._lineage_lock = threading.Lock()
        self._reconstructing: Dict[ObjectID, float] = {}
        # distributed refcount (reference: core_worker/reference_count.h:73).
        # Owner side: per-object {local, in_flight, borrowers, location}.
        # Borrower side: per-object {count, chain} — chain serializes this
        # process's borrow messages to the owner so release never overtakes
        # ack/incref.
        self._owned_refs: Dict[ObjectID, dict] = {}
        self._borrowed: Dict[ObjectID, dict] = {}
        self._free_tombstones: Dict[bytes, float] = {}
        self._ref_lock = threading.Lock()

        # execution state (executee side)
        self._executor = ThreadPoolExecutor(max_workers=64, thread_name_prefix="rt-exec")
        self._fn_cache: Dict[bytes, Any] = {}
        # C dispatch loop (rpc/native/fastloop.c): eligible actor pushes
        # bypass asyncio end to end — frames execute straight off the C
        # thread (ordered, immediately-runnable calls) or hop once to the
        # executor/actor loop (concurrent or async-actor calls).  The
        # SURVEY §2.5 native hot path; drivers never execute actor tasks,
        # so only workers pay for the extra thread.
        _bt("exec-state")
        self._fast_server = None
        self._fast_port: Optional[int] = None
        self._fast_gap_buf: Dict[bytes, dict] = {}
        if mode != MODE_DRIVER and GLOBAL_CONFIG.get("fastloop_enabled"):
            from ray_tpu_torch.rpc.native import load_fastloop

            fl = load_fastloop()
            if fl is not None:
                try:
                    self._fast_server = fl.Server(self._fast_frame)
                    self._fast_server.start()
                    self._fast_port = self._fast_server.port
                except Exception:  # noqa: BLE001 — asyncio path still works
                    logger.exception("fastloop server failed to start")
                    self._fast_server = None
        self._actor_instance: Any = None
        self._actor_max_concurrency = 1
        self._actor_id: Optional[ActorID] = None
        self._actor_lock = threading.Lock()
        self._actor_seq_cv = threading.Condition()
        # per-caller ordering state (reference: one scheduling queue per caller,
        # core_worker/transport/actor_scheduling_queue.cc)
        self._actor_seq_state: Dict[bytes, dict] = {}
        self._actor_concurrency: Optional[threading.Semaphore] = None
        self._actor_has_async = False
        self._async_call_sem: Optional[asyncio.Semaphore] = None
        self._fetch_inflight: Dict[ObjectID, asyncio.Future] = {}
        # owners our raylet confirmed dead: later fetches of their objects
        # skip the reconnect budget entirely (one liveness RPC per owner,
        # not one per object)
        self._dead_owners: set = set()
        # multi-node object plane (object_store/transfer.py): coalesced
        # owner→GCS location reporting plus an in-process locality cache
        # ({oid bytes: {"node_id", "size"}}) that feeds the submitter's
        # argument-locality lease hint and cold-fetch source resolution
        self._transfer_enabled = bool(GLOBAL_CONFIG.get("transfer_service"))
        self._pending_loc_updates: list = []
        self._loc_lock = threading.Lock()
        self._loc_flush_scheduled = False
        self._object_locality: Dict[bytes, dict] = {}
        self._node_transfer_addrs: Dict[str, tuple] = {}

        _bt("fastloop")
        # Multi-process shape: the supervisor stores the typed death error
        # here; new control-plane work (submits, creations) fails fast on
        # it instead of timing out against a dead daemon (control_plane.py)
        self._control_plane_error: Optional[Exception] = None
        self._shm = False  # False = not probed yet; None = unavailable
        self._shm_probe_lock = threading.Lock()
        if mode != MODE_DRIVER:
            # probe eagerly: executee-side zero-copy arg/dependency reads
            # (_fetch_async) only consult an ALREADY-probed store, and the
            # first fetch must not silently fall back to an RPC copy
            _ = self.shm
        self._task_events: list = []
        # read once at boot: the per-task hot path must not take the
        # config lock (toggling at runtime requires a worker restart)
        self._task_events_enabled = GLOBAL_CONFIG.get("task_events_enabled")
        self._task_events_lock = threading.Lock()
        self._task_events_stop = threading.Event()
        threading.Thread(target=self._task_event_flusher, daemon=True,
                         name="task-event-flush").start()
        _bt("shm-probe")
        install_release_sink(self._on_ref_deleted)
        install_borrow_sinks(self._on_ref_serialized, self._on_ref_deserialized)
        CoreWorker._current = self

    def _task_event_flusher(self):
        """Periodic flush so idle workers' buffered events still reach the
        GCS (reference: task_event_buffer.cc periodic flush). Also sweeps
        owned-ref records whose only remaining holds are expired transit
        guards (receiver died before acking)."""
        ticks = 0
        while not self._task_events_stop.wait(1.0):
            if self._task_events:
                self._flush_task_events()
            ticks += 1
            if ticks % 30 == 0:
                self._sweep_owned_refs()

    def _sweep_owned_refs(self):
        with self._ref_lock:
            stale = [oid for oid, st in self._owned_refs.items()
                     if st["local"] <= 0 and not st["borrowers"]
                     and st["in_flight"]]
        for oid in stale:
            self._maybe_free_owned(oid)  # re-checks under lock, TTL-expires

    @property
    def shm(self):
        """Node-local shared-memory object store (plasma equivalent, C++):
        all workers on this node map the same segment — large objects move
        between same-node processes with zero RPC and zero-copy reads."""
        if self._shm is False:
            with self._shm_probe_lock:
                if self._shm is not False:  # lost the probe race
                    return self._shm
                probed = None
                if GLOBAL_CONFIG.get("shm_store_enabled"):
                    try:
                        from ray_tpu_torch.object_store.shm import (ShmObjectStore,
                                                              node_shm_name)

                        # spill dir DERIVED from the segment name inside
                        # the store — every handle (workers, tools, the
                        # teardown unlink) must agree on it, so no caller
                        # spells it out
                        probed = ShmObjectStore(
                            node_shm_name(self.node_id),
                            capacity=GLOBAL_CONFIG.get("shm_store_bytes"))
                    except Exception as e:  # noqa: BLE001 — degrade to RPC
                        logger.warning("shm object store unavailable: %s", e)
                self._shm = probed
                if probed is not None:
                    # large byte values land in the shared arena instead
                    # of this process's heap (memory_store.put routing)
                    self.memory_store.set_shm_router(self._shm_route)
                    # arena demotions move the copy to the spill file —
                    # the location directory must follow so remote pulls
                    # stream the file instead of missing (transfer.py)
                    probed.set_demote_callback(
                        lambda oid: self._report_location("spill", oid))
        return self._shm

    def _shm_route(self, oid_bytes: bytes, value) -> Optional[memoryview]:
        """MemoryStore router: admit a large byte value to the node arena
        and hold it as a pinned zero-copy view (None: arena can't take it
        right now — all spans pinned, or bigger than the whole arena)."""
        store = self._shm
        if store in (False, None):
            return None
        try:
            store.put(oid_bytes, value)
        except OSError:
            return None
        view = store.get_pinned(oid_bytes)
        if view is not None:
            self._report_location("add", oid_bytes, size=len(view))
        return view

    def _shm_read(self, oid: ObjectID) -> Optional[memoryview]:
        """Zero-copy read: the returned view aliases the store's shared
        pages and stays pinned until the last alias (including numpy
        arrays deserialized over it) is garbage-collected.  A value the
        arena demoted to disk under memory pressure (shm.py
        spill-on-evict) comes back as an owned heap copy — one disk
        read, no re-admission."""
        store = self.shm
        if store is None:
            return None
        view = store.get_pinned(oid.binary())
        if view is not None:
            return view
        blob = store.read_spilled(oid.binary())
        return memoryview(blob) if blob is not None else None

    # ------------------------------------------------------------- contexts
    def current_task_id(self) -> TaskID:
        return self._ctx.task_id or self._driver_task_id

    # Child-task and put indexes are shared PER PARENT TASK across every
    # thread and asyncio task in the process. Per-thread/per-context
    # counters would restart at 0 in each caller thread, minting IDENTICAL
    # TaskIDs/ObjectIDs for concurrent submissions under the same parent
    # (e.g. a server fanning out actor calls from a thread pool) — the
    # first-write-wins memory store then silently cross-wires replies.
    _INDEX_COUNTER_CAP = 8192

    def _index_counter(self, kind: str) -> _Counter:
        key = (self.current_task_id(), kind)
        with self._index_lock:
            c = self._index_counters.get(key)
            if c is None:
                if len(self._index_counters) >= self._INDEX_COUNTER_CAP:
                    # insertion-ordered dict: evict the oldest half. A
                    # still-running task whose counter is evicted gets a
                    # fresh one below — the random starting offset keeps its
                    # new indexes disjoint from the old ones.
                    for k in list(self._index_counters)[
                            : self._INDEX_COUNTER_CAP // 2]:
                        del self._index_counters[k]
                import random as _random

                # 28 bits: fits the 4-byte object-index space (put indexes
                # offset by PUT_INDEX_BASE = 2^31) with headroom
                c = _Counter(start=_random.getrandbits(28))
                self._index_counters[key] = c
            return c

    def next_task_index(self) -> int:
        return self._index_counter("task").next()

    def next_put_index(self) -> int:
        return self._index_counter("put").next()

    # ---------------------------------------------------------- serialization
    @staticmethod
    def serialize(value: Any) -> bytes:
        # out-of-band pickle-5 framing for buffer-bearing values
        # (numpy etc.) — reads alias the blob / shm pages, zero-copy
        return _serialization.dumps(value)

    @staticmethod
    def deserialize(blob) -> Any:
        return _serialization.loads(blob)

    # ----------------------------------------------------------------- put/get
    def put(self, value: Any, tensor_transport: Optional[str] = None) -> ObjectRef:
        if tensor_transport not in (None, "device"):
            raise ValueError(
                f"unknown tensor_transport {tensor_transport!r}; "
                "expected 'device'")
        oid = ObjectID.for_put(self.current_task_id(), self.next_put_index())
        if tensor_transport == "device":
            self._put_device(oid, value)
        else:
            self._put_serialized(oid, value)
        return ObjectRef(oid, self.worker_id, self.server.address)

    def _shm_write_framed(self, oid: ObjectID, meta, views, segs,
                          total: int) -> Optional[memoryview]:
        """Serialize a planned frame (see serialization.plan) DIRECTLY
        into a shm arena span (plasma create/seal two-phase): one memcpy
        end to end instead of three (staging bytearray zero-fill + frame
        copy + shm copy). Returns the sealed pinned read-only view, or
        None when there is no arena / no admissible space."""
        shm = self.shm
        if shm is None:
            return None
        try:
            buf = shm.create(oid.binary(), total)
        except OSError:
            buf = None
        if buf is None:
            return None
        sealed = False
        try:
            _serialization.pack_into(buf, meta, views, segs)
            del buf  # drop the writable alias before sealing
            shm.seal(oid.binary())
            sealed = True
        finally:
            if not sealed:
                shm.abort(oid.binary())
        self._report_location("add", oid.binary(), size=total)
        return shm.get_pinned(oid.binary())

    def _put_serialized(self, oid: ObjectID, value: Any) -> None:
        """Store a host value. Large buffer-bearing values take
        :meth:`_shm_write_framed` — shm-backed entries carry zero heap
        charge and same-node reads alias the shared pages."""
        _ser = _serialization

        threshold = GLOBAL_CONFIG.get("shm_direct_put_threshold")
        meta, buffers, views, segs, total = _ser.plan(value)
        try:
            if buffers and total >= threshold:
                view = self._shm_write_framed(oid, meta, views, segs, total)
                if view is not None:
                    self.memory_store.put(oid, value=view)
                    return
            if not buffers:
                self.memory_store.put(oid, value=meta)
                return
            out = bytearray(total)
            _ser.pack_into(out, meta, views, segs)
            self.memory_store.put(oid, value=bytes(out))
        finally:
            _ser.release_buffers(buffers)

    def _put_device(self, oid: ObjectID, value: Any) -> None:
        """Keep the value's torch.Tensor leaves on their device in this
        process; the object plane stores/ships only a marker (reference:
        gpu_object_manager.py 'tensor transport' for put)."""
        from ray_tpu_torch.object_store import device as devmod

        if not devmod.is_device_value(value):
            raise TypeError(
                "tensor_transport='device' requires at least one torch.Tensor "
                "leaf in the value")
        self.device_store.put(oid.binary(), value)
        marker = devmod.DeviceObjectMarker(
            oid.binary(), self.server.address, tuple(devmod.spec_of(value)))
        self.memory_store.put(oid, value=self.serialize(marker))

    def _maybe_device_resolve(self, value: Any) -> Any:
        """If `value` is a device-object marker, resolve it: same process
        -> the original device array(s), zero copies; other process ->
        one host hop (owner DMAs to host, we device_put here), cached in
        a bounded consumer-side LRU so N tasks sharing the same weights
        pay ONE transfer (reference: gpu_object_store caches received
        tensors)."""
        from ray_tpu_torch.object_store import device as devmod

        if not isinstance(value, devmod.DeviceObjectMarker):
            return value
        local = self.device_store.get(value.object_id)
        if local is not None:
            return local
        with self._device_cache_lock:
            cached = self._device_obj_cache.get(value.object_id)
            if cached is not None:
                self._device_obj_cache.move_to_end(value.object_id)
                return cached
        holder = RetryableRpcClient(tuple(value.holder), deadline_s=30.0)
        try:
            reply = holder.call("device_object_get",
                                object_id=value.object_id, timeout=120.0)
            if reply.get("error") is not None:
                raise self.deserialize(reply["error"])
            if reply.get("value") is not None:
                blob = reply["value"]
            else:  # large: chunked pull of the staged transfer blob
                sid = ObjectID(reply["staged_id"])
                blob = self._io.run(self._pull_chunks(
                    tuple(value.holder), sid, reply["size"]))
                try:  # release the holder's staging copy promptly
                    holder.call("drop_copy", object_id=sid.binary(),
                                timeout=10.0)
                except Exception:  # noqa: BLE001 — best effort
                    pass
        finally:
            holder.close()
        restored = devmod.restore_on_device(self.deserialize(blob))
        with self._device_cache_lock:
            self._device_obj_cache[value.object_id] = restored
            self._device_obj_cache.move_to_end(value.object_id)
            cap = GLOBAL_CONFIG.get("device_object_cache_entries")
            while len(self._device_obj_cache) > cap:
                self._device_obj_cache.popitem(last=False)
        return restored

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        for ref in refs:
            self._ensure_local(ref, timeout)
        out = []
        for ref in refs:
            entry = self.memory_store.get_blocking(ref.object_id, timeout)
            if entry.error is not None:
                raise self.deserialize(entry.error)
            if entry.value is not None:
                out.append(self._maybe_device_resolve(
                    self.deserialize(entry.value)))
            elif entry.location is not None:
                # large object held remotely: fetch (blocking, off-loop)
                blob = self._fetch_from_location(ref, entry.location, timeout)
                out.append(self._maybe_device_resolve(self.deserialize(blob)))
            else:
                raise ObjectLostError(ref.object_id, "entry has no value")
        return out

    async def get_async(self, ref: ObjectRef,
                        timeout: Optional[float] = None) -> Any:
        """Awaitable single-ref get, usable from ANY event loop (the
        caller's, not just the IO loop).

        This is the async-native data-plane primitive (reference:
        ``CoreWorker::GetAsync`` / fiber events): readiness rides the
        memory store's done callback straight into the awaiting loop —
        no executor thread parked on a condition variable, no sync-get
        wakeup.  The hot path (value already in local memory) resolves
        with zero thread hops; only the rare cold paths (spilled-to-disk
        restore, remotely-held large value whose holder died) touch a
        thread."""
        self._ensure_local(ref, timeout)
        oid = ref.object_id
        entry, needs_restore = self.memory_store.get_ready_no_restore(oid)
        if needs_restore:
            # ready but spilled: the restore pays disk I/O — a thread,
            # never this loop
            entry = await asyncio.get_running_loop().run_in_executor(
                None, self.memory_store.get_if_ready, oid)
            if entry is None:
                raise ObjectLostError(oid, "spilled value lost from disk")
        if entry is None:
            loop = asyncio.get_running_loop()
            fut = loop.create_future()

            def _ready():
                # fires on whatever thread stored the value (IO loop, C
                # reply reader): hop into the awaiting loop
                try:
                    loop.call_soon_threadsafe(
                        lambda: fut.done() or fut.set_result(None))
                except RuntimeError:
                    pass  # loop closed: the awaiter is gone
            self.memory_store.add_done_callback(oid, _ready)
            if timeout is not None:
                try:
                    await asyncio.wait_for(fut, timeout)
                except asyncio.TimeoutError:
                    # deregister: a wedged producer must not accumulate
                    # one dead closure per timed-out request
                    self.memory_store.remove_done_callback(oid, _ready)
                    raise RtTimeoutError(
                        f"timed out waiting for {oid}") from None
            else:
                await fut
            entry, needs_restore = \
                self.memory_store.get_ready_no_restore(oid)
            if needs_restore:
                # spilled while pending-to-ready raced us: restore off-loop
                entry = await asyncio.get_running_loop().run_in_executor(
                    None, self.memory_store.get_if_ready, oid)
            if entry is None:
                raise ObjectLostError(oid, "entry freed while awaited")
        if entry.error is not None:
            raise self.deserialize(entry.error)
        if entry.value is not None:
            return await self._device_resolve_async(
                self.deserialize(entry.value))
        if entry.location is not None:
            blob = await self._fetch_location_async(ref, entry.location,
                                                    timeout)
            return await self._device_resolve_async(self.deserialize(blob))
        raise ObjectLostError(ref.object_id, "entry has no value")

    async def _device_resolve_async(self, value: Any) -> Any:
        """Plain values (the data-plane hot path) resolve inline with zero
        hops; a device-object marker needs the blocking pull machinery in
        :meth:`_maybe_device_resolve` (sync RPC + ``IoContext.run``), so
        it goes to a thread rather than wedging the awaiting loop."""
        from ray_tpu_torch.object_store import device as devmod

        if not isinstance(value, devmod.DeviceObjectMarker):
            return value
        return await asyncio.get_running_loop().run_in_executor(
            None, self._maybe_device_resolve, value)

    async def _fetch_location_async(self, ref: ObjectRef, location,
                                    timeout) -> bytes:
        """Async twin of :meth:`_fetch_from_location`: large value held by
        a (possibly remote) executor.  Same-node shm read happens off-loop
        (first probe may compile the native lib; big reads memcpy); the
        holder-death → reconstruct fallback reuses the blocking path on a
        thread — it is the rare recovery branch, not the data plane."""
        loop = asyncio.get_running_loop()
        if self._shm not in (False, None):
            blob = await loop.run_in_executor(None, self._shm_read,
                                              ref.object_id)
            if blob is not None:
                return blob
        # cross-node transfer service: stream straight from a holder
        # node's arena/spill file; the owner-RPC chunk path below stays
        # the fallback (and the RT_transfer_service=0 oracle)
        blob = await loop.run_in_executor(
            None, self._transfer_pull_blocking, ref.object_id)
        if blob is not None:
            return blob
        try:
            # pin the holder client's whole lifetime (connect, read loop,
            # close) to the IO loop: call_async works from a foreign loop,
            # but close() schedules on the IO loop — one loop end to end
            # leaves no cross-loop transport operation at all
            cf = asyncio.run_coroutine_threadsafe(
                self._fetch_location_io(ref, location), self._io.loop)
            return await asyncio.wrap_future(cf)
        except (RtError, Exception):  # noqa: BLE001 — holder died
            return await loop.run_in_executor(
                None, lambda: self._fetch_from_location_rpc(
                    ref, location, timeout))

    async def _fetch_location_io(self, ref: ObjectRef, location) -> bytes:
        """Runs ON the IO loop (see _fetch_location_async)."""
        holder = RpcClient(tuple(location))
        try:
            r = await holder.call_async(
                "object_info", object_id=ref.object_id.binary(),
                timeout=30.0)
            if r.get("value") is not None:
                return r["value"]
            if r.get("size") is not None:
                return await self._pull_chunks(
                    location, ref.object_id, r["size"])
        finally:
            holder.close()
        raise ObjectLostError(ref.object_id, "holder lost the value")

    def wait(self, refs: List[ObjectRef], num_returns: int, timeout: Optional[float],
             fetch_local: bool = True) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        if fetch_local:
            for ref in refs:
                self._ensure_local(ref, timeout)
        ready_ids, rest_ids = self.memory_store.wait_ready(
            [r.object_id for r in refs], num_returns, timeout)
        by_id = {r.object_id: r for r in refs}
        return [by_id[i] for i in ready_ids], [by_id[i] for i in rest_ids]

    def _ensure_local(self, ref: ObjectRef, timeout: Optional[float]):
        """If we don't own `ref` and don't hold it, start an async fetch."""
        if self.memory_store.contains(ref.object_id):
            return
        if ref.owner_address in (None, self.server.address):
            return  # we own it: value arrives via task reply
        self.memory_store.mark_pending(ref.object_id)

        async def fetch():
            oid = ref.object_id
            if oid in self._fetch_inflight:
                return
            fut = asyncio.get_running_loop().create_future()
            self._fetch_inflight[oid] = fut
            try:
                blob = await self._fetch_async(ref)
                if isinstance(blob, _RemoteError):
                    self.memory_store.put(oid, error=blob.blob)
                else:
                    self.memory_store.put(oid, value=blob)
            except Exception as e:  # noqa: BLE001
                self.memory_store.put(oid, error=pickle.dumps(
                    ObjectLostError(oid, f"fetch failed: {e}")))
            finally:
                self._fetch_inflight.pop(oid, None)
                fut.set_result(None)

        self._io.spawn_threadsafe(fetch())

    def _owner_dead_check(self, ref: ObjectRef):
        """``abort_check`` for owner-fetch retries: after a connection
        failure, ask the local raylet whether the owner worker is a
        process it reaped — a SIGKILLed owner then fails the fetch in one
        local round trip instead of the full reconnect budget.  "Unknown"
        (foreign-node or driver owner, raylet unreachable) keeps the
        patient retry path."""
        async def check(_exc) -> bool:
            wid = ref.owner_id
            if wid is None or wid == self.worker_id \
                    or not self.raylet_address:
                return False
            key = wid.binary()
            if key in self._dead_owners:
                return True
            try:
                probe = RpcClient(self.raylet_address)
                try:
                    r = await probe.call_async(
                        "worker_alive", worker_id=key, timeout=5.0)
                finally:
                    probe.close()
            except Exception:  # noqa: BLE001 — raylet unreachable
                return False
            if r.get("known") and not r.get("alive"):
                self._dead_owners.add(key)
                return True
            return False
        return check

    async def _fetch_async(self, ref: ObjectRef, allow_reconstruct: bool = True) -> bytes:
        """Ask the owner for value-or-location; chase the location; on holder
        death ask the owner to reconstruct from lineage."""
        # same-node shm fast path — off-loop (the first probe may compile
        # the native lib, and big reads memcpy) and only if already probed
        if self._shm not in (False, None):
            blob = await asyncio.get_running_loop().run_in_executor(
                None, self._shm_read, ref.object_id)
            if blob is not None:
                return blob
        # cross-node transfer service: resolve live copies from the GCS
        # location directory and stream from a holder node before asking
        # the owner — large borrowed values skip the chunk-RPC path
        blob = await asyncio.get_running_loop().run_in_executor(
            None, self._transfer_pull_blocking, ref.object_id)
        if blob is not None:
            return blob
        if (ref.owner_id is not None
                and ref.owner_id.binary() in self._dead_owners):
            raise ObjectLostError(ref.object_id, "owner worker died")
        owner = RetryableRpcClient(
            ref.owner_address, deadline_s=30.0,
            abort_check=self._owner_dead_check(ref))
        try:
            try:
                reply = await owner.call_async(
                    "get_object", object_id=ref.object_id.binary(),
                    timeout=None)
            except Exception as e:  # noqa: BLE001 — owner unreachable
                if (ref.owner_id is not None
                        and ref.owner_id.binary() in self._dead_owners):
                    # the abort_check confirmed death mid-retry: surface it
                    # typed instead of as a generic connection failure
                    raise ObjectLostError(
                        ref.object_id, f"owner worker died: {e}") from e
                raise
            if reply.get("error") is not None:
                return _RemoteError(reply["error"])
            if reply.get("value") is not None:
                return reply["value"]
            location = reply.get("location")
            if location is None:
                raise ObjectLostError(ref.object_id, "owner has no value or location")
            nid = reply.get("node_id")
            if nid and self._transfer_enabled:
                # owner named the holder NODE: retry the wire path with
                # the hint — covers the directory-flush race where the
                # copy sealed after our directory lookup above
                self._object_locality[ref.object_id.binary()] = {
                    "node_id": nid, "size": int(reply.get("size") or 0)}
                blob = await asyncio.get_running_loop().run_in_executor(
                    None, self._transfer_pull_blocking, ref.object_id)
                if blob is not None:
                    return blob
            holder = RpcClient(tuple(location))
            try:
                r2 = await holder.call_async(
                    "object_info", object_id=ref.object_id.binary(), timeout=30.0)
                if r2.get("value") is not None:
                    return r2["value"]
                if r2.get("size") is not None:
                    return await self._pull_chunks(
                        location, ref.object_id, r2["size"])
                raise ObjectLostError(ref.object_id, "holder lost the value")
            except (Exception,) as e:  # noqa: BLE001 - holder died
                holder.close()
                if not allow_reconstruct:
                    raise
                await owner.call_async(
                    "reconstruct_object", object_id=ref.object_id.binary(), timeout=None)
                return await self._fetch_async(ref, allow_reconstruct=False)
        finally:
            owner.close()

    def _fetch_from_location(self, ref: ObjectRef, location, timeout) -> bytes:
        # same-node fast path: the holder also sealed it into the node's
        # shm store — read it from shared pages, no RPC
        blob = self._shm_read(ref.object_id)
        if blob is not None:
            return blob
        blob = self._transfer_pull_blocking(ref.object_id)
        if blob is not None:
            return blob
        return self._fetch_from_location_rpc(ref, location, timeout)

    def _fetch_from_location_rpc(self, ref: ObjectRef, location,
                                 timeout) -> bytes:
        """Owner-side blocking fetch of a large result held by the
        executor (same holder protocol as the async path: ONE
        implementation, :meth:`_fetch_location_io`, run on the IO loop)."""
        try:
            return self._io.run(
                self._fetch_location_io(ref, location), timeout)
        except (RtError, Exception) as e:  # holder dead → reconstruct
            if self._try_reconstruct(ref.object_id):
                entry = self.memory_store.get_blocking(ref.object_id, timeout)
                if entry.error is not None:
                    raise self.deserialize(entry.error)
                if entry.value is not None:
                    return entry.value
                if entry.location is not None:
                    return self._fetch_from_location(ref, entry.location, timeout)
            raise ObjectLostError(ref.object_id, f"fetch failed: {e}") from e

    # ------------------------------------------- multi-node object plane
    def _report_location(self, op: str, oid_bytes: bytes,
                         size: Optional[int] = None) -> None:
        """Queue one location transition (``add`` on arena seal,
        ``remove`` on owner free, ``spill`` on demotion) for the
        coalesced GCS flush — the :meth:`_flush_actor_regs` batching
        shape: a storm of seals costs one directory RPC per loop tick,
        not one per object."""
        if not self._transfer_enabled:
            return
        if op == "add":
            self._object_locality[oid_bytes] = {
                "node_id": self.node_id.hex(), "size": int(size or 0)}
            if len(self._object_locality) > 50_000:
                for k in list(self._object_locality)[:10_000]:
                    self._object_locality.pop(k, None)
        elif op == "remove":
            self._object_locality.pop(oid_bytes, None)
        u: dict = {"op": op, "object_id": oid_bytes}
        if op != "remove":
            # an owner-side remove carries NO node_id: the GCS drops the
            # whole entry — every copy dies with the owner's free
            u["node_id"] = self.node_id.binary()
        if size is not None:
            u["size"] = int(size)
        with self._loc_lock:
            self._pending_loc_updates.append(u)
            if self._loc_flush_scheduled:
                return
            self._loc_flush_scheduled = True
        try:
            self._io.loop.call_soon_threadsafe(self._flush_loc_updates)
        except RuntimeError:  # loop closed: shutting down
            pass

    def _flush_loc_updates(self):
        with self._loc_lock:
            batch, self._pending_loc_updates = self._pending_loc_updates, []
            self._loc_flush_scheduled = False
        if not batch:
            return

        async def send():
            from ray_tpu_torch.rpc.rpc import RpcMethodNotFound

            try:
                await self.gcs.call_async("object_locations_update",
                                          updates=batch)
            except (RpcMethodNotFound, RemoteMethodError):
                # older GCS (rolling upgrade): the directory is an
                # optimization — the owner value/location protocol is
                # still complete without it
                pass
            except Exception:  # noqa: BLE001 — next seal re-reports
                logger.debug("location update flush failed", exc_info=True)

        self._io.spawn(send())

    def _transfer_addr_for(self, node_hex: Optional[str]):
        """node-id hex → ``(host, port)`` of that node's transfer
        service, None when unknown/remote-less. Blocking on a cache miss
        (one GCS node-table refresh) — executor threads only, never the
        IO loop."""
        if not node_hex or node_hex == self.node_id.hex():
            return None
        addr = self._node_transfer_addrs.get(node_hex)
        if addr is not None:
            return addr or None  # () = negative-cached: no service there
        try:
            for n in self.gcs.get_all_nodes():
                ta = n.get("transfer_address")
                self._node_transfer_addrs[n["node_id"].hex()] = (
                    tuple(ta) if ta and n.get("alive", True) else ())
        except Exception:  # noqa: BLE001 — resolver is best-effort
            return None
        return self._node_transfer_addrs.get(node_hex) or None

    def _transfer_pull_blocking(self, oid: ObjectID, deadline=None):
        """Pull one object over the node transfer service (the zero-copy
        wire path, object_store/transfer.py): owner's locality hint
        first, then every live copy in the GCS directory.  A holder node
        that died mid-pull just advances to the next source.  Returns
        the landed view/bytes or None — the caller then falls back to
        the legacy owner-RPC chunk path (the ``RT_transfer_service=0``
        oracle path).  Blocking: executor threads only.

        ONE deadline spans every source (default 30 s for the whole
        sweep): without it, N stale directory rows stacked N full
        per-pull timeouts before the fallback path ever ran."""
        if not self._transfer_enabled:
            return None
        from ray_tpu_torch.common.retry import Deadline
        from ray_tpu_torch.object_store import transfer as _transfer

        if deadline is None:
            deadline = Deadline(30.0)

        oid_bytes = oid.binary()
        my_hex = self.node_id.hex()
        sources: list = []
        seen = set()
        hint = self._object_locality.get(oid_bytes)
        if hint and hint.get("node_id") != my_hex:
            addr = self._transfer_addr_for(hint.get("node_id"))
            if addr is not None:
                sources.append(tuple(addr))
                seen.add(hint["node_id"])
        try:
            rows = self.gcs.get_object_locations(
                [oid_bytes]).get(oid.hex()) or []
        except Exception:  # noqa: BLE001 — directory may be older/absent
            rows = []
        for r in rows:
            nid = r.get("node_id")
            if nid in seen or nid == my_hex:
                continue
            seen.add(nid)
            addr = r.get("address") or self._transfer_addr_for(nid)
            if addr is not None:
                sources.append(tuple(addr))
        shm = self.shm
        for addr in sources:
            if deadline.expired():
                return None  # budget spent: let the fallback path run
            try:
                view = _transfer.pull_object(addr, oid_bytes, shm=shm,
                                             deadline=deadline)
            except _transfer.TransferNotFound:
                continue  # that copy is already gone — next source
            except Exception:  # noqa: BLE001 — holder node unreachable
                continue
            if view is None:
                continue
            if shm is not None and shm.contains(oid_bytes):
                # landed as a sealed arena copy: this node is now a
                # source too — the fallback location holder-death
                # recovery depends on
                self._report_location("add", oid_bytes, size=len(view))
            return view
        return None

    # ------------------------------------------------------- task submission
    def fail_control_plane(self, exc: Exception) -> None:
        """Control-plane process died (multi-process shape): record the
        typed error and fail every normal task still QUEUED for a lease —
        leases need the raylet, so those can never run.  Work already
        pushed to live workers keeps its direct connection and completes
        normally (the Podracer argument: data plane outlives control
        plane)."""
        self._control_plane_error = exc
        logger.error("control plane failed: %s", exc)
        self.submitter.fail_queued(exc)

    def _raise_if_control_plane_dead(self) -> None:
        if self._control_plane_error is not None:
            raise self._control_plane_error

    def submit_task(
        self,
        func,
        args: tuple,
        kwargs: dict,
        *,
        num_returns: int = 1,
        resources: Optional[dict] = None,
        label_selector: Optional[dict] = None,
        scheduling_strategy=None,
        max_retries: Optional[int] = None,
        name: str = "",
        serialized_func: Optional[bytes] = None,
        runtime_env: Optional[dict] = None,
        streaming: bool = False,
    ):
        from ray_tpu_torch.runtime_env.runtime_env import merge as _merge_env

        self._raise_if_control_plane_dead()
        task_id = TaskID.for_normal_task(
            self.job_id, self.current_task_id(), self.next_task_index())
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            task_type=TaskType.NORMAL_TASK,
            function=FunctionDescriptor(
                getattr(func, "__module__", "?"), getattr(func, "__qualname__", str(func))),
            serialized_func=serialized_func or cloudpickle.dumps(func),
            args=self._serialize_args(args, kwargs),
            num_returns=0 if streaming else num_returns,
            streaming=streaming,
            required_resources=ResourceRequest(
                {"CPU": 1} if resources is None else resources, label_selector),
            scheduling_strategy=scheduling_strategy or DefaultStrategy(),
            max_retries=GLOBAL_CONFIG.get("max_task_retries") if max_retries is None else max_retries,
            parent_task_id=self.current_task_id(),
            caller_worker_id=self.worker_id,
            caller_address=self.server.address,
            name=name,
            runtime_env=_merge_env(
                getattr(self, "job_runtime_env", None), runtime_env),
        )
        if spec.runtime_env is not None:
            from ray_tpu_torch.runtime_env.runtime_env import env_hash

            spec.runtime_env_hash = env_hash(spec.runtime_env)
        return self._register_and_submit(spec)

    def _register_and_submit(self, spec: TaskSpec) -> List[ObjectRef]:
        if _tracing.enabled():
            ctx = _tracing.current_context()
            if ctx is not None:
                spec.tracing = ctx
                # the native fastspec buffer doesn't carry tracing; fall
                # back to the pickled spec for traced submissions
                if hasattr(spec, "_fast_payload"):
                    del spec._fast_payload
        refs = []
        with self._lineage_lock:
            for oid in spec.return_ids():
                self.memory_store.mark_pending(oid)
                if GLOBAL_CONFIG.get("lineage_pinning_enabled"):
                    self.lineage[oid] = spec
                refs.append(ObjectRef(oid, self.worker_id, self.server.address))
        if spec.streaming:
            from .generator import ObjectRefGenerator, _StreamState

            self._generators[spec.task_id] = _StreamState(spec)
        if spec.is_actor_task():
            self._actor_submitter(spec.actor_id).submit(spec)
        else:
            self.submitter.submit(spec)
        if spec.streaming:
            return ObjectRefGenerator(self, spec.task_id)
        return refs

    def _serialize_args(self, args: tuple, kwargs: dict,
                        allow_oob: bool = True) -> List[TaskArg]:
        """Inline small values; pass ObjectRefs — and large buffer-bearing
        values (out-of-band promotion, see :meth:`_pack_arg`) — by
        reference. ``allow_oob=False`` keeps every plain value inline
        (actor CREATION specs: the GCS replays them on restart at any
        later time, so they must stay self-contained)."""
        out: List[TaskArg] = []
        plain_args = list(args)
        if kwargs:
            plain_args.append(_KwArgsMarker(kwargs))
        for value in plain_args:
            if isinstance(value, ObjectRef):
                arg = TaskArg.by_ref(value.object_id, value.owner_id)
                arg.owner_address = value.owner_address
                if value.owner_address is not None:
                    # By-ref args bypass pickle: guard the handoff here;
                    # released (token-idempotently) by ack_args_handoffs at
                    # task completion.
                    arg.handoff_token = os.urandom(8)
                    self._handoff_begin(value.object_id, value.owner_address,
                                        arg.handoff_token)
                out.append(arg)
            elif allow_oob:
                out.append(self._pack_arg(value))
            else:
                out.append(TaskArg.inline(self.serialize(value)))
        return out

    def _pack_arg(self, value: Any) -> TaskArg:
        """Serialize one plain task arg. Values whose pickle-5 out-of-band
        buffers (numpy arrays, torch CPU tensors, explicit
        ``pickle.PickleBuffer``s — anything whose reduce exports buffers)
        total >= ``oob_arg_threshold`` are written ONCE into the shm arena
        (create/seal, one memcpy) and passed by reference: a same-node
        executee rebuilds them as read-only zero-copy views over the
        mapped pages; a remote one fetches through the ordinary object
        plane. The memcpy happens synchronously at submit, so the caller
        mutating e.g. the source array afterwards cannot corrupt the
        in-flight args. Buffer-less, sub-threshold, non-contiguous and
        object-dtype values (whose pickles export no buffers) stay
        inline — the unchanged slow path."""
        _ser = _serialization
        meta, buffers, views, segs, total = _ser.plan(value)
        try:
            if not buffers:
                return TaskArg.inline(meta)
            threshold = GLOBAL_CONFIG.get("oob_arg_threshold")
            if threshold > 0 and _ser.buffer_bytes(segs) >= threshold:
                oid = ObjectID.for_put(self.current_task_id(),
                                       self.next_put_index())
                view = self._shm_write_framed(oid, meta, views, segs, total)
                if view is not None:
                    self.memory_store.put(oid, value=view)
                    return self._oob_ref_arg(oid)
            out = bytearray(total)
            _ser.pack_into(out, meta, views, segs)
            return TaskArg.inline(bytes(out))
        finally:
            _ser.release_buffers(buffers)

    def _oob_ref_arg(self, oid: ObjectID) -> TaskArg:
        """By-ref TaskArg for an implicitly promoted arg value. The owner
        record starts with local=0 — no user-facing ObjectRef exists, so
        the handoff guard is the only hold and the value frees exactly
        when the consuming task completes (terminally)."""
        arg = TaskArg.by_ref(oid, self.worker_id)
        arg.owner_address = self.server.address
        arg.handoff_token = os.urandom(8)
        with self._ref_lock:
            self._register_handoff_locked(
                self._owned_state_for_message(oid), arg.handoff_token)
        return arg

    # --------------------------------------------------------------- actors
    def create_actor(self, cls, args, kwargs, *, resources=None, label_selector=None,
                     scheduling_strategy=None, max_restarts=0, max_concurrency=1,
                     name=None, namespace="default",
                     runtime_env=None,
                     serialized_cls: Optional[bytes] = None) -> "ActorID":
        from ray_tpu_torch.runtime_env.runtime_env import merge as _merge_env

        self._raise_if_control_plane_dead()
        actor_id = ActorID.of(self.job_id, self.current_task_id(), self._actor_counter.next())
        creation_task_id = TaskID.for_actor_creation_task(actor_id)
        spec = TaskSpec(
            task_id=creation_task_id,
            job_id=self.job_id,
            task_type=TaskType.ACTOR_CREATION_TASK,
            function=FunctionDescriptor(
                getattr(cls, "__module__", "?"), getattr(cls, "__qualname__", str(cls))),
            serialized_func=serialized_cls or cloudpickle.dumps(cls),
            args=self._serialize_args(args, kwargs, allow_oob=False),
            num_returns=0,
            required_resources=ResourceRequest(resources or {}, label_selector),
            scheduling_strategy=scheduling_strategy or DefaultStrategy(),
            actor_id=actor_id,
            max_restarts=max_restarts,
            max_concurrency=max_concurrency,
            caller_worker_id=self.worker_id,
            caller_address=self.server.address,
            name=name or "",
            runtime_env=_merge_env(
                getattr(self, "job_runtime_env", None), runtime_env),
        )
        if name is not None:
            # named actors keep the synchronous ack: the caller must see a
            # name collision as an exception from .remote()
            reply = self.gcs.register_actor(
                pickle.dumps(spec), actor_id, self.job_id, name=name,
                namespace=namespace, max_restarts=max_restarts)
            if not reply.get("ok"):
                raise RtError(reply.get("error", "actor registration failed"))
            return actor_id

        # Unnamed actors register ASYNCHRONOUSLY (reference semantics:
        # ActorClass.remote() must not block the driver for the spawn
        # chain), and COALESCED: a burst of .remote() calls from caller
        # threads batches into ONE register_actors RPC per loop tick
        # instead of one GCS round trip per creation — at churn rates the
        # per-creation RPC (pickle + syscalls + a GCS handler dispatch)
        # was the largest driver-side cost left after the ack went async.
        blob = pickle.dumps(spec)
        entry = {"creation_spec": blob, "actor_id": actor_id.binary(),
                 "namespace": namespace, "max_restarts": max_restarts}
        with self._actor_reg_lock:
            self._pending_actor_regs.append(entry)
            if self._actor_reg_flush_scheduled:
                return actor_id
            self._actor_reg_flush_scheduled = True
        self._io.loop.call_soon_threadsafe(self._flush_actor_regs)
        return actor_id

    def _flush_actor_regs(self):
        """Ship every registration queued since the last flush as one
        batched GCS RPC (falls back to per-actor register_actor against a
        pre-batching GCS)."""
        with self._actor_reg_lock:
            batch, self._pending_actor_regs = self._pending_actor_regs, []
            self._actor_reg_flush_scheduled = False
        if not batch:
            return

        async def send():
            from ray_tpu_torch.rpc.rpc import RpcMethodNotFound

            try:
                try:
                    reply = await self.gcs.call_async(
                        "register_actors", specs=batch,
                        job_id=self.job_id.binary())
                except (RpcMethodNotFound, RemoteMethodError):
                    # older GCS (rolling upgrade): per-actor fallback —
                    # each actor's failure is its own (one transient error
                    # must not abort the rest of the batch)
                    for e in batch:
                        try:
                            await self.gcs.call_async(
                                "register_actor",
                                creation_spec=e["creation_spec"],
                                actor_id=e["actor_id"],
                                job_id=self.job_id.binary(), name=None,
                                namespace=e["namespace"],
                                max_restarts=e["max_restarts"])
                        except Exception:  # noqa: BLE001
                            logger.exception(
                                "fallback actor registration failed")
                    return
                for err in (reply or {}).get("errors") or []:
                    logger.error("batched actor registration failed: %s",
                                 err)
            except Exception:  # noqa: BLE001 — resolution will time out
                logger.exception("batched actor registration failed")

        self._io.spawn(send())

    def submit_actor_task(self, actor_id: ActorID, method_name: str, args, kwargs,
                          *, num_returns: int = 1, name: str = "",
                          streaming: bool = False):
        sub = self._actor_submitter(actor_id)
        seq = sub.next_seq()
        task_id = TaskID.for_actor_task(actor_id, self.current_task_id(), self.next_task_index())
        # Fast path (native submit record): plain-value calls serialize
        # (args, kwargs) as ONE payload; by-ref args need the TaskArg
        # handoff protocol and take the general path. Streaming tasks take
        # the general path (the fastspec buffer has no streaming field).
        # Large buffer-bearing bundles promote out-of-band (_pack_arg):
        # the whole _FastArgs lands in the shm arena and ships by ref —
        # one memcpy beats pickling MBs through the socket even though it
        # forfeits the fastloop channel for that call.
        fast_payload = None
        if not streaming and not any(isinstance(v, ObjectRef) for v in args) and \
                not any(isinstance(v, ObjectRef) for v in kwargs.values()):
            if not args and not kwargs:
                # zero-arg calls: the payload is a constant — serialize once
                fast_payload = self._empty_args_payload
                if fast_payload is None:
                    fast_payload = self._empty_args_payload = \
                        self.serialize(_FastArgs((), {}))
                task_args = [TaskArg.inline(fast_payload)]
            else:
                arg = self._pack_arg(_FastArgs(tuple(args), dict(kwargs)))
                if arg.is_inline:
                    fast_payload = arg.value
                task_args = [arg]
        else:
            task_args = self._serialize_args(args, kwargs)
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            task_type=TaskType.ACTOR_TASK,
            function=FunctionDescriptor("", method_name),
            serialized_func=None,
            args=task_args,
            num_returns=0 if streaming else num_returns,
            streaming=streaming,
            required_resources=ResourceRequest({}),
            actor_id=actor_id,
            actor_method_name=method_name,
            sequence_number=seq,
            caller_worker_id=self.worker_id,
            caller_address=self.server.address,
            name=name or method_name,
        )
        spec._fast_payload = fast_payload
        return self._register_and_submit(spec)

    def _actor_submitter(self, actor_id: ActorID) -> ActorTaskSubmitter:
        with self._actor_sub_lock:
            sub = self._actor_submitters.get(actor_id)
            if sub is None:
                sub = ActorTaskSubmitter(self, actor_id)
                self._actor_submitters[actor_id] = sub
                if not self._actor_events_subscribed:
                    self._actor_events_subscribed = True
                    self.gcs.subscriber.subscribe("actor", self._on_actor_event)
            return sub

    def _on_actor_event(self, actor_hex: str, view: dict):
        try:
            aid = ActorID(bytes.fromhex(actor_hex))
        except ValueError:
            return
        with self._actor_sub_lock:
            sub = self._actor_submitters.get(aid)
            if sub is None:
                return
            # a dead actor's submitter only has to deliver the death to
            # in-flight callers; drop the table entry so day-scale drivers
            # (and per-event dispatch) don't grow with every actor ever made
            if view.get("state") == "DEAD":
                self._actor_submitters.pop(aid, None)
        sub.notify_actor_state(view)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        self.gcs.kill_actor(actor_id, no_restart)

    # ------------------------------------------------------------ cancel
    def cancel_task(self, ref, force: bool = False) -> dict:
        """cancel(ref): route to the ref's OWNER, who holds the submission
        state (reference: CoreWorker::CancelTask / HandleCancelTask).
        Self-owned refs take the same RPC loopback — owner-side state lives
        on the IO loop and callers are arbitrary user threads. Accepts an
        ObjectRef or an ObjectRefGenerator (streaming task)."""
        from .generator import ObjectRefGenerator

        if isinstance(ref, ObjectRefGenerator):
            owner = self.server.address  # streams are owner-local
            payload = {"task_id": ref.task_id.binary()}
        else:
            owner = tuple(ref.owner_address or self.server.address)
            payload = {"object_id": ref.object_id.binary()}
        client = RetryableRpcClient(owner, deadline_s=30.0)
        try:
            return client.call("cancel_task", force=force, **payload)
        finally:
            client.close()

    async def h_cancel_task(self, object_id: bytes = None,
                            force: bool = False, task_id: bytes = None):
        """Owner side of cancel: remove a queued task (store
        TaskCancelledError on its returns), or forward the interrupt to the
        executor currently running it. force=True kills the executing
        worker process; the push failure then resolves to
        TaskCancelledError via the cancelled-id set."""
        if task_id is not None:
            tid_bin = task_id
        else:
            oid = ObjectID(object_id)
            tid_bin = oid.task_id().binary()
            if self.memory_store.get_if_ready(oid) is not None:
                # finished tasks are unaffected — in particular their
                # lineage stays reconstructible
                return {"status": "already_done"}
        self._cancelled_tasks.add(tid_bin)
        # cancelled tasks must never be revived by lineage reconstruction
        with self._lineage_lock:
            for l_oid in [o for o in self.lineage
                          if o.task_id().binary() == tid_bin]:
                self.lineage.pop(l_oid, None)
        state, addr = self.submitter.cancel(tid_bin)
        if state is None:
            with self._actor_sub_lock:
                subs = list(self._actor_submitters.values())
            for sub in subs:
                state, addr = sub.cancel(tid_bin)
                if state is not None:
                    break
        if state == "running" and addr is not None:
            try:
                c = RetryableRpcClient(tuple(addr), deadline_s=10.0)
                try:
                    await c.call_async("cancel_running_task",
                                       task_id=tid_bin, force=force)
                finally:
                    c.close()
            except Exception:  # noqa: BLE001 — worker may already be gone
                pass
        # streaming: unblock readers immediately (the producer also stops
        # at its next report — the owner replies cancel to a failed stream)
        st = self._generators.get(TaskID(tid_bin))
        if st is not None and not st.done_or_failed():
            st.fail(pickle.dumps(TaskCancelledError(
                "the streaming task was cancelled")))
        return {"status": state or "not_found"}

    async def h_cancel_running_task(self, task_id: bytes,
                                    force: bool = False):
        """Executor side of cancel. Sync tasks get TaskCancelledError
        raised asynchronously in their executor thread (lands at the next
        bytecode boundary — blocking C calls are only interruptible via
        force). Async actor calls get their asyncio task cancelled.
        force=True exits the worker process; the owner converts the
        resulting push failure into TaskCancelledError."""
        rec = self._running_tasks.get(task_id)
        if rec is None:
            # push may be in flight: reject the task when it arrives
            self._cancel_requested.add(task_id)
            return {"status": "not_running"}
        if force:
            self._io.loop.call_later(0.05, os._exit, 1)
            return {"status": "killed"}
        fut = rec.get("future")
        if fut is not None:
            fut.cancel()
        thread_ident = rec.get("thread")
        if thread_ident is not None:
            import ctypes

            # TOCTOU guard: if the task finished between lookup and here,
            # the thread may already be running something else — re-check
            # the registry right before delivery. A residual race remains
            # (inherent to async exceptions; the reference's SIGINT path
            # has the same window) but this shrinks it to nanoseconds.
            cur = self._running_tasks.get(task_id)
            if cur is None or cur.get("thread") != thread_ident:
                return {"status": "not_running"}
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(thread_ident),
                ctypes.py_object(TaskCancelledError))
        return {"status": "cancelled"}

    # -------------------------------------------------------- reply handling
    def store_task_reply(self, spec: TaskSpec, reply: dict, executor_addr):
        """Owner side: record results (values inline, or locations for large)."""
        self.ack_args_handoffs(spec)
        if spec.streaming:
            # authoritative completion backup: item reports normally finish
            # the stream first, but a lost done-report must not hang readers
            st = self._generators.get(spec.task_id)
            if st is not None:
                if reply.get("stream_error") is not None:
                    st.fail(reply["stream_error"])
                elif "streamed" in reply:
                    st.finish(reply["streamed"])
                elif reply.get("results"):
                    # the executee rejected the task wholesale (e.g. not a
                    # generator): surface the error to stream readers
                    for payload in reply["results"].values():
                        if "error" in payload:
                            st.fail(payload["error"])
                            break
        results = reply.get("results", {})
        for oid_bytes, payload in results.items():
            oid = ObjectID(oid_bytes)
            if "value" in payload:
                self.memory_store.put(oid, value=payload["value"])
            elif "error" in payload:
                self.memory_store.put(oid, error=payload["error"])
            elif "location" in payload:
                self.memory_store.put(oid, location=tuple(payload["location"]))
                nid = payload.get("node_id")
                if nid and self._transfer_enabled:
                    # the executee named its node: the owner's locality
                    # cache now routes cold gets (and the next lease's
                    # locality hint) at that node's transfer service
                    self._object_locality[oid_bytes] = {
                        "node_id": nid,
                        "size": int(payload.get("size") or 0)}

    # ----------------------------------------------------------- lineage/GC
    def _try_reconstruct(self, object_id: ObjectID) -> bool:
        if object_id.task_id().binary() in self._cancelled_tasks:
            return False  # a cancelled task is never re-executed
        with self._lineage_lock:
            spec = self.lineage.get(object_id)
            now = time.monotonic()
            if spec is None:
                return False
            last = self._reconstructing.get(object_id, 0)
            if now - last < 1.0:
                return True  # already resubmitted very recently
            self._reconstructing[object_id] = now
        logger.info("reconstructing %s via lineage re-execution", object_id.hex()[:12])
        respec = pickle.loads(pickle.dumps(spec))  # fresh copy
        # (ack_args_handoffs will fire again at re-completion; token-keyed
        # consumes are idempotent so no re-guard is needed.)
        to_reset = respec.return_ids()
        if respec.streaming:
            # streamed items aren't in return_ids; reset just the lost one —
            # the replayed generator re-reports it (dedup skips the rest).
            # Record a heal marker so the replay is allowed to run to this
            # index even when the ObjectRefGenerator itself is long dropped.
            to_reset = [object_id]
            if respec.task_id not in self._generators:
                self._stream_heal.setdefault(
                    respec.task_id, set()).add(object_id)
        self.memory_store.free(to_reset)
        for oid in to_reset:
            self.memory_store.mark_pending(oid)
        if respec.is_actor_task():
            self._actor_submitter(respec.actor_id).submit(respec)
        else:
            self.submitter.submit(respec)
        return True

    # ----------------------------------------------- distributed refcounting
    # Owner-side transit guards are keyed by per-handoff random tokens, so
    # every consume (borrow_ack / handoff_done) is IDEMPOTENT: replayed
    # deserializations, retried tasks, and ack-vs-incref races cannot
    # unbalance the count (reference: reference_count.h tracks borrower
    # request ids similarly).
    _HANDOFF_TTL_S = 600.0  # transit guard expiry (receiver died in flight)
    _CONSUMED_CAP = 8192    # remembered consumed tokens per object

    def _owned_state(self, oid: ObjectID) -> dict:
        """Owner-side refcount record; lazily created with one local ref
        (the ObjectRef handed out at creation)."""
        st = self._owned_refs.get(oid)
        if st is None:
            st = self._owned_refs[oid] = {
                "local": 1, "in_flight": {}, "borrowers": set(),
                "consumed": set()}
        return st

    def _on_ref_serialized(self, ref: ObjectRef, token: bytes):
        """Handoff guard: register the token at the owner before the pickled
        bytes can reach a receiver."""
        if ref.owner_address is None:
            return  # untracked ref: nothing to guard or ack later
        self._handoff_begin(ref.object_id, ref.owner_address, token)

    def _handoff_begin(self, oid: ObjectID, owner_address, token: bytes):
        """One handoff of `oid` is in transit (pickled ref or by-ref task
        arg). Consumed by a borrow_ack (deserialization) or handoff_done
        (task-arg resolution / terminal task failure)."""
        if tuple(owner_address) == self.server.address:
            with self._ref_lock:
                self._register_handoff_locked(self._owned_state(oid), token)
            return
        # Borrower re-shares the ref: async incref to the owner. Our own
        # active borrow keeps the object alive meanwhile; our eventual
        # borrow_release is chained behind this incref's completion.
        self._chain_borrow_msg(oid, tuple(owner_address), "incref_inflight",
                               token=token)

    @staticmethod
    def _register_handoff_locked(st: dict, token: bytes) -> None:
        # An ack that raced ahead of this registration already consumed the
        # token: don't re-add it.
        if token in st["consumed"]:
            st["consumed"].discard(token)
            return
        st["in_flight"][token] = time.monotonic()

    @classmethod
    def _consume_handoff_locked(cls, st: dict, token: bytes) -> None:
        if token in st["in_flight"]:
            del st["in_flight"][token]
        else:
            # Unknown token: the registration hasn't arrived yet (incref
            # race) — remember so the late registration is a no-op.
            st["consumed"].add(token)
            if len(st["consumed"]) > cls._CONSUMED_CAP:
                st["consumed"].pop()

    def _ack_handoff(self, oid: ObjectID, owner_address, token: bytes):
        """Consume one in-flight handoff at the owner (no borrow taken)."""
        if owner_address is None or token is None:
            return
        if tuple(owner_address) == self.server.address:
            with self._ref_lock:
                st = self._owned_refs.get(oid)
                if st is not None:
                    self._consume_handoff_locked(st, token)
            self._maybe_free_owned(oid)
            return
        self._chain_borrow_msg(oid, tuple(owner_address), "handoff_done",
                               token=token)

    def ack_args_handoffs(self, spec: TaskSpec):
        """Called on task completion (reply stored or terminal failure):
        release the handoff guard on every by-ref argument. Token-idempotent,
        so double completion (e.g. _mark_dead racing a late reply) is safe."""
        for arg in spec.args:
            if not arg.is_inline and arg.object_id is not None:
                self._ack_handoff(arg.object_id,
                                  getattr(arg, "owner_address", None),
                                  getattr(arg, "handoff_token", None))

    def _on_ref_deserialized(self, ref: ObjectRef, token: bytes):
        oid = ref.object_id
        if ref.owner_address is None:
            return
        if ref.owner_address == self.server.address:
            # Our own ref came back: new local handle, one handoff consumed.
            ref._borrowed = False
            with self._ref_lock:
                st = self._owned_state(oid)
                st["local"] += 1
                if token is not None:
                    self._consume_handoff_locked(st, token)
            return
        with self._ref_lock:
            b = self._borrowed.get(oid)
            if b is None:
                b = self._borrowed[oid] = {"count": 0, "chain": None}
            b["count"] += 1
        # Consuming the token is idempotent; borrower-set membership is a set
        # add — deserializing the same blob N times is safe on both counts.
        self._chain_borrow_msg(oid, ref.owner_address, "borrow_ack",
                               token=token)

    def _chain_borrow_msg(self, oid: ObjectID, owner_addr, method: str,
                          token: Optional[bytes] = None):
        """Send a borrow-protocol message to the owner, strictly ordered
        per-object from this process (release must not overtake ack)."""

        async def send(prev):
            if prev is not None:
                try:
                    await prev
                except Exception:  # noqa: BLE001
                    pass
            try:
                c = RpcClient(owner_addr)
                await c.call_async(method, object_id=oid.binary(),
                                   worker_id=self.worker_id.binary(),
                                   token=token, timeout=10.0)
                c.close()
            except Exception:  # noqa: BLE001 — owner death moots refcounts
                pass
            if method == "borrow_release":
                # Tail of the chain after a full release: drop the record
                # unless a new borrow/send has extended the chain since.
                with self._ref_lock:
                    b = self._borrowed.get(oid)
                    if b is not None and b["count"] <= 0 \
                            and b["chain"] is asyncio.current_task():
                        del self._borrowed[oid]

        def spawn():
            with self._ref_lock:
                b = self._borrowed.get(oid)
                if b is None:
                    b = self._borrowed[oid] = {"count": 0, "chain": None}
                prev = b["chain"]
                b["chain"] = self._io.spawn(send(prev))

        try:
            self._io.loop.call_soon_threadsafe(spawn)
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass

    def _on_ref_deleted(self, ref: ObjectRef):
        """Release sink: owner refs decrement the local count and free when
        nothing (local, in-flight, borrower) holds the object; borrowed refs
        send an ordered borrow_release to the owner."""
        oid = ref.object_id
        if ref.owner_address == self.server.address:
            free_now = False
            with self._ref_lock:
                st = self._owned_refs.get(oid)
                if st is None:
                    st = self._owned_refs[oid] = {
                        "local": 0, "in_flight": {}, "borrowers": set(),
                        "consumed": set()}
                else:
                    st["local"] = max(0, st["local"] - 1)
                self._expire_handoffs_locked(st)
                free_now = (st["local"] <= 0 and not st["in_flight"]
                            and not st["borrowers"])
            if free_now:
                self._free_owned(oid)
        elif getattr(ref, "_borrowed", False) and ref.owner_address is not None:
            with self._ref_lock:
                b = self._borrowed.get(oid)
                if b is None:
                    return
                b["count"] -= 1
                if b["count"] > 0:
                    return
            self._chain_borrow_msg(oid, ref.owner_address, "borrow_release")

    def _expire_handoffs_locked(self, st: dict) -> None:
        """Drop transit guards whose receiver evidently died in flight
        (never acked within the TTL) so the object can eventually free."""
        if not st["in_flight"]:
            return
        horizon = time.monotonic() - self._HANDOFF_TTL_S
        stale = [t for t, ts in st["in_flight"].items() if ts < horizon]
        for t in stale:
            del st["in_flight"][t]

    def _maybe_free_owned(self, oid: ObjectID):
        with self._ref_lock:
            st = self._owned_refs.get(oid)
            if st is None:
                return
            self._expire_handoffs_locked(st)
            if st["local"] > 0 or st["in_flight"] or st["borrowers"]:
                return
        self._free_owned(oid)

    # The reference's lineage-pinning contract (reference_count.h lineage
    # pinning + max_lineage_bytes): freeing a consumed intermediate's
    # VALUE must not discard its SPEC — a downstream task retry may need
    # to re-execute it (recursively).  Round-5 scale finding: GB shuffles
    # under memory pressure lose blocks exactly here when a consumer dies
    # after its args were freed.  The table is capped FIFO instead of
    # popped-on-free.
    _LINEAGE_CAP = 20_000

    def _free_owned(self, oid: ObjectID):
        # breadcrumb for loss forensics: a later "unknown object" reply
        # distinguishes freed-then-needed from never-stored
        self._free_tombstones[oid.binary()] = time.monotonic()
        if len(self._free_tombstones) > 50_000:
            for k in list(self._free_tombstones)[:10_000]:
                self._free_tombstones.pop(k, None)
        with self._ref_lock:
            self._owned_refs.pop(oid, None)
        if not GLOBAL_CONFIG.get("lineage_pinning_enabled"):
            with self._lineage_lock:
                self.lineage.pop(oid, None)
        else:
            with self._lineage_lock:
                while len(self.lineage) > self._LINEAGE_CAP:
                    self.lineage.pop(next(iter(self.lineage)), None)
        location = self.memory_store.peek_location(oid)
        self.memory_store.free([oid])
        self.device_store.free(oid.binary())
        if self._shm not in (False, None):
            self._shm.delete(oid.binary())
            self._shm.drop_spilled(oid.binary())
        # owner free kills EVERY copy: one directory remove (no node_id)
        # drops the whole entry so pullers stop routing anywhere
        self._report_location("remove", oid.binary())
        if location is not None and tuple(location) != self.server.address:
            # the value lives in the executor's store: tell it to drop
            async def drop():
                try:
                    c = RpcClient(tuple(location))
                    await c.call_async("drop_copy", object_id=oid.binary(),
                                       timeout=5.0)
                    c.close()
                except Exception:  # noqa: BLE001
                    pass
            try:
                self._io.spawn_threadsafe(drop())
            except Exception:  # noqa: BLE001 - shutdown
                pass

    # ---------------------------------------------------------- rpc handlers
    async def h_ping(self):
        return True

    async def h_set_visible_devices(self, gpu_ids: Optional[list] = None):
        """Export a GPU lease as ``CUDA_VISIBLE_DEVICES``. Must run before
        CUDA initialises in this process (reference:
        nvidia_gpu.py set_current_process_visible_accelerator_ids); the
        raylet never hands a worker that held GPUs to another lease."""
        if gpu_ids is None:
            return True
        want = ",".join(str(i) for i in gpu_ids)
        if (os.environ.get("CUDA_VISIBLE_DEVICES") != want
                and _cuda_may_be_fixed()):
            raise RuntimeError(
                f"CUDA may be initialised under CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}; this worker "
                f"cannot take a lease of GPUs {want!r}")
        os.environ["CUDA_VISIBLE_DEVICES"] = want
        return True

    async def h_configure_worker(self, env_vars: Optional[dict] = None,
                                 cwd: Optional[str] = None):
        """Warm-pool adoption fixup (raylet worker_pool): a pre-forked
        default-env worker is reassigned to a lease/actor whose runtime
        env differs only by env_vars/cwd. Those are applied here, post
        fork, instead of paying a fresh fork. Envs that need fork-time
        state (pip/py_modules/working_dir PYTHONPATH staging) are not
        offered to this path — the raylet falls back to a real fork."""
        if env_vars:
            os.environ.update({str(k): str(v) for k, v in env_vars.items()})
            # RT_* flag overrides may have arrived with the env
            GLOBAL_CONFIG._cache.clear()
        if cwd:
            os.chdir(cwd)
        return True

    async def h_exit_worker(self):
        def die():
            time.sleep(0.1)
            try:
                # release shm pins (the arena copies stay; only the pins
                # must not outlive this process)
                self.memory_store.drop_shm_views()
            except Exception:  # noqa: BLE001 — exit anyway
                pass
            os._exit(0)
        threading.Thread(target=die, daemon=True).start()
        return True

    async def _object_reply(self, object_id: bytes, timeout: float,
                            advertise_self: bool):
        """Shared value/error/location cascade for h_get_object (owner-facing;
        advertises this process as chunk server for large values) and
        h_object_info (holder-facing; reports size for the chunked pull)."""
        oid = ObjectID(object_id)
        loop = asyncio.get_running_loop()
        recon = "untried"
        if not self.memory_store.contains(oid):
            # owner-side recursive reconstruction: a freed intermediate
            # whose spec is still lineage-pinned is re-executed instead
            # of reported lost — the link that makes DEEP retry chains
            # (consumer died after its args were freed) converge, as does
            # a value whose spill file was lost. Not a PENDING one: a
            # return whose task is still running (or is being
            # reconstructed) is not in the store yet either, and a
            # borrower asking for it early (a ref passed on before it
            # resolved) must wait for it, not run the task a second time.
            with self._lineage_lock:
                has_lineage = oid in self.lineage
            if has_lineage and not self.memory_store.is_pending(oid):
                ok = await loop.run_in_executor(
                    self._executor, lambda: self._try_reconstruct(oid))
                recon = "resubmitted" if ok else "refused"
            else:
                recon = "no-lineage"
        meta = await loop.run_in_executor(
            self._executor,
            lambda: self.memory_store.value_meta_blocking(oid, timeout))
        if meta is None:
            freed_ago = self._free_tombstones.get(oid.binary())
            freed = (f"freed {time.monotonic() - freed_ago:.1f}s ago"
                     if freed_ago is not None else "never stored/freed here")
            hist = self.memory_store.history(oid)
            return {"error": pickle.dumps(ObjectLostError(
                oid, f"unknown object (owner={self.server.address}, "
                     f"mode={self.mode}, {freed}, "
                     f"reconstruction={recon}, history={hist[-12:]})"))}
        if meta.get("error") is not None:
            return {"error": meta["error"]}
        size = meta.get("size")
        if size is not None:
            # Large values are never shipped as one frame (reference
            # object_manager splits at 5 MiB chunks, object_manager.h:119);
            # spilled values report their size WITHOUT a restore — chunks
            # are served straight from the spill file by read_range.
            if size > GLOBAL_CONFIG.get("object_store_chunk_size_bytes"):
                if advertise_self:
                    return {"location": self.server.address, "size": size,
                            "node_id": self.node_id.hex()}
                return {"size": size}
            value = self.memory_store.read_range(oid, 0, size)
            if value is not None:
                return {"value": value}
            return {"error": pickle.dumps(ObjectLostError(oid, "value lost"))}
        if meta.get("location") is not None:
            return {"location": meta["location"]}
        return {"error": pickle.dumps(ObjectLostError(oid, "empty entry"))}

    async def h_get_object(self, object_id: bytes, timeout: float = 60.0):
        return await self._object_reply(object_id, timeout,
                                        advertise_self=True)

    async def h_object_info(self, object_id: bytes, timeout: float = 60.0):
        """Holder-side metadata probe for the chunked pull path."""
        return await self._object_reply(object_id, timeout,
                                        advertise_self=False)

    async def h_device_object_get(self, object_id: bytes):
        """Out-of-band device-object transfer, holder side: DMA the
        arrays to host and reply through the zero-copy object plane
        (reference: gpu_object_manager trigger_out_of_band_tensor_
        transfer — ours is pull- rather than owner-push-based). Small
        blobs reply inline; large ones are staged under a transfer id
        and pulled through the ordinary chunk path, never as one giant
        RPC frame."""
        import os as _os

        loop = asyncio.get_running_loop()
        staged = await loop.run_in_executor(
            self._executor, self.device_store.stage_to_host, object_id)
        if staged is None:
            return {"error": pickle.dumps(ObjectLostError(
                ObjectID(object_id), "device object not held here"))}
        blob = await loop.run_in_executor(
            self._executor, self.serialize, staged)
        if len(blob) <= GLOBAL_CONFIG.get("object_store_chunk_size_bytes"):
            return {"value": blob}
        sid = ObjectID(_os.urandom(ObjectID.SIZE))
        self.memory_store.put(sid, value=blob)
        # consumer pulls chunks of sid then drop_copy's it
        return {"staged_id": sid.binary(), "size": len(blob)}

    async def h_get_object_chunk(self, object_id: bytes, offset: int,
                                 length: int):
        oid = ObjectID(object_id)
        loop = asyncio.get_running_loop()

        def read():
            # read_range serves spilled values straight from the spill file
            # (no restore): a chunked pull of a spilled object stays O(size)
            # total disk I/O instead of one full restore per chunk.
            return self.memory_store.read_range(oid, offset, length)

        return await loop.run_in_executor(self._executor, read)

    async def _pull_chunks(self, holder_addr, oid: ObjectID, size: int):
        """Chunked pull with bounded in-flight chunks (reference:
        pull_manager.h:49 admission control / push_manager.h:27 chunking)."""
        chunk = GLOBAL_CONFIG.get("object_store_chunk_size_bytes")
        sem = asyncio.Semaphore(GLOBAL_CONFIG.get("object_pull_max_inflight"))
        client = RpcClient(tuple(holder_addr))
        buf = bytearray(size)

        async def pull(off: int):
            n = min(chunk, size - off)
            async with sem:
                data = await client.call_async(
                    "get_object_chunk", object_id=oid.binary(), offset=off,
                    length=n, timeout=120.0)
            if data is None or len(data) != n:
                raise ObjectLostError(oid, "holder lost the value mid-pull")
            buf[off:off + n] = data

        try:
            await asyncio.gather(*[pull(o) for o in range(0, size, chunk)])
        finally:
            client.close()
        return bytes(buf)

    def _blocking_entry(self, oid: ObjectID, timeout: float):
        try:
            return self.memory_store.get_blocking(oid, timeout)
        except RtTimeoutError:
            return None

    async def h_free_object(self, object_id: bytes, borrowed: bool = False,
                            worker_id: bytes = b"", token=None):
        """Legacy alias for borrow_release (kept for wire compatibility)."""
        return await self.h_borrow_release(object_id, worker_id)

    def _owned_state_for_message(self, oid: ObjectID) -> dict:
        """Get-or-create variant for REMOTE protocol messages: created with
        local=0 — a straggler ack/incref for an object we no longer hold a
        local ref to must not mint a phantom local count that can never be
        decremented (permanent leak)."""
        st = self._owned_refs.get(oid)
        if st is None:
            st = self._owned_refs[oid] = {
                "local": 0, "in_flight": {}, "borrowers": set(),
                "consumed": set()}
        return st

    async def h_incref_inflight(self, object_id: bytes, worker_id: bytes = b"",
                                token: Optional[bytes] = None):
        oid = ObjectID(object_id)
        with self._ref_lock:
            if token is not None:
                self._register_handoff_locked(
                    self._owned_state_for_message(oid), token)
        return True

    async def h_borrow_ack(self, object_id: bytes, worker_id: bytes = b"",
                           token: Optional[bytes] = None):
        oid = ObjectID(object_id)
        with self._ref_lock:
            st = self._owned_state_for_message(oid)
            st["borrowers"].add(worker_id)
            if token is not None:
                self._consume_handoff_locked(st, token)
        return True

    async def h_borrow_release(self, object_id: bytes, worker_id: bytes = b"",
                               token=None):
        oid = ObjectID(object_id)
        with self._ref_lock:
            st = self._owned_refs.get(oid)
            if st is None:
                return True
            st["borrowers"].discard(worker_id)
        self._maybe_free_owned(oid)
        return True

    async def h_handoff_done(self, object_id: bytes, worker_id: bytes = b"",
                             token: Optional[bytes] = None):
        """A by-ref task arg was consumed (or the task terminally failed)
        without the receiver keeping a borrow."""
        oid = ObjectID(object_id)
        with self._ref_lock:
            st = self._owned_refs.get(oid)
            if st is not None and token is not None:
                self._consume_handoff_locked(st, token)
        self._maybe_free_owned(oid)
        return True

    async def h_drop_copy(self, object_id: bytes):
        """Owner freed the object: drop our cached/held copy."""
        oid = ObjectID(object_id)
        with self._ref_lock:
            if oid in self._owned_refs:
                # we ARE the owner: a stray/late drop_copy must not destroy
                # the canonical entry (the owner frees via _free_owned only)
                return False
        self.memory_store.free([oid])
        self.device_store.free(object_id)
        with self._device_cache_lock:
            self._device_obj_cache.pop(object_id, None)
        if self._shm not in (False, None):
            self._shm.delete(object_id)
            self._shm.drop_spilled(object_id)
        return True

    async def h_reconstruct_object(self, object_id: bytes):
        oid = ObjectID(object_id)
        ok = self._try_reconstruct(oid)
        if not ok:
            return {"ok": False}
        # wait until the reconstructed value lands
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(
            self._executor, lambda: self._blocking_entry(oid, 120.0))
        return {"ok": True}

    async def h_actor_method_metadata(self):
        with self._actor_lock:
            inst = self._actor_instance
        if inst is None:
            return None
        return [m for m in dir(inst) if not m.startswith("_")]

    # ------------------------------------------------------------- execution
    async def h_push_task(self, spec: bytes):
        if spec[:4] == b"RTFS":
            task = TaskSpec.from_fast(spec)
        else:
            task = pickle.loads(spec)
        # Inherit the task's runtime env as this worker's job-level default:
        # children submitted from inside the task stay in the parent's env
        # (reference: runtime_env parent-to-child inheritance). The worker
        # process IS the materialized env, so this is just spec plumbing.
        if task.runtime_env is not None:
            self.job_runtime_env = task.runtime_env
        if task.job_id is not None and not task.job_id.is_nil():
            # log-relay attribution: this worker now works for that job —
            # and child tasks submitted from inside the task must carry it
            # (their leases are reclaimed when the job finishes)
            self.current_job_hex = task.job_id.hex()
            self.job_id = task.job_id
        loop = asyncio.get_running_loop()
        if task.is_actor_task() and self._is_async_actor_call(task):
            # Async actor fast path: never parks a pool thread across the
            # user await, so thousands of concurrent calls (including ones
            # that block on events set by LATER calls) cannot exhaust the
            # executor (reference: async actors run on an event loop,
            # core_worker fiber.h).
            start = time.time()
            reply = await self._execute_async_actor_task(task)
            self._record_task_event(task, start, time.time(), reply)
            return reply
        return await loop.run_in_executor(self._executor, self._execute_task, task)

    # -------------------------------------------------- fastloop execution
    def _fast_frame(self, conn_id: int, req_id: int, payload: bytes):
        """Runs ON the C dispatch thread (rpc/native/fastloop.c Server).

        Returns the pickled reply to write inline, or None when the reply
        is deferred (send_reply later from whatever thread finishes the
        task).  MUST NOT BLOCK: an ordered call whose predecessors haven't
        executed yet is parked in the gap buffer and flushed by
        _seq_finish — blocking here would stall every caller wired to
        this worker.  An escaping exception drops the connection, which
        flips the caller to the asyncio path (seq-dedup keeps that
        exactly-once)."""
        if payload[:4] == b"RTFS":
            task = TaskSpec.from_fast(payload)
        else:
            task = pickle.loads(payload)
        if task.runtime_env is not None:
            self.job_runtime_env = task.runtime_env  # children inherit
        if task.job_id is not None and not task.job_id.is_nil():
            self.current_job_hex = task.job_id.hex()
            self.job_id = task.job_id
        if not task.is_actor_task():
            # Normal task over the lease-cached dispatch channel
            # (submitter.py _run_on_lease): no per-caller ordering
            # contract, so it goes straight to the pool with a deferred
            # reply — never executed on the C thread.
            f = self._executor.submit(self._execute_task, task)
            f.add_done_callback(
                lambda f: self._fast_deferred_reply(conn_id, req_id, f))
            return None
        if task.is_actor_task() and self._is_async_actor_call(task):
            start = time.time()
            cf = asyncio.run_coroutine_threadsafe(
                self._execute_async_actor_task(task), self._io.loop)

            def _done(f, _start=start):
                try:
                    self._record_task_event(task, _start, time.time(),
                                            f.result() if not f.exception()
                                            else {"results": {}})
                except Exception:  # noqa: BLE001
                    pass
                self._fast_deferred_reply(conn_id, req_id, f)

            cf.add_done_callback(_done)
            return None
        if self._actor_max_concurrency > 1:
            # concurrent sync methods: same executor hop the asyncio path
            # takes — the win is skipping the RPC framing, not the pool
            f = self._executor.submit(self._execute_task, task)
            f.add_done_callback(
                lambda f: self._fast_deferred_reply(conn_id, req_id, f))
            return None
        caller = (task.caller_worker_id.binary()
                  if task.caller_worker_id is not None else b"?")
        seq = task.sequence_number
        with self._actor_seq_cv:
            st = self._actor_seq_state.setdefault(
                caller, {"next": 1, "replies": {}})
            if seq > st["next"] and seq not in st["replies"]:
                buf = self._fast_gap_buf.setdefault(caller, {})
                if len(buf) > 4096:
                    raise RuntimeError(
                        "fastloop gap buffer overflow (predecessor call "
                        "lost?) — dropping connection")
                buf[seq] = (conn_id, req_id, task)
                return None
        return pickle.dumps(self._execute_task(task))

    def _fast_deferred_reply(self, conn_id: int, req_id: int, fut) -> None:
        try:
            blob = pickle.dumps(fut.result())
        except Exception:  # noqa: BLE001 — framework bug; user errors are
            # already folded into the reply by _execute_task
            logger.exception("fastloop deferred task failed")
            return
        srv = self._fast_server
        if srv is not None:
            srv.send_reply(conn_id, req_id, blob)

    def _fast_run_and_reply(self, conn_id: int, req_id: int,
                            task: TaskSpec) -> None:
        """Executor-side runner for gap-buffered frames (ready by the time
        they are flushed, so _execute_task won't block on ordering)."""
        try:
            blob = pickle.dumps(self._execute_task(task))
        except Exception:  # noqa: BLE001
            logger.exception("fastloop buffered task failed")
            return
        srv = self._fast_server
        if srv is not None:
            srv.send_reply(conn_id, req_id, blob)

    def _is_async_actor_call(self, task: TaskSpec) -> bool:
        with self._actor_lock:
            inst = self._actor_instance
        if inst is None or self._actor_max_concurrency <= 1:
            return False
        return inspect.iscoroutinefunction(
            getattr(inst, task.actor_method_name, None))

    async def _execute_async_actor_task(self, task: TaskSpec) -> dict:
        """Unordered (concurrency > 1) execution of an ``async def`` actor
        method. Runs on the IO loop; the user coroutine runs on the actor's
        dedicated loop; only brief arg-resolution work touches the pool."""
        caller = (task.caller_worker_id.binary()
                  if task.caller_worker_id is not None else b"?")
        seq = task.sequence_number
        cached = self._seq_begin(caller, seq, ordered=False,
                                 method=task.actor_method_name)
        if cached is not None:
            return cached
        tid_bin = task.task_id.binary()
        if tid_bin in self._cancel_requested:
            # cancel raced ahead of the push: never execute
            self._cancel_requested.discard(tid_bin)
            reply = self._error_reply(task, TaskCancelledError())
            self._seq_finish(caller, seq, reply)
            return reply
        sem = self._async_call_sem
        if sem is None:
            sem = self._async_call_sem = asyncio.Semaphore(
                max(1, self._actor_max_concurrency))
        loop = asyncio.get_running_loop()
        async with sem:
            with self._actor_lock:
                inst = self._actor_instance
            try:
                method = getattr(inst, task.actor_method_name)
                args, kwargs = await loop.run_in_executor(
                    self._executor, lambda: self._resolve_args(task.args))

                async def run_with_ctx():
                    # Runs as its own asyncio task on the actor loop: the
                    # contextvar set is isolated to this call.
                    from ray_tpu_torch.util import tracing as _tracing

                    self._ctx.task_id = task.task_id
                    with _tracing.span(
                            f"task::{task.actor_method_name}",
                            parent_context=getattr(task, "tracing", None),
                            attributes={"task_id": task.task_id.hex()[:16],
                                        "worker_id":
                                            self.worker_id.hex()[:8]}):
                        return await method(*args, **kwargs)

                cf = asyncio.run_coroutine_threadsafe(
                    run_with_ctx(), self._actor_async_loop())
                self._running_tasks[task.task_id.binary()] = {"future": cf}
                try:
                    result = await asyncio.wrap_future(cf)
                finally:
                    self._running_tasks.pop(task.task_id.binary(), None)
                tt = getattr(method, "__rt_method_opts__",
                             {}).get("tensor_transport")
                reply = await loop.run_in_executor(
                    self._executor,
                    lambda: self._result_reply(task, result,
                                               tensor_transport=tt))
            except asyncio.CancelledError:
                # cancel_running_task cancelled the user coroutine
                reply = self._error_reply(task, TaskCancelledError(
                    "the actor call was cancelled while running"))
            except Exception as e:  # noqa: BLE001 - user method error
                reply = self._error_reply(task, e)
        self._release_arg_copies(task)
        self._seq_finish(caller, seq, reply)
        return reply

    async def h_create_actor(self, creation_spec: bytes, node_id: bytes,
                             gpu_ids=None):
        # when the creation reached this worker, beside the raylet's spawn
        # stamp (RT_SPAWN_T) and the factory's fork stamp (RT_CHILD_T): a
        # pooled worker may have waited long between fork and its actor
        os.environ["RT_CREATE_T"] = repr(time.monotonic())
        # coalesced device grant: the raylet ships the GPU assignment on
        # the creation push instead of a preceding set_visible_devices
        # round trip (one RPC on the creation critical path, not two)
        if gpu_ids is not None:
            await self.h_set_visible_devices(gpu_ids=list(gpu_ids))
        task: TaskSpec = pickle.loads(creation_spec)
        if task.runtime_env is not None:
            self.job_runtime_env = task.runtime_env  # children inherit
        if task.job_id is not None and not task.job_id.is_nil():
            self.current_job_hex = task.job_id.hex()
            self.job_id = task.job_id  # children carry the job (see h_push_task)
        loop = asyncio.get_running_loop()

        def create():
            try:
                cls = cloudpickle.loads(task.serialized_func)
                args, kwargs = self._resolve_args(task.args)
                self._ctx.task_id = task.task_id
                inst = cls(*args, **kwargs)
                with self._actor_lock:
                    self._actor_instance = inst
                    self._actor_id = task.actor_id
                    self._actor_max_concurrency = max(1, task.max_concurrency)
                    self._actor_concurrency = threading.Semaphore(
                        self._actor_max_concurrency)
                    self._actor_has_async = any(
                        inspect.iscoroutinefunction(getattr(inst, m, None))
                        for m in dir(inst) if not m.startswith("__"))
                self._release_arg_copies(task)
                return None
            except Exception as e:  # noqa: BLE001
                return (e, traceback.format_exc())

        err = await loop.run_in_executor(self._executor, create)
        if err is not None:
            await self.gcs.call_async(
                "report_actor_state", actor_id=task.actor_id.binary(), state="DEAD",
                worker_id=self.worker_id.binary(),
                death_cause=f"creation failed: {err[0]!r}\n{err[1]}")
            return {"ok": False}
        with self._actor_lock:
            # async actors stay on the asyncio path end to end: their
            # calls already live on event loops, and detouring through the
            # C channel adds two cross-thread hops per call (measured 2x
            # slower on the async-actor bench rows)
            is_async = (self._actor_has_async
                        and self._actor_max_concurrency > 1)
        await self.gcs.call_async(
            "report_actor_state", actor_id=task.actor_id.binary(), state="ALIVE",
            worker_id=self.worker_id.binary(), address=self.server.address,
            node_id=node_id,
            fast_port=None if is_async else self._fast_port)
        return {"ok": True}

    def _execute_task(self, task: TaskSpec) -> dict:
        """Runs on an executor thread."""
        from ray_tpu_torch.util import tracing as _tracing

        start = time.time()
        tid = task.task_id.binary()
        if tid in self._cancel_requested:
            # cancelled while the push was in flight: never execute
            self._cancel_requested.discard(tid)
            reply = self._error_reply(task, TaskCancelledError())
            self._record_task_event(task, start, time.time(), reply)
            return reply
        self._running_tasks[tid] = {"thread": threading.get_ident()}
        ctx = getattr(task, "tracing", None)
        try:
            with _tracing.span(
                    f"task::{task.actor_method_name or task.name or 'task'}",
                    parent_context=ctx,
                    attributes={"task_id": task.task_id.hex()[:16],
                                "worker_id": self.worker_id.hex()[:8]}):
                if task.is_actor_task():
                    reply = self._execute_actor_task(task)
                else:
                    reply = self._execute_fn_task(task)
        finally:
            self._running_tasks.pop(tid, None)
            self._release_arg_copies(task)
        self._record_task_event(task, start, time.time(), reply)
        return reply

    def _record_task_event(self, task: TaskSpec, start: float, end: float,
                           reply: dict):
        """Buffer + batch-flush task events to the GCS task store
        (reference: core_worker/task_event_buffer.cc → gcs_task_manager)."""
        if not self._task_events_enabled:
            return
        failed = any("error" in p for p in reply.get("results", {}).values())
        event = {
            "task_id": task.task_id.hex(),
            "name": (task.actor_method_name if task.is_actor_task()
                     else task.name) or "task",
            "job_id": task.job_id.hex() if task.job_id else "",
            "worker_id": self.worker_id.hex(),
            "node_id": self.node_id.hex(),
            "state": "FAILED" if failed else "FINISHED",
            "start_ts": start,
            "end_ts": end,
            "actor_task": task.is_actor_task(),
        }
        # append only — the flusher thread owns the (blocking) GCS RPC, so
        # the task critical path never waits on observability
        with self._task_events_lock:
            self._task_events.append(event)

    def _flush_task_events(self):
        with self._task_events_lock:
            events, self._task_events = self._task_events, []
        if not events:
            return
        try:
            self.gcs.call("add_task_events", events=events)
        except Exception:  # noqa: BLE001 — observability is best-effort
            pass

    # Deserialized-function cache, keyed by the cloudpickle bytes (the
    # reference keeps a per-job function table the same way,
    # function_manager.py). A fan-out of N tasks over one function pays
    # ONE cloudpickle.loads instead of N — the single hottest line of the
    # normal-task execute path once dispatch went native. Bounded FIFO;
    # GIL-atomic dict ops, a racing double-load is benign.
    _FN_CACHE_CAP = 256

    def _load_task_fn(self, blob: bytes):
        fn = self._fn_cache.get(blob)
        if fn is None:
            fn = cloudpickle.loads(blob)
            if len(self._fn_cache) >= self._FN_CACHE_CAP:
                try:
                    self._fn_cache.pop(next(iter(self._fn_cache)))
                except (KeyError, StopIteration):
                    pass
            self._fn_cache[blob] = fn
        return fn

    def _execute_fn_task(self, task: TaskSpec) -> dict:
        self._ctx.task_id = task.task_id
        try:
            fn = self._load_task_fn(task.serialized_func)
            args, kwargs = self._resolve_args(task.args)
            result = fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - user task error
            return self._error_reply(task, e)
        finally:
            self._ctx.task_id = None
        return self._result_reply(task, result)

    _REPLY_CACHE_CAP = 2048  # per caller; bounds memory on long-lived actors

    def _actor_async_loop(self) -> asyncio.AbstractEventLoop:
        """Lazily-started event loop thread for async actor methods."""
        with self._actor_lock:
            loop = getattr(self, "_async_loop", None)
            if loop is None or loop.is_closed():
                loop = asyncio.new_event_loop()
                t = threading.Thread(
                    target=loop.run_forever, name="rt-actor-async", daemon=True)
                t.start()
                self._async_loop = loop
            return loop

    def _seq_begin(self, caller: bytes, seq: int, ordered: bool,
                   method: str = "?"):
        """Dedup/replay gate shared by the sync and async actor paths.
        Returns a cached reply for duplicates, else None (proceed)."""
        with self._actor_seq_cv:
            st = self._actor_seq_state.setdefault(
                caller, {"next": 1, "replies": {}})
            logger.debug("SEQB caller=%s seq=%d m=%s cached=%s",
                         caller[:4].hex(), seq, method,
                         seq in st["replies"])
            if seq in st["replies"]:
                return st["replies"][seq]  # duplicate: replay
            if seq < st["next"]:
                # executed long ago and pruned: the reply must have been
                # delivered (resends only happen for unacked calls)
                return {"results": {}}
            while ordered and seq > st["next"]:
                self._actor_seq_cv.wait(timeout=60.0)
        return None

    def _seq_finish(self, caller: bytes, seq: int, reply: dict) -> None:
        flush = []
        with self._actor_seq_cv:
            st = self._actor_seq_state.setdefault(
                caller, {"next": 1, "replies": {}})
            st["replies"][seq] = reply
            if seq == st["next"]:
                st["next"] += 1
                while st["next"] in st["replies"]:  # out-of-order completions
                    st["next"] += 1
            if len(st["replies"]) > self._REPLY_CACHE_CAP:
                for s in sorted(st["replies"])[: self._REPLY_CACHE_CAP // 2]:
                    del st["replies"][s]
            self._actor_seq_cv.notify_all()
            buf = self._fast_gap_buf.get(caller)
            if buf:
                for s in sorted(buf):
                    if s <= st["next"] or s in st["replies"]:
                        flush.append(buf.pop(s))
                if not buf:
                    del self._fast_gap_buf[caller]
        for conn_id, req_id, task in flush:
            # now immediately runnable (or a duplicate): executes without
            # blocking an executor thread on the ordering gate
            self._executor.submit(self._fast_run_and_reply,
                                  conn_id, req_id, task)

    def _execute_actor_task(self, task: TaskSpec) -> dict:
        # In-order execution per caller (unless concurrency > 1).  Completed
        # replies are cached per (caller, seq) so a duplicate resend — the
        # connection died before the reply was delivered — replays the
        # original reply instead of leaving the caller's refs unresolved.
        #
        # SYNC methods of an async actor serialize on a width-1 semaphore:
        # high max_concurrency is an event-loop concept and must not turn
        # plain methods into data races (reference: asyncio actors run sync
        # methods serialized on the loop).
        concurrency = self._actor_concurrency or threading.Semaphore(1)
        ordered = self._actor_max_concurrency <= 1
        caller = (task.caller_worker_id.binary()
                  if task.caller_worker_id is not None else b"?")
        seq = task.sequence_number
        cached = self._seq_begin(caller, seq, ordered,
                                 method=task.actor_method_name)
        if cached is not None:
            return cached
        concurrency.acquire()
        reply: dict
        try:
            self._ctx.task_id = task.task_id
            with self._actor_lock:
                inst = self._actor_instance
            if inst is None:
                reply = self._error_reply(task, RtError("actor instance not initialized"))
            else:
                try:
                    method = getattr(inst, task.actor_method_name)
                    args, kwargs = self._resolve_args(task.args)
                    if self._actor_has_async:
                        # Async-actor semantics (reference: asyncio actors):
                        # sync methods run ON the event loop, serialized
                        # against async method steps — never in parallel
                        # with them on a pool thread.
                        async def run_with_ctx():
                            self._ctx.task_id = task.task_id
                            r = method(*args, **kwargs)
                            if inspect.iscoroutine(r):
                                r = await r
                            return r
                        result = asyncio.run_coroutine_threadsafe(
                            run_with_ctx(), self._actor_async_loop()).result()
                    else:
                        result = method(*args, **kwargs)
                    reply = self._result_reply(
                        task, result,
                        tensor_transport=getattr(
                            method, "__rt_method_opts__",
                            {}).get("tensor_transport"))
                except Exception as e:  # noqa: BLE001 - user method error
                    reply = self._error_reply(task, e)
            return reply
        finally:
            concurrency.release()
            self._ctx.task_id = None
            self._seq_finish(caller, seq, reply)

    def _resolve_args(self, task_args: List[TaskArg]):
        args: List[Any] = []
        kwargs: Dict[str, Any] = {}
        for arg in task_args:
            if arg.is_inline:
                value = self.deserialize(arg.value)
            else:
                value = self._get_dependency(arg)
            if isinstance(value, _KwArgsMarker):
                kwargs = value.kwargs
            elif isinstance(value, _FastArgs):
                args.extend(value.args)
                kwargs.update(value.kwargs)
            else:
                args.append(value)
        return args, kwargs

    def _release_arg_copies(self, task: TaskSpec) -> None:
        """Executee side, post-execution: drop the same-node shm views this
        process fetched for the task's by-ref args. The store pin must not
        outlive the call — the owner's later delete cannot reclaim a span
        some worker still pins, and accumulated dead pins eventually eat
        the whole arena (each re-get is just a map + pin, no copy, so
        dropping the cache costs ~µs on a repeat arg). Arrays the user
        kept alive keep their own per-alias pins; heap copies (fetched
        from REMOTE nodes over RPC) stay cached — re-fetching those is a
        network copy, not a map."""
        for arg in task.args:
            if arg.is_inline or arg.object_id is None:
                continue
            owner_addr = getattr(arg, "owner_address", None)
            if owner_addr is not None and \
                    tuple(owner_addr) == self.server.address:
                continue  # we own it: canonical entry, not a fetched copy
            if self.memory_store.peek_shm_backed(arg.object_id):
                self.memory_store.free([arg.object_id])

    def _get_dependency(self, arg: TaskArg) -> Any:
        oid = arg.object_id
        last_err = None
        # A lost dependency is retried: the owner's lineage reconstruction
        # may be a DEEP chain (the producing task's own args were freed
        # and are re-executing recursively), and each fetch window only
        # covers one level.  Bounded — a truly unrecoverable object still
        # surfaces, just not on the first window.
        for attempt in range(4):
            entry = self.memory_store.get_if_ready(oid)
            if entry is None:
                owner_address = getattr(arg, "owner_address", None)
                ref = ObjectRef(oid, arg.owner, owner_address)
                self._ensure_local(ref, None)
                entry = self.memory_store.get_blocking(oid, 120.0)
            if entry.error is not None:
                err = self.deserialize(entry.error)
                if isinstance(err, ObjectLostError) and attempt < 3:
                    last_err = err
                    self.memory_store.free([oid])
                    self.memory_store.mark_pending(oid)
                    time.sleep(2.0 * (attempt + 1))
                    continue
                raise err
            if entry.value is not None:
                return self._maybe_device_resolve(
                    self.deserialize(entry.value))
            if entry.location is not None:
                ref = ObjectRef(oid, arg.owner,
                                getattr(arg, "owner_address", None))
                try:
                    blob = self._fetch_from_location(ref, entry.location,
                                                     120.0)
                except ObjectLostError as err:
                    if attempt < 3:
                        last_err = err
                        self.memory_store.free([oid])
                        self.memory_store.mark_pending(oid)
                        time.sleep(2.0 * (attempt + 1))
                        continue
                    raise
                return self._maybe_device_resolve(self.deserialize(blob))
            break
        raise last_err or ObjectLostError(oid, "dependency unavailable")

    # ------------------------------------------------- streaming generators
    def _as_sync_iter(self, result):
        """Uniform sync iteration over sync/async generators. Async gens are
        stepped on the actor's event loop (they may await actor state)."""
        if hasattr(result, "__anext__"):
            loop = self._actor_async_loop()

            def gen():
                while True:
                    try:
                        yield asyncio.run_coroutine_threadsafe(
                            result.__anext__(), loop).result()
                    except StopAsyncIteration:
                        return

            return gen()
        return iter(result)

    def _stream_results(self, task: TaskSpec, result) -> dict:
        """Executor side of ``num_returns="streaming"``: iterate the user
        generator, reporting each item to the owner as it is produced
        (reference contract: core_worker.proto:430 ReportGeneratorItemReturns).

        Reports are sequential sync RPCs from this executor thread; the
        owner delays its reply while too many items sit unconsumed, which
        backpressures this loop — and therefore the user generator —
        with no extra protocol."""
        client = RpcClient(tuple(task.caller_address))
        index = 0
        try:
            try:
                for item in self._as_sync_iter(result):
                    # same storage path as ordinary task returns (small
                    # inline; large into the arena / node spill dir — a
                    # lazily consumed stream outlives this worker's idle
                    # TTL routinely)
                    payload = self._pack_result(
                        ObjectID.from_index(task.task_id, index + 1), item)
                    reply = client.call(
                        "report_generator_item", timeout=None,
                        task_id=task.task_id.binary(), index=index,
                        done=False, **payload)
                    if reply.get("cancel"):
                        logger.debug("stream %s cancelled by owner",
                                     task.task_id.hex()[:8])
                        break
                    index += 1
            except Exception as e:  # noqa: BLE001 — user generator raised
                err = (e if isinstance(e, RtError)
                       else TaskError(task.task_id, e, traceback.format_exc()))
                eblob = pickle.dumps(err)
                try:
                    client.call("report_generator_item", timeout=None,
                                task_id=task.task_id.binary(), index=index,
                                done=True, error=eblob, total=index)
                except Exception:  # noqa: BLE001 — reply is the backup path
                    pass
                return {"results": {}, "streamed": index,
                        "stream_error": eblob}
            try:
                client.call("report_generator_item", timeout=None,
                            task_id=task.task_id.binary(), index=index,
                            done=True, total=index)
            except Exception:  # noqa: BLE001 — reply is the backup path
                pass
        finally:
            client.close()
        return {"results": {}, "streamed": index}

    async def h_report_generator_item(self, task_id: bytes, index: int = 0,
                                      done: bool = False, total=None,
                                      value=None, error=None, location=None):
        """Owner side: store one streamed item (or finish/fail the stream)
        and apply consumer backpressure by delaying the reply."""
        tid = TaskID(task_id)
        if task_id in self._cancelled_tasks:
            return {"cancel": True}  # cancelled stream: stop producing
        st = self._generators.get(tid)
        if st is None:
            # Stream consumed+dropped, but a lineage reconstruct may be
            # replaying to heal lost items the user still references: let
            # the replay run (storing what it re-reports into pending
            # entries) until every heal target is filled, then cancel.
            heal = self._stream_heal.get(tid)
            if heal is None:
                return {"cancel": True}  # generator dropped: stop producing
            if done:
                self._stream_heal.pop(tid, None)
                return {"ok": True}
            oid = ObjectID.from_index(tid, index + 1)
            if self.memory_store.is_pending(oid):
                self.memory_store.put(
                    oid, value=value, error=error,
                    location=tuple(location) if location else None)
            heal.discard(oid)
            if not heal:
                self._stream_heal.pop(tid, None)
                return {"cancel": True}  # all healed: stop the replay
            return {"ok": True}
        if done:
            if error is not None:
                st.fail(error)
            else:
                st.finish(total)
            return {"ok": True}
        oid = ObjectID.from_index(tid, index + 1)
        ref = ObjectRef(oid, self.worker_id, self.server.address)
        first = st.add(index, ref)
        entry = self.memory_store.get_if_ready(oid)
        stale = (entry is not None and entry.location is not None
                 and location is not None
                 and tuple(location) != tuple(entry.location))
        if stale:
            # replayed item after worker death: the new report's location is
            # the live copy; the stored one points at a dead process
            self.memory_store.free([oid])
        if first or stale or entry is None:
            self.memory_store.put(
                oid, value=value, error=error,
                location=tuple(location) if location else None)
        if location is not None and GLOBAL_CONFIG.get("lineage_pinning_enabled") \
                and st.spec is not None:
            # remotely-held items are recoverable by re-running the
            # generator task (dedup makes the replay converge on this index)
            with self._lineage_lock:
                self.lineage[oid] = st.spec
        limit = GLOBAL_CONFIG.get("streaming_generator_backpressure")
        while limit > 0:
            if self._generators.get(tid) is not st:
                return {"cancel": True}  # dropped while we were parked
            if st.done_or_failed():
                break
            with st.lock:
                if (index + 1) - st.consumed <= limit:
                    break
                loop = asyncio.get_running_loop()
                fut = loop.create_future()
                st.space_waiters.append((loop, fut))
            try:
                await asyncio.wait_for(fut, timeout=1.0)
            except asyncio.TimeoutError:
                pass  # re-check cancellation/termination each second
        return {"ok": True}

    def generator_task_failed(self, task_id: TaskID, error_blob: bytes):
        """Terminal submit-side failure (retries exhausted, actor dead):
        fail the stream so consumers unblock."""
        st = self._generators.get(task_id)
        if st is not None:
            st.fail(error_blob)

    def _result_reply(self, task: TaskSpec, result: Any,
                      tensor_transport: Optional[str] = None) -> dict:
        if task.streaming:
            if result is None or not (hasattr(result, "__iter__")
                                      or hasattr(result, "__anext__")):
                return self._error_reply(task, TypeError(
                    "num_returns='streaming' requires the task to return a "
                    f"generator or iterable, got {type(result).__name__}"))
            return self._stream_results(task, result)
        values = (
            [result] if task.num_returns == 1
            else (list(result) if task.num_returns > 1 else [])
        )
        if task.num_returns > 1 and len(values) != task.num_returns:
            return self._error_reply(task, ValueError(
                f"task declared num_returns={task.num_returns} but returned "
                f"{len(values)} values"))
        if tensor_transport is not None and tensor_transport != "device":
            return self._error_reply(task, ValueError(
                f"unknown tensor_transport {tensor_transport!r}; "
                "expected 'device'"))
        results = {}
        stored_device: List[ObjectID] = []
        stored_host: List[ObjectID] = []
        for oid, value in zip(task.return_ids(), values):
            if tensor_transport == "device":
                # keep the tensors on THIS process's device; ship a marker.
                # The caller frees via drop_copy to our address (the
                # location), which also clears the device store.
                try:
                    self._put_device(oid, value)
                except TypeError as e:
                    # the whole task errors: free returns already staged
                    # or their memory leaks with no caller ref to GC them
                    for done in stored_device:
                        self.device_store.free(done.binary())
                        self.memory_store.free([done])
                    return self._error_reply(task, e)
                stored_device.append(oid)
                results[oid.binary()] = {"location": self.server.address}
                continue
            try:
                results[oid.binary()] = self._pack_result(oid, value)
                stored_host.append(oid)
            except SpillFailedError as e:
                # node-durability could not be established (spill disk
                # full/unwritable): the task fails TYPED instead of the
                # old silent `except OSError: pass` that dropped the
                # survive-this-process guarantee on the floor.  Free the
                # returns already staged (memory store + arena) — the
                # caller only ever sees the error, so nothing would GC
                # them (mirrors the device-path cleanup above).  The
                # FAILING oid is included: _pack_result stores into the
                # memory store before the spill attempt that raised.
                for done in stored_host + [oid]:
                    self.memory_store.free([done])
                    if self._shm not in (False, None):
                        self._shm.delete(done.binary())
                        self._shm.drop_spilled(done.binary())
                return self._error_reply(task, e)
        return {"results": results}

    def _pack_result(self, oid: ObjectID, value: Any) -> dict:
        """Store one task output; returns its reply payload. Small frames
        ship inline in the reply. Large buffer-bearing values serialize
        DIRECTLY into the shm arena (one memcpy, zero heap, node-durable
        — same path as ray.put and OOB args, so GB-scale data blocks ride
        it too); large buffer-less values keep the heap + put_or_spill
        fallback (the primary copy must outlive THIS worker: idle reap
        between produce and fetch is routine in long pipelines)."""
        _ser = _serialization
        threshold = GLOBAL_CONFIG.get("max_direct_call_object_size")
        meta, buffers, views, segs, total = _ser.plan(value)
        try:
            if buffers and total > threshold:
                view = self._shm_write_framed(oid, meta, views, segs, total)
                if view is not None:
                    self.memory_store.put(oid, value=view)
                    return {"location": self.server.address, "size": total,
                            "node_id": self.node_id.hex()}
            if buffers:
                out = bytearray(total)
                _ser.pack_into(out, meta, views, segs)
                blob = bytes(out)
            else:
                blob = meta
        finally:
            _ser.release_buffers(buffers)
        if len(blob) <= threshold:
            return {"value": blob}
        self.memory_store.put(oid, value=blob)
        durable = False
        if self.shm is not None:
            # SpillFailedError deliberately NOT caught here: a refused
            # spill write means node durability failed — it surfaces as
            # a typed task error (see _result_reply), never a silent
            # loss of the survive-this-process guarantee
            try:
                self.shm.put_or_spill(oid.binary(), blob)
                durable = True
            except OSError:  # pure-LRU store (no spill dir configured)
                pass
        if durable:
            self._report_location("add", oid.binary(), size=len(blob))
            return {"location": self.server.address, "size": len(blob),
                    "node_id": self.node_id.hex()}
        return {"location": self.server.address}

    def _error_reply(self, task: TaskSpec, exc: Exception) -> dict:
        tb = traceback.format_exc()
        err = TaskError(task.task_id, exc, tb) if not isinstance(exc, RtError) else exc
        blob = pickle.dumps(err)
        reply = {"results": {oid.binary(): {"error": blob} for oid in task.return_ids()}}
        if task.streaming:
            # streaming tasks have no return ids; the error reaches readers
            # through the stream itself
            reply["stream_error"] = blob
        return reply

    # ---------------------------------------------------------------- misc
    def cluster_resources(self) -> dict:
        return self.gcs.cluster_resources()

    def shutdown(self):
        CoreWorker._current = None
        install_release_sink(None)
        install_borrow_sinks(None, None)
        # drop pinned arena views, then unmap and free the handle slot:
        # the per-process handle table is fixed-size, and a process that
        # init/shutdown-cycles the runtime (test suites) must not leak a
        # slot per session
        if self._shm not in (False, None):
            store, self._shm = self._shm, None
            try:
                self.memory_store.drop_shm_views()
                store.close()
            except Exception:  # noqa: BLE001 — shutdown is best-effort
                pass
        self.memory_store.set_shm_router(None)
        self._task_events_stop.set()
        try:
            self._flush_task_events()
        except Exception:  # noqa: BLE001
            pass
        try:
            self.gcs.close()
        except Exception:  # noqa: BLE001
            pass
        if self._fast_server is not None:
            try:
                self._fast_server.stop()
            except Exception:  # noqa: BLE001
                pass
            self._fast_server = None
        with self._actor_sub_lock:
            subs = list(self._actor_submitters.values())
        for sub in subs:
            # under the lock: a caller thread mid-cli.call() must finish
            # its write before the fd is closed out from under it
            with sub._fast_lock:
                cli, sub._fast = getattr(sub, "_fast", None), None
            if cli is not None:
                try:
                    cli.close()
                except Exception:  # noqa: BLE001
                    pass
        for c in list(getattr(self.submitter, "_raylet_clients",
                              {}).values()):
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
        self.server.stop()
        self._executor.shutdown(wait=False)


class _KwArgsMarker:
    def __init__(self, kwargs: dict):
        self.kwargs = kwargs


class _RemoteError:
    def __init__(self, blob: bytes):
        self.blob = blob
