"""Task submitters: lease-pooled normal tasks + sequenced actor calls.

Mirrors the reference's transport layer (core_worker/transport/
normal_task_submitter.cc — lease request/reuse keyed by task shape;
actor_task_submitter.cc — per-actor ordered queues with restart handling).

All submitter state lives on the shared IO loop; public entry points are
thread-safe wrappers.
"""

from __future__ import annotations

import asyncio
import logging
import pickle
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.common import faults
from ray_tpu_torch.common.config import GLOBAL_CONFIG
from ray_tpu_torch.common.ids import ActorID, ObjectID
from ray_tpu_torch.common.retry import Deadline, RetryPolicy
from ray_tpu_torch.common.status import (
    ActorDiedError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.common.task_spec import PlacementGroupStrategy, TaskSpec
from ray_tpu_torch.rpc.rpc import (IoContext, RetryableRpcClient, RpcClient,
                                   RpcError)

logger = logging.getLogger(__name__)

# seconds between an actor handle's warnings while its actor stays pending
PENDING_WARN_S = 60.0


class _JobFinishedByRaylet(WorkerCrashedError):
    """The raylet rejected a queued lease because this job was finished
    (the GCS declared the driver dead). Terminal for the affected tasks."""


class _FastLeaseChannel:
    """Native dispatch channel to ONE leased worker (rpc/native/fastloop.c
    client): eligible normal tasks skip the per-push asyncio RPC stack on
    both ends — the lease holder writes the frame from the IO loop, the
    worker's C poll loop hands it straight to the executor pool, and the
    reply completes on the C reader thread.

    Owned by a single ``_run_on_lease`` coroutine (the lease's window of
    in-flight pushes); replies are stored entirely on the C reader
    thread — the loop-side future per push only sequences the window and
    carries channel failures into the retry path."""

    def __init__(self, submitter, loop, worker_addr):
        self._sub = submitter
        self._cw = submitter._cw
        self._loop = loop
        self._addr = tuple(worker_addr)
        self._cli = None
        self._ids = 0
        self._lock = threading.Lock()
        self._inflight: Dict[int, tuple] = {}  # req_id -> (fut, spec)
        self.down = False

    def connect(self, fast_port: int) -> bool:
        """Blocking (call off-loop). False = no channel; Python path."""
        from ray_tpu_torch.rpc.native import load_fastloop

        fl = load_fastloop()
        if fl is None:
            return False
        import socket as _socket

        try:
            host = _socket.gethostbyname(self._addr[0])
            self._cli = fl.Client(
                host, int(fast_port), self._on_reply,
                timeout=GLOBAL_CONFIG.get("rpc_connect_timeout_s"))
        except Exception:  # noqa: BLE001 — asyncio path still works
            logger.debug("fast task channel to %s:%s failed",
                         self._addr[0], fast_port, exc_info=True)
            return False
        return True

    def inflight(self) -> int:
        return len(self._inflight)

    def push(self, spec: TaskSpec, payload: bytes) -> "asyncio.Future":
        """Write one frame; returns a loop future resolved once the reply
        has been stored (or failed with RpcError on channel death)."""
        fut = self._loop.create_future()
        self._push(fut, spec, payload)
        return fut

    def _push(self, fut, spec: TaskSpec, payload: bytes) -> None:
        with self._lock:
            if self.down or self._cli is None:
                raise RpcError("fast task channel closed")
            self._ids += 1
            req_id = self._ids
            self._inflight[req_id] = (fut, spec)
            try:
                self._cli.call(req_id, payload)
            except Exception as e:  # noqa: BLE001 — possibly MID-frame:
                # the byte stream can't be trusted; the channel goes down
                self._inflight.pop(req_id, None)
                self.down = True
                raise RpcError(f"fast task channel write failed: {e}") from e

    def _on_reply(self, req_id: int, payload) -> None:
        """Runs on the C reader thread."""
        if req_id == 0 and payload is None:
            self._fail_pending(RpcError("fast task channel lost"))
            return
        with self._lock:
            entry = self._inflight.pop(req_id, None)
        if entry is None:
            return
        fut, spec = entry
        exc: Optional[Exception] = None
        try:
            reply = pickle.loads(payload)
            self._cw.store_task_reply(spec, reply, self._addr)
        except Exception as e:  # noqa: BLE001 — surface to the retry path
            exc = RpcError(f"fast task reply failed: {e}")
        self._resolve(fut, exc)

    def _fail_pending(self, exc: Exception) -> None:
        with self._lock:
            self.down = True
            pending = list(self._inflight.values())
            self._inflight.clear()
        for fut, _spec in pending:
            self._resolve(fut, exc)

    def _resolve(self, fut, exc: Optional[Exception]) -> None:
        def done():
            if fut.done():
                return
            if exc is None:
                fut.set_result(None)
            else:
                fut.set_exception(exc)

        try:
            self._loop.call_soon_threadsafe(done)
        except RuntimeError:  # loop closed (shutdown)
            pass

    def close(self) -> None:
        self._fail_pending(RpcError("fast task channel closed"))
        cli, self._cli = self._cli, None
        if cli is not None:
            try:
                cli.close()
            except Exception:  # noqa: BLE001
                pass


class NormalTaskSubmitter:
    """Per-shape lease pools; pushes tasks directly to leased workers.

    Eligible small-arg tasks ride the native dispatch channel
    (:class:`_FastLeaseChannel`) once per lease; everything else — and
    every failure mode (worker death mid-dispatch, lease revocation,
    channel loss) — takes the ordinary asyncio push/retry path with no
    semantic change."""

    # frames bigger than this stay on the asyncio path: the loop-thread
    # write must never block on a full socket buffer
    _FAST_MAX_BYTES = 256 * 1024

    def __init__(self, core_worker):
        self._cw = core_worker
        self._io = IoContext.current()
        self._queues: Dict[tuple, List[TaskSpec]] = {}
        self._leases_in_flight: Dict[tuple, int] = {}
        self._lease_counter = 0
        self._pending: List[TaskSpec] = []
        self._pending_lock = threading.Lock()
        self._wakeup_scheduled = False
        # set when work arrives for a shape: an idle lease holder waits on
        # it briefly instead of returning the worker (lease retention)
        self._work_events: Dict[tuple, asyncio.Event] = {}
        # cancellation state (owner side): task_id -> executor address for
        # pushed-and-unfinished tasks; cancelled ids suppress push retries
        from ray_tpu_torch.common.containers import BoundedSet

        self._pushed: Dict[bytes, Tuple[str, int]] = {}
        self._cancelled = BoundedSet()
        # dispatch-path observability: which channel tasks actually rode
        # (the native-coverage map in PERF_PLAN.md is verified from these)
        from ray_tpu_torch.util import metrics as _metrics

        self._m_fast = _metrics.Counter(
            "rt_tasks_dispatched_fast",
            "normal tasks pushed over the native dispatch channel")
        self._m_slow = _metrics.Counter(
            "rt_tasks_dispatched_rpc",
            "normal tasks pushed over the asyncio RPC path")
        # per-address raylet clients: a lease request and its eventual
        # return used to open (connect + HELLO) a fresh connection EACH —
        # two TCP setups per lease cycle at churn rates (loop-only access)
        self._raylet_clients: Dict[tuple, RetryableRpcClient] = {}

    def submit(self, spec: TaskSpec):
        # Batched wakeup: a burst of submits from caller threads schedules
        # ONE loop callback that drains them all, instead of one
        # call_soon_threadsafe (pipe write + loop iteration) per task —
        # the n:n fan-out paths are wakeup-bound otherwise.
        with self._pending_lock:
            self._pending.append(spec)
            if self._wakeup_scheduled:
                return
            self._wakeup_scheduled = True
        self._io.loop.call_soon_threadsafe(self._drain_pending)

    def fail_queued(self, exc: Exception) -> None:
        """Control-plane death (multi-process shape): every spec still
        waiting for a lease can never run — fail them with the typed
        error so pending ``get()``s unblock instead of hanging.  Specs
        already pushed to live workers are untouched."""

        def drain():
            with self._pending_lock:
                specs, self._pending = self._pending, []
                self._wakeup_scheduled = False
            for spec in specs:
                self._store_error(spec, exc)
            for key in list(self._queues):
                for spec in self._queues.pop(key, []):
                    self._store_error(spec, exc)

        self._io.loop.call_soon_threadsafe(drain)

    def _drain_pending(self):
        with self._pending_lock:
            specs, self._pending = self._pending, []
            self._wakeup_scheduled = False
        for spec in specs:
            if self._gate_on_dependencies(spec):
                continue
            self._enqueue(spec)

    def _gate_on_dependencies(self, spec: TaskSpec) -> bool:
        """Reference contract (raylet dependency manager / lease_policy:
        a task is not DISPATCHED until its args are available): by-ref
        args we own must be READY before the task becomes lease-eligible.

        Without this, consumers grab every CPU lease and then block
        INSIDE execution waiting for producer outputs, while the
        producers starve in the lease queue — a hard scheduling deadlock
        at data-pipeline scale (round-5 GB-shuffle finding).  Returns
        True when the spec was parked; it re-enters via the owner store's
        done callback the moment the last missing arg is ready."""
        missing = []
        for arg in spec.args:
            if arg.is_inline or arg.object_id is None:
                continue
            owner_addr = getattr(arg, "owner_address", None)
            if owner_addr is not None and \
                    tuple(owner_addr) != self._cw.server.address:
                continue  # remote owner: resolved at execution (borrow)
            entry = self._cw.memory_store.get_if_ready(arg.object_id)
            if entry is None:
                # error entries count as READY: dispatch and let execution
                # surface the dependency failure the normal way
                missing.append(arg.object_id)
        if not missing:
            return False
        remaining = {"n": len(missing)}
        lock = threading.Lock()

        def on_ready():
            with lock:
                remaining["n"] -= 1
                if remaining["n"] > 0:
                    return
            self._io.loop.call_soon_threadsafe(self._enqueue, spec)

        for oid in missing:
            self._cw.memory_store.add_done_callback(oid, on_ready)
        return True

    def _enqueue(self, spec: TaskSpec):
        key = spec.shape_key()
        self._queues.setdefault(key, []).append(spec)
        ev = self._work_events.get(key)
        if ev is not None:
            ev.set()  # wake an idle lease holder before starting a new one
        in_flight = self._leases_in_flight.get(key, 0)
        max_leases = GLOBAL_CONFIG.get("lease_request_batch_size")
        if in_flight < min(len(self._queues[key]), max_leases):
            self._leases_in_flight[key] = in_flight + 1
            self._io.spawn(self._lease_and_run(key, spec))

    async def _lease_and_run(self, key: tuple, sample: TaskSpec):
        """Obtain one lease, drain queue tasks through it, return the lease."""
        from ray_tpu_torch.runtime_env.runtime_env import RuntimeEnvError

        try:
            while self._queues.get(key):
                try:
                    grant = await self._request_lease(sample)
                except _JobFinishedByRaylet as jf_err:
                    for spec in self._queues.pop(key, []):
                        self._store_error(spec, jf_err)
                    return
                except RuntimeEnvError as env_err:
                    # Env setup failure fails the queued tasks terminally,
                    # matching the reference's RuntimeEnvSetupError semantics
                    # (setup runs on the scheduled node; its failure is the
                    # task's failure — even when another node might have the
                    # local path). Transient RPC errors deliberately
                    # propagate instead: they leave tasks queued for a later
                    # lease attempt.
                    for spec in self._queues.pop(key, []):
                        self._store_error(spec, env_err)
                    return
                if grant is None:
                    # infeasible right now — fail queued tasks of this
                    # shape (typed as the control-plane death when that is
                    # the actual reason the lease could not be obtained)
                    err = getattr(self._cw, "_control_plane_error", None) \
                        or WorkerCrashedError(
                            "task is infeasible: no node can ever satisfy "
                            f"{sample.required_resources.resources.to_dict()}")
                    for spec in self._queues.pop(key, []):
                        self._store_error(spec, err)
                    return
                raylet_addr, lease_id, worker_addr, fast_port = grant
                try:
                    await self._run_on_lease(key, lease_id, worker_addr,
                                             fast_port)
                finally:
                    await self._return_worker(raylet_addr, lease_id)
        finally:
            self._leases_in_flight[key] = max(0, self._leases_in_flight.get(key, 1) - 1)

    async def _return_worker(self, raylet_addr, lease_id: bytes) -> bool:
        """Give a lease back, with bounded retries: a swallowed failure
        here leaks a LEASED worker until the raylet's liveness sweep
        reaps the caller, so a transient transport blip must not drop
        the return. False = the raylet is really gone (its own death
        handling reclaims the lease)."""
        policy = RetryPolicy(max_attempts=3, deadline=Deadline(5.0))
        attempt = 0
        while True:
            try:
                faults.fault_point("raylet.lease.return")
                await self._raylet_client(raylet_addr).call_async(
                    "return_worker", lease_id=lease_id, timeout=10.0)
                return True
            except Exception as e:  # noqa: BLE001 — typed below
                attempt += 1
                if not await policy.asleep(attempt):
                    logger.warning("return_worker to %s failed: %s",
                                   raylet_addr, e)
                    return False

    def _raylet_client(self, addr) -> RetryableRpcClient:
        """Cached per-address raylet client (loop-only). The cache is
        dropped on transport failure inside _request_lease so a restarted
        raylet at the same address gets a fresh connection."""
        addr = tuple(addr)
        c = self._raylet_clients.get(addr)
        if c is None:
            c = self._raylet_clients[addr] = RetryableRpcClient(
                addr, deadline_s=30.0)
        return c

    def _next_lease_id(self) -> bytes:
        self._lease_counter += 1
        return (self._lease_counter.to_bytes(8, "little")
                + self._cw.worker_id.binary())

    def _locality_hint(self, spec: TaskSpec) -> Optional[dict]:
        """``{node_id_hex: total argument bytes resident there}`` from
        the owner's location cache: the raylet's pick_node sends the
        task to the node already holding the most arg bytes — shipping
        the task is cheaper than shipping its args
        (scheduling/policies.py)."""
        cache = getattr(self._cw, "_object_locality", None)
        if not cache or not GLOBAL_CONFIG.get("locality_scheduling"):
            return None
        hint: dict = {}
        for arg in spec.args:
            if arg.is_inline or arg.object_id is None:
                continue
            ent = cache.get(arg.object_id.binary())
            if ent and ent.get("size"):
                nid = ent["node_id"]
                hint[nid] = hint.get(nid, 0) + int(ent["size"])
        return hint or None

    async def _request_lease(self, spec: TaskSpec):
        """Lease protocol with spillback: follow redirects up to a few hops."""
        pg = None
        if isinstance(spec.scheduling_strategy, PlacementGroupStrategy):
            pg = (spec.scheduling_strategy.placement_group_id.binary(),
                  spec.scheduling_strategy.bundle_index)
        locality = self._locality_hint(spec)
        lease_id = self._next_lease_id()
        raylet_addr = self._cw.raylet_address
        strategy = pickle.dumps(spec.scheduling_strategy)
        # Transport failures retry against the same raylet under one
        # bounded policy before the lease gives up (a retry consumes a
        # hop — acceptable: 8 hops, <= 3 retries).  Without this, one
        # connection blip failed the whole queued shape as infeasible.
        lease_policy = RetryPolicy(max_attempts=4, deadline=Deadline(30.0))
        attempt = 0
        for _hop in range(8):
            client = self._raylet_client(raylet_addr)
            try:
                faults.fault_point("raylet.lease.request")
                # No client-side timeout: a queued lease legitimately blocks
                # until resources free up; truly impossible demands come back
                # as an explicit "infeasible" status from the raylet.
                # Final hop pins the lease to whichever raylet it reached:
                # two raylets redirecting on mutually-stale views (e.g. a
                # locality hint pointing at a node that just filled) would
                # otherwise ping-pong the lease until the hop budget runs
                # out — which is a queue-here situation, not an infeasible
                # demand (truly impossible shapes are rejected by the
                # FIRST raylet's feasibility check, never reaching hop 8).
                reply = await client.call_async(
                    "request_worker_lease",
                    lease_id=lease_id,
                    resources=spec.required_resources.to_dict(),
                    strategy=strategy,
                    pg=pg,
                    grant_only_local=(_hop == 7),
                    runtime_env=spec.runtime_env,
                    locality=locality,
                    # the raylet reclaims this job's leases when the job
                    # finishes (driver exit/death must free its workers)
                    job_id=self._cw.job_id.binary(),
                    timeout=None,
                )
            except Exception as e:  # noqa: BLE001
                logger.warning("lease request to %s failed: %s", raylet_addr, e)
                # drop the cached client: the address may come back as a
                # different incarnation (raylet restart)
                stale = self._raylet_clients.pop(tuple(raylet_addr), None)
                if stale is not None:
                    stale.close()
                attempt += 1
                if await lease_policy.asleep(attempt):
                    continue
                return None
            status = reply.get("status")
            if status == "granted":
                logger.debug("lease granted: worker %s", reply["worker_address"])
                return (raylet_addr, lease_id, tuple(reply["worker_address"]),
                        reply.get("worker_fast_port"))
            if status == "spill":
                raylet_addr = tuple(reply["address"])
                continue
            if status == "env_error":
                from ray_tpu_torch.runtime_env.runtime_env import RuntimeEnvError

                raise RuntimeEnvError(reply.get("error", "runtime env failed"))
            if status == "infeasible":
                return None
            if status == "job_finished":
                # the raylet reclaimed this job's queued leases (driver
                # declared dead); do NOT re-request — fail terminally so a
                # false-positive death surfaces as an error, not a hang
                raise _JobFinishedByRaylet(
                    "lease rejected: this job was finished (driver "
                    "unreachable or exited)")
        return None

    async def _run_on_lease(self, key: tuple, lease_id: bytes, worker_addr,
                            fast_port=None):
        """Drain queued tasks through one leased worker. When the queue
        empties, the lease is RETAINED for a short grace window waiting for
        more same-shape work (reference: lease pooling / idle lease reuse)
        — a sequential sync caller otherwise pays a full lease round-trip
        per task.

        The lease resolves its native dispatch channel ONCE (connect to
        the worker's fastloop port, off-loop); every eligible task of the
        lease then bypasses the per-push asyncio RPC stack entirely.
        Channel loss — worker death mid-dispatch, lease revocation by the
        raylet — fails the in-flight push into the ordinary retry path,
        exactly as an asyncio push failure would."""
        client = RpcClient(worker_addr)
        fast: Optional[_FastLeaseChannel] = None
        if fast_port and GLOBAL_CONFIG.get("fastloop_enabled"):
            chan = _FastLeaseChannel(self, asyncio.get_running_loop(),
                                     worker_addr)
            if await asyncio.to_thread(chan.connect, fast_port):
                fast = chan
        grace_s = GLOBAL_CONFIG.get("lease_idle_grace_ms") / 1000.0
        window = max(1, GLOBAL_CONFIG.get("fast_dispatch_window")) \
            if fast is not None else 1
        pending: Dict["asyncio.Future", TaskSpec] = {}
        failed: List[tuple] = []

        async def reap(return_when):
            done, _ = await asyncio.wait(list(pending),
                                         return_when=return_when)
            for fut in done:
                spec = pending.pop(fut)
                self._pushed.pop(spec.task_id.binary(), None)
                exc = fut.exception()
                if exc is not None:
                    failed.append((spec, exc))

        try:
            while True:
                if failed:
                    # channel died (worker crash / lease revocation):
                    # reap the rest and route every failed spec through
                    # the ordinary retry path, then end the lease
                    if pending:
                        await reap(asyncio.ALL_COMPLETED)
                    await self._handle_push_failures(failed)
                    return
                queue = self._queues.get(key)
                if not queue:
                    if pending:
                        await reap(asyncio.FIRST_COMPLETED)
                        continue
                    if grace_s <= 0:
                        return  # retention disabled: give the worker back
                    ev = self._work_events.get(key)
                    if ev is None:
                        ev = self._work_events[key] = asyncio.Event()
                    ev.clear()
                    try:
                        await asyncio.wait_for(ev.wait(), grace_s)
                    except asyncio.TimeoutError:
                        return  # stayed idle: give the worker back
                    continue
                # Breadth first, depth second: a second task enters THIS
                # lease's window only when the queue is deeper than the
                # shape's lease pool could drain one-per-lease — small
                # fan-outs must spread across workers (pipelining four
                # long batchers onto one process serializes them), deep
                # backlogs overlap wire latency with execution.
                if pending and (
                        len(pending) >= window
                        or len(queue) <= self._leases_in_flight.get(key, 1)):
                    await reap(asyncio.FIRST_COMPLETED)
                    continue
                spec = queue.pop(0)
                tid = spec.task_id.binary()
                if tid in self._cancelled:
                    self._store_error(spec, TaskCancelledError(
                        "the task was cancelled before it started"))
                    continue
                logger.debug("pushing task %s to %s", spec.task_id.hex()[:8], worker_addr)
                payload = (self._encode_task(spec)
                           if fast is not None and not fast.down else None)
                if payload is not None:
                    self._pushed[tid] = tuple(worker_addr)
                    try:
                        faults.fault_point("worker.task.push")
                        # the reply is stored by the channel's reader
                        # thread; the future only sequences the window
                        pending[fast.push(spec, payload)] = spec
                    except Exception as e:  # noqa: BLE001 — channel died
                        self._pushed.pop(tid, None)
                        failed.append((spec, e))
                        continue
                    self._m_fast.inc()  # only frames that actually left
                    continue
                # ineligible task: drain the window first (the asyncio
                # push is strictly one-at-a-time on the lease)
                if pending:
                    queue.insert(0, spec)
                    await reap(asyncio.ALL_COMPLETED)
                    continue
                self._pushed[tid] = tuple(worker_addr)
                self._m_slow.inc()
                try:
                    faults.fault_point("worker.task.push")
                    reply = await client.call_async(
                        "push_task", spec=pickle.dumps(spec), timeout=None,
                    )
                except Exception as e:  # noqa: BLE001 - leased worker died
                    await self._handle_push_failure(spec, e)
                    return
                finally:
                    self._pushed.pop(tid, None)
                logger.debug("task %s replied", spec.task_id.hex()[:8])
                self._cw.store_task_reply(spec, reply, worker_addr)
        finally:
            client.close()
            if fast is not None:
                # graceful drain: an in-flight frame on a LIVE worker is
                # waited out (worker death flips `down` and routes the
                # remainder through the retry path). Bounded — a reply
                # swallowed by a worker-side bug must not wedge the lease
                # coroutine forever; past the bound, close() fails the
                # stragglers into the retry path.
                deadline = time.monotonic() + 300.0
                while fast.inflight() and not fast.down \
                        and time.monotonic() < deadline:
                    await asyncio.sleep(0.01)
                fast.close()

    def _encode_task(self, spec: TaskSpec) -> Optional[bytes]:
        """Native submit record for a channel-eligible task, or None to
        take the asyncio path. Eligible = plain inline args (by-ref args
        — including OOB-promoted ones — need the handoff protocol and
        executee-side fetches that must not ride the C thread), no
        runtime_env / streaming / tracing, and a small total frame."""
        if spec.streaming or spec.runtime_env is not None or \
                getattr(spec, "tracing", None) is not None:
            return None
        total = len(spec.serialized_func or b"")
        for arg in spec.args:
            if not arg.is_inline:
                return None
            total += len(arg.value)
        if total > self._FAST_MAX_BYTES:
            return None
        from ray_tpu_torch.rpc.native import load_fastspec

        fs = load_fastspec()
        payload = pickle.dumps([arg.value for arg in spec.args])
        if fs is not None:
            host, port = spec.caller_address
            try:
                return fs.pack_task(
                    spec.task_id.binary(), spec.job_id.binary(),
                    spec.caller_worker_id.binary(), host.encode(),
                    spec.function.qualname.encode(),
                    spec.serialized_func or b"", payload,
                    (spec.name or "").encode(),
                    spec.num_returns, port)
            except OverflowError:
                return None
        # no codec here: the executee accepts a pickled spec on the same
        # channel (frames not starting with RTFS unpickle)
        blob = pickle.dumps(spec)
        return blob if len(blob) <= self._FAST_MAX_BYTES else None

    def cancel(self, task_id_bin: bytes):
        """Owner side. Returns ("queued", None) if removed before running,
        ("running", executor_addr) if pushed, (None, None) if unknown
        (finished or never submitted here). Runs on the IO loop."""
        self._cancelled.add(task_id_bin)
        for q in self._queues.values():
            for spec in q:
                if spec.task_id.binary() == task_id_bin:
                    q.remove(spec)
                    self._store_error(spec, TaskCancelledError(
                        "the task was cancelled before it started"))
                    return ("queued", None)
        addr = self._pushed.get(task_id_bin)
        if addr is not None:
            return ("running", addr)
        return (None, None)

    async def _handle_push_failure(self, spec: TaskSpec, exc: Exception):
        await self._handle_push_failures([(spec, exc)])

    async def _handle_push_failures(self, items: List[tuple]):
        """Shared by the asyncio path (one spec) and the native dispatch
        window (every spec in flight when the channel died): cancelled
        specs resolve as cancelled, retryable ones re-enqueue after ONE
        backoff — giving the raylet time to reap the dead worker so the
        retries aren't granted the same dying worker again."""
        retry: List[TaskSpec] = []
        for spec, exc in items:
            if spec.task_id.binary() in self._cancelled:
                # force-cancel kills the executor mid-push: that is the
                # cancel completing, not a crash to retry
                self._store_error(spec, TaskCancelledError(
                    "the task was cancelled while running"))
            elif spec.max_retries > 0:
                spec.max_retries -= 1
                logger.info("retrying task %s after push failure: %s",
                            spec.task_id.hex()[:8], exc)
                retry.append(spec)
            else:
                self._store_error(spec, WorkerCrashedError(
                    f"worker died executing task "
                    f"{spec.name or spec.function.qualname}: {exc}"))
        if retry:
            # Full-jitter backoff growing with the retries this batch has
            # already burned (replaces a flat 0.3 s that woke every
            # retrier of a died-together window on the same tick); the
            # re-enqueued specs then ride the lease path's own budget.
            consumed = max(1, min(
                GLOBAL_CONFIG.get("max_task_retries") - s.max_retries
                for s in retry))
            delay = RetryPolicy(base_s=0.3, cap_s=2.0).next_delay(consumed)
            # 0.1 s floor: the raylet must get a liveness tick to reap the
            # dead worker or the retry is granted the same dying process
            await asyncio.sleep(0.1 + (delay or 0.0))
            for spec in retry:
                self._enqueue(spec)

    def _store_error(self, spec: TaskSpec, error: Exception):
        blob = pickle.dumps(error)
        for oid in spec.return_ids():
            self._cw.memory_store.put(oid, error=blob)
        if spec.streaming:
            self._cw.generator_task_failed(spec.task_id, blob)
        # Terminal failure still completes the task: release the handoff
        # guards on its by-ref args or their owners leak them forever.
        self._cw.ack_args_handoffs(spec)


class ActorTaskSubmitter:
    """One per (caller, actor): ordered submission with restart-aware resend."""

    def __init__(self, core_worker, actor_id: ActorID):
        self._cw = core_worker
        self.actor_id = actor_id
        self._io = IoContext.current()
        self._seq = 0
        self._queue: List[TaskSpec] = []
        self._inflight: Dict[int, TaskSpec] = {}
        self._client: Optional[RpcClient] = None
        self._address: Optional[Tuple[str, int]] = None
        self._state = "RESOLVING"  # RESOLVING | CONNECTED | DEAD
        self._death_error: Optional[Exception] = None
        self._pump_scheduled = False
        self._resolving = False
        self._seq_lock = threading.Lock()
        self._pending: List[TaskSpec] = []
        self._pending_lock = threading.Lock()
        self._wakeup_scheduled = False
        # set by pubsub actor-state events: resolution wakes immediately on
        # ALIVE instead of sleeping a fixed poll interval
        self._state_event = asyncio.Event()
        # the most recent pubsub actor view: the ALIVE event already
        # carries address + fast_port, so resolution consumes it directly
        # instead of re-polling get_actor after every wakeup (measured
        # ~3 get_actor RPCs per creation at churn rates without this)
        self._pushed_view: Optional[dict] = None
        from ray_tpu_torch.common.containers import BoundedSet

        # cancelled call ids: never resent after an actor restart, and
        # their failures surface as TaskCancelledError (not ActorDied)
        self._cancelled = BoundedSet()
        # fastloop channel (rpc/native/fastloop.c): eligible calls skip the
        # asyncio pump entirely — the caller thread writes the frame, the C
        # reader thread completes the reply.  All state below is guarded by
        # _fast_lock because submit/reply/teardown touch it from three
        # different threads.
        self._fast = None
        self._fast_lock = threading.Lock()
        self._fast_inflight: Dict[int, TaskSpec] = {}

    def next_seq(self) -> int:
        # Called from arbitrary caller threads (e.g. a server fanning out
        # concurrent calls): an unsynchronized += here mints DUPLICATE
        # sequence numbers, and the executee's dedup cache then replays the
        # first call's reply for the second — whose return refs are never
        # stored, hanging the caller forever.
        with self._seq_lock:
            self._seq += 1
            return self._seq

    def submit(self, spec: TaskSpec):
        if self._try_fast(spec):
            return
        # batched wakeup (see NormalTaskSubmitter.submit)
        with self._pending_lock:
            self._pending.append(spec)
            if self._wakeup_scheduled:
                return
            self._wakeup_scheduled = True
        self._io.loop.call_soon_threadsafe(self._drain_pending)

    # ------------------------------------------------------ fastloop path
    def _try_fast(self, spec: TaskSpec) -> bool:
        """Submit over the C channel when eligible.  Eligible = connected,
        channel up, and the spec carries a _fast_payload (inline plain-value
        args — by-ref args would block the executee's C thread on
        dependency fetches).  Returns False to take the asyncio path."""
        cli = self._fast
        if cli is None or self._state != "CONNECTED":
            return False
        if getattr(spec, "_fast_payload", None) is None or spec.streaming:
            return False
        payload = self._encode_spec(spec)
        with self._fast_lock:
            if self._fast is not cli:
                return False
            self._fast_inflight[spec.sequence_number] = spec
            try:
                cli.call(spec.sequence_number, payload)
            except Exception:  # noqa: BLE001 — write failed, possibly MID-
                # frame: the byte stream can no longer be trusted, so the
                # whole channel goes down (never reuse it for a next call)
                self._fast_inflight.pop(spec.sequence_number, None)
                self._io.loop.call_soon_threadsafe(self._fast_conn_down)
                return False
        return True

    def _setup_fast(self, fast_port) -> None:
        """(Re)wire the fast channel after address resolution.  Called on
        the IO loop: the old channel is torn down inline, but the connect
        itself (DNS + TCP, potentially seconds against a black-holed port)
        runs on a pool thread — it must never stall the shared loop.
        Calls submitted before the channel is up just take the asyncio
        path."""
        old = None
        with self._fast_lock:
            old, self._fast = self._fast, None
        if old is not None:
            try:
                old.close()
            except Exception:  # noqa: BLE001
                pass
        if not fast_port or not GLOBAL_CONFIG.get("fastloop_enabled"):
            return
        from ray_tpu_torch.rpc.native import load_fastloop

        fl = load_fastloop()
        if fl is None:
            return
        address = self._address  # pin: resolution may move it later

        def connect():
            import socket as _socket

            try:
                host = _socket.gethostbyname(address[0])
                cli = fl.Client(host, int(fast_port), self._on_fast_reply,
                                timeout=GLOBAL_CONFIG.get(
                                    "rpc_connect_timeout_s"))
            except Exception:  # noqa: BLE001 — asyncio path still works
                logger.debug("fastloop connect to %s:%s failed",
                             address[0], fast_port, exc_info=True)
                return
            stale = False
            with self._fast_lock:
                if self._state == "CONNECTED" and self._address == address \
                        and self._fast is None:
                    self._fast = cli
                else:
                    stale = True  # re-resolved (or died) while connecting
            if stale:
                try:
                    cli.close()
                except Exception:  # noqa: BLE001
                    pass

        threading.Thread(target=connect, name="rt-fastconnect",
                         daemon=True).start()

    def _on_fast_reply(self, req_id: int, payload) -> None:
        """Runs on the C reader thread."""
        if req_id == 0 and payload is None:
            # connection lost: requeue unacked fast calls through the
            # ordinary resolve/resend machinery (on the IO loop)
            self._io.loop.call_soon_threadsafe(self._fast_conn_down)
            return
        with self._fast_lock:
            spec = self._fast_inflight.pop(req_id, None)
        if spec is None:
            return  # raced with a teardown requeue: the resend owns it now
        try:
            reply = pickle.loads(payload)
            self._cw.store_task_reply(spec, reply, self._address)
        except Exception:  # noqa: BLE001 — never kill the reader thread
            logger.exception("fastloop reply for seq=%d failed", req_id)

    def _fast_conn_down(self) -> None:
        """IO loop: the fast channel died (worker crash, restart, or our
        own close).  Unacked fast calls rejoin the slow queue in sequence
        order; the executee's seq-dedup replays anything that actually
        completed, so the handover is exactly-once."""
        with self._fast_lock:
            cli, self._fast = self._fast, None
            pending = sorted(self._fast_inflight.values(),
                             key=lambda s: s.sequence_number)
            self._fast_inflight.clear()
        if cli is not None:
            try:
                cli.close()
            except Exception:  # noqa: BLE001
                pass
        if not pending and self._state != "CONNECTED":
            return
        if self._state == "DEAD":
            for spec in pending:
                self._fail_spec(spec, self._death_error
                                or ActorDiedError(self.actor_id))
            return
        self._queue = pending + self._queue
        self._io.spawn(self._on_connection_failure(
            RpcError("fastloop connection lost")))

    def _drain_pending(self):
        with self._pending_lock:
            specs, self._pending = self._pending, []
            self._wakeup_scheduled = False
        for spec in specs:
            self._enqueue(spec)

    def _enqueue(self, spec: TaskSpec):
        if self._state == "DEAD":
            self._fail_spec(spec, self._death_error or ActorDiedError(self.actor_id))
            return
        self._queue.append(spec)
        self._schedule_pump()

    def _schedule_pump(self):
        if not self._pump_scheduled:
            self._pump_scheduled = True
            self._io.spawn(self._pump())

    async def _pump(self):
        self._pump_scheduled = False
        if self._state == "RESOLVING":
            await self._resolve_address()
        if self._state != "CONNECTED":
            return
        while self._queue:
            spec = self._queue.pop(0)
            self._inflight[spec.sequence_number] = spec
            self._io.spawn(self._push(spec))

    async def _resolve_address(self):
        if self._resolving:  # single resolver; others wait for its outcome
            while self._resolving:
                await asyncio.sleep(0.05)
            return
        self._resolving = True
        try:
            await self._resolve_address_inner()
        finally:
            self._resolving = False

    async def _resolve_address_inner(self):
        prev_addr = self._address
        loop = asyncio.get_running_loop()
        # An actor the GCS holds as PENDING_CREATION or RESTARTING is
        # waited for as long as the GCS holds it so, as the reference's
        # actor task submitter queues calls until the actor is ALIVE or
        # DEAD: the GCS and the raylet bound the creation itself (start
        # and push timeouts, worker registration), and a creation they
        # fail ends as DEAD with its cause. The handle gives up on its own
        # only when the GCS stays unreachable, and warns every
        # PENDING_WARN_S while it waits.
        started = loop.time()
        gcs_window = GLOBAL_CONFIG.get("gcs_rpc_server_reconnect_timeout_s")
        gcs_deadline = started + gcs_window
        next_warn = started + PENDING_WARN_S
        # registrations are async for unnamed actors (worker.py
        # create_actor): "not found" within this window just means the
        # register RPC hasn't landed yet, not that the actor is gone.
        # Backoff doubles 20ms → 250ms so a churn burst of unresolved
        # handles doesn't stampede the GCS with 50 polls/s each.
        unknown_deadline = loop.time() + 5.0
        unknown_wait = 0.02
        # get_actor failures (GCS restarting / failing over) back off with
        # jitter so a herd of resolvers doesn't hammer the recovering GCS
        gcs_backoff = RetryPolicy(base_s=0.2, cap_s=1.0)
        gcs_failures = 0
        while True:
            # pubsub-pushed view first: the ALIVE event carries the full
            # public view, so the common churn path resolves without any
            # get_actor round trip (the poll below is the fallback for
            # actors that went ALIVE before this submitter subscribed)
            info = self._pushed_view
            self._pushed_view = None
            if info is None:
                try:
                    info = await self._cw.gcs.call_async(
                        "get_actor", actor_id=self.actor_id.binary())
                    gcs_failures = 0
                    gcs_deadline = loop.time() + gcs_window
                except Exception:  # noqa: BLE001
                    gcs_failures += 1
                    if loop.time() >= gcs_deadline:
                        self._mark_dead(ActorDiedError(
                            self.actor_id, "timed out resolving actor "
                            f"address: the GCS was unreachable for "
                            f"{gcs_window} s"))
                        return
                    await gcs_backoff.asleep(gcs_failures)
                    continue
            if info is None:
                if loop.time() < unknown_deadline:
                    await asyncio.sleep(unknown_wait)
                    unknown_wait = min(unknown_wait * 2, 0.25)
                    continue
                self._mark_dead(ActorDiedError(self.actor_id, "actor not found"))
                return
            state = info["state"]
            if state == "ALIVE" and info.get("address"):
                self._address = tuple(info["address"])
                self._client = RpcClient(self._address)
                # Everything unacked goes back to the front of the queue.  A
                # NEW incarnation (address changed) starts a fresh sequence
                # space, so renumber from 1 — the restarted actor's ordering
                # state is empty and would otherwise wait forever for the old
                # sequence numbers (reference: actor_task_submitter resend
                # protocol).
                with self._fast_lock:
                    # unacked fast calls: the old channel's replies can no
                    # longer be trusted to arrive; the resend owns them now
                    fast_pending = list(self._fast_inflight.values())
                    self._fast_inflight.clear()
                pending = sorted(list(self._inflight.values()) + fast_pending,
                                 key=lambda s: s.sequence_number) + self._queue
                self._inflight.clear()
                # a cancelled call must not ride the resend protocol into
                # the new incarnation (force-cancel kills the worker; the
                # restart would otherwise re-execute the cancelled call)
                still = []
                for spec in pending:
                    if spec.task_id.binary() in self._cancelled:
                        self._fail_spec(spec, TaskCancelledError(
                            "the actor call was cancelled"))
                    else:
                        still.append(spec)
                pending = still
                if pending and prev_addr is not None and self._address != prev_addr:
                    self._seq = 0
                    for spec in pending:
                        spec.sequence_number = self.next_seq()
                    logger.info("actor %s restarted; resending %d calls",
                                self.actor_id.hex()[:8], len(pending))
                self._queue = pending
                self._state = "CONNECTED"
                self._setup_fast(info.get("fast_port"))
                return
            if state == "DEAD":
                self._mark_dead(ActorDiedError(self.actor_id, info.get("death_cause", "")))
                return
            # actor still PENDING/RESTARTING: wake on the pubsub state
            # event (sub-ms after ALIVE) with a poll-interval fallback
            if loop.time() >= next_warn:
                next_warn = loop.time() + PENDING_WARN_S
                logger.warning(
                    "actor %s is still %s %.0f s after its first call; "
                    "its calls wait for it", self.actor_id.hex()[:8], state,
                    loop.time() - started)
            self._state_event.clear()
            try:
                await asyncio.wait_for(self._state_event.wait(), 0.2)
            except asyncio.TimeoutError:
                pass

    def _encode_spec(self, spec: TaskSpec) -> bytes:
        """Native submit record when eligible (plain-value args + a loaded
        codec); pickle otherwise. Packed per push — the resend path
        renumbers sequence_numbers, so the buffer must not be cached."""
        payload = getattr(spec, "_fast_payload", None)
        if payload is not None:
            from ray_tpu_torch.rpc.native import load_fastspec

            fs = load_fastspec()
            if fs is not None:
                host, port = spec.caller_address
                try:
                    return fs.pack(
                        spec.task_id.binary(), spec.job_id.binary(),
                        spec.actor_id.binary(),
                        spec.caller_worker_id.binary(), host.encode(),
                        spec.actor_method_name.encode(), payload,
                        spec.sequence_number, spec.num_returns, port)
                except OverflowError:
                    pass  # >u32 payload: frame it the general way
        return pickle.dumps(spec)

    async def _push(self, spec: TaskSpec):
        client = self._client
        logger.debug("PUSH seq=%d task=%s", spec.sequence_number,
                     spec.task_id.hex()[:8])
        try:
            reply = await client.call_async("push_task", spec=self._encode_spec(spec), timeout=None)
        except Exception as e:  # noqa: BLE001 - actor worker died / restarting
            logger.debug("PUSH FAIL seq=%d: %r", spec.sequence_number, e)
            await self._on_connection_failure(e)
            return
        logger.debug("REPLY seq=%d results=%d", spec.sequence_number,
                     len(reply.get("results", {})))
        self._inflight.pop(spec.sequence_number, None)
        self._cw.store_task_reply(spec, reply, self._address)

    async def _on_connection_failure(self, exc: Exception):
        if self._state != "CONNECTED":
            return
        self._state = "RESOLVING"
        if self._client is not None:
            self._client.close()
            self._client = None
        # Actor may be restarting: re-resolve.  _resolve_address requeues all
        # unacked calls and renumbers them if this is a new incarnation.
        await self._resolve_address()
        if self._state == "CONNECTED":
            self._schedule_pump()

    def _mark_dead(self, error: Exception):
        self._state = "DEAD"
        self._death_error = error
        with self._fast_lock:
            cli, self._fast = self._fast, None
            fast_pending = list(self._fast_inflight.values())
            self._fast_inflight.clear()
        if cli is not None:
            try:
                cli.close()
            except Exception:  # noqa: BLE001
                pass
        for spec in list(self._inflight.values()) + fast_pending + self._queue:
            self._fail_spec(spec, error)
        self._inflight.clear()
        self._queue.clear()

    def _fail_spec(self, spec: TaskSpec, error: Exception):
        if spec.task_id.binary() in self._cancelled and not isinstance(
                error, TaskCancelledError):
            # e.g. force-cancel killed the actor worker: the death IS the
            # cancel completing
            error = TaskCancelledError("the actor call was cancelled")
        blob = pickle.dumps(error)
        for oid in spec.return_ids():
            self._cw.memory_store.put(oid, error=blob)
        if spec.streaming:
            self._cw.generator_task_failed(spec.task_id, blob)
        self._cw.ack_args_handoffs(spec)

    def cancel(self, task_id_bin: bytes):
        """Owner side (same contract as NormalTaskSubmitter.cancel)."""
        self._cancelled.add(task_id_bin)
        for spec in self._queue:
            if spec.task_id.binary() == task_id_bin:
                self._queue.remove(spec)
                self._fail_spec(spec, TaskCancelledError(
                    "the actor call was cancelled before it started"))
                return ("queued", None)
        for spec in self._inflight.values():
            if spec.task_id.binary() == task_id_bin:
                return ("running", self._address)
        with self._fast_lock:
            for spec in self._fast_inflight.values():
                if spec.task_id.binary() == task_id_bin:
                    return ("running", self._address)
        return (None, None)

    def notify_actor_state(self, view: dict):
        """Pubsub-driven: DEAD → fail; ALIVE after restart → reconnect."""
        state = view.get("state")
        if state == "ALIVE" and view.get("address"):
            # hand the resolver the full view: ALIVE resolution then needs
            # no get_actor round trip (consumed on the loop thread)
            self._pushed_view = view
        else:
            # DEAD/RESTARTING supersede any parked ALIVE view — a stale
            # one would point the resolver at the dead incarnation's
            # address (and skip the new-incarnation renumbering)
            self._pushed_view = None
        self._io.loop.call_soon_threadsafe(self._state_event.set)
        if state == "DEAD" and self._state != "DEAD":
            self._io.loop.call_soon_threadsafe(
                self._mark_dead, ActorDiedError(self.actor_id, view.get("death_cause", "")))
        elif state == "ALIVE" and self._state == "RESOLVING":
            self._io.loop.call_soon_threadsafe(self._schedule_pump)
