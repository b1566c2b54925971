"""DeploymentHandle: client-side router.

Reference: ``python/ray/serve/handle.py:639`` (DeploymentHandle,
``.remote():715``) + ``request_router/`` power-of-two-choices. The handle
caches the replica set (version-stamped from the controller), picks the
less-loaded of two random replicas by local outstanding counts, and
returns an ObjectRef. ``options()`` clones share one router state so load
accounting stays consistent across method handles.
"""

from __future__ import annotations

import asyncio
import collections
import random
import threading
import time
from typing import Any, Dict, List


class _SharedDecay:
    """ONE process-wide timer thread for load-count decay.

    The out-of-worker fallback in :meth:`DeploymentHandle._attach_completion`
    used to spawn a ``threading.Timer`` per call — a churny client outside
    any CoreWorker leaked a thread per request.  All decays share a fixed
    delay, so a single daemon thread draining a FIFO of
    ``(deadline, callback)`` covers every handle in the process."""

    _instance: "_SharedDecay" = None
    _instance_lock = threading.Lock()

    def __init__(self, delay_s: float = 1.0):
        self.delay_s = delay_s
        self._items: "collections.deque" = collections.deque()
        self._cv = threading.Condition()
        self._thread: threading.Thread = None

    @classmethod
    def instance(cls) -> "_SharedDecay":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def schedule(self, callback) -> None:
        with self._cv:
            self._items.append((time.monotonic() + self.delay_s, callback))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="serve-handle-decay")
                self._thread.start()
            self._cv.notify()

    def pending(self) -> int:
        with self._cv:
            return len(self._items)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._items:
                    self._cv.wait()
                deadline, cb = self._items[0]
                delay = deadline - time.monotonic()
                if delay > 0:
                    self._cv.wait(delay)
                    continue
                self._items.popleft()
            try:
                cb()
            except Exception:  # noqa: BLE001 — observer errors stay local
                pass


class _RouterState:
    """Replica set + outstanding counts, shared by all handle clones."""

    # prefix-affinity table bounds (prefix_aware router)
    PREFIX_CHUNK = 16
    PREFIX_MAX_CHUNKS = 8
    PREFIX_TABLE_CAP = 4096

    def __init__(self, deployment_name: str, controller):
        self.name = deployment_name
        self.controller = controller
        self.lock = threading.Lock()
        self.version = -1
        self.replicas: List[Any] = []
        self.outstanding: Dict[int, int] = {}
        self.max_ongoing = 8
        self.router = "pow2"
        self.last_refresh = 0.0
        import collections

        # cumulative-prefix hash -> replica index that last served it
        self._prefix_owner: "collections.OrderedDict" = \
            collections.OrderedDict()
        # replica index -> frozenset of prefix hashes the replica's
        # engine ADVERTISES as cached (radix-tree digest fetched through
        # the controller on refresh).  Second-tier routing signal: the
        # owner table knows what this handle sent; the digest knows what
        # the replica actually holds — including prefixes warmed by
        # OTHER handles/proxies.
        self.replica_digests: Dict[int, frozenset] = {}
        # multiplexed model id -> replica index that last loaded it
        # (reference: multiplexed model routing in request_router/)
        self._model_owner: "collections.OrderedDict" = \
            collections.OrderedDict()

    REFRESH_INTERVAL_S = 1.0

    def _is_fresh(self) -> bool:
        with self.lock:
            return bool(time.monotonic() - self.last_refresh
                        < self.REFRESH_INTERVAL_S and self.replicas)

    def _apply_refresh(self, version, replicas, max_ongoing, router) -> None:
        with self.lock:
            if version != self.version:
                self.version = version
                self.replicas = replicas
                self.outstanding = {i: 0 for i in range(len(replicas))}
                self._prefix_owner.clear()  # indices changed meaning
                self._model_owner.clear()
                self.replica_digests = {}
            self.max_ongoing = max_ongoing
            self.router = router
            self.last_refresh = time.monotonic()

    def _apply_digests(self, digests) -> None:
        with self.lock:
            self.replica_digests = {
                int(i): frozenset(int(h) for h in d)
                for i, d in dict(digests).items()}

    def refresh(self, force: bool = False):
        import ray_tpu_torch

        if not force and self._is_fresh():
            return
        version, replicas, max_ongoing, router = ray_tpu_torch.get(
            [self.controller.get_replicas.remote(self.name)], timeout=30.0)[0]
        self._apply_refresh(version, replicas, max_ongoing, router)
        if router == "prefix_aware":
            # What each replica's engine actually caches (vs the local
            # owner table's what-I-sent view).  Best-effort: a missed
            # fetch only costs routing quality, never availability.
            try:
                self._apply_digests(ray_tpu_torch.get(
                    [self.controller.get_prefix_digests.remote(self.name)],
                    timeout=5.0)[0])
            except Exception:  # noqa: BLE001 — hint only
                pass

    async def refresh_async(self, force: bool = False):
        """Loop-native refresh: awaits the controller reply instead of
        parking a thread in a blocking ``get`` (the proxy's dispatch path
        must never block its event loop — rt-analyze loop-blocker gate)."""
        import ray_tpu_torch

        if not force and self._is_fresh():
            return
        version, replicas, max_ongoing, router = await ray_tpu_torch.get_async(
            self.controller.get_replicas.remote(self.name), timeout=30.0)
        self._apply_refresh(version, replicas, max_ongoing, router)
        if router == "prefix_aware":
            try:
                self._apply_digests(await ray_tpu_torch.get_async(
                    self.controller.get_prefix_digests.remote(self.name),
                    timeout=5.0))
            except Exception:  # noqa: BLE001 — hint only
                pass

    @classmethod
    def _prefix_hashes(cls, key) -> List[int]:
        """Hashes of the cumulative CHUNK-sized prefixes of the routing
        key (tokens for list/tuple prompts, bytes for str/bytes),
        longest first."""
        import hashlib

        def h64(b: bytes) -> int:
            return int.from_bytes(
                hashlib.blake2b(b, digest_size=8).digest(), "little")

        hashes = []
        for n_chunks in range(cls.PREFIX_MAX_CHUNKS, 0, -1):
            cut = key[:n_chunks * cls.PREFIX_CHUNK]
            if not len(cut):
                continue
            if isinstance(cut, str):
                b = cut.encode()
            elif isinstance(cut, bytes):
                b = cut
            else:
                b = repr(tuple(cut)).encode()
            h = h64(b)
            if not hashes or hashes[-1] != h:
                hashes.append(h)
        return hashes

    def _pick_pow2(self) -> int:
        n = len(self.replicas)
        if n == 1:
            return 0
        a, b = random.sample(range(n), 2)
        return a if self.outstanding.get(a, 0) <= \
            self.outstanding.get(b, 0) else b

    MODEL_TABLE_CAP = 1024

    def acquire_replica(self, routing_key=None, model_id=None,
                        count: int = 1):
        """Pick + increment (by ``count`` — a coalesced batch of N
        requests loads its replica as N) under ONE lock hold; returns
        (replica, index) or None if no replicas.

        pow2: less-loaded of two random replicas. prefix_aware
        (reference: serve request_router/ prefix-aware over vLLM prefix
        caching): the replica that last served the longest matching
        request prefix, so its engine prefix cache hits — unless it is
        saturated, then fall back to pow2 and adopt the new owner.
        A multiplexed ``model_id`` (any router mode) takes precedence:
        route to the replica that last loaded the model so its LRU cache
        hits — loading is the expensive HBM-staging step."""
        with self.lock:
            n = len(self.replicas)
            if n == 0:
                return None
            idx = None
            hashes = []
            if model_id is not None:
                owner = self._model_owner.get(model_id)
                if owner is not None and owner < n and \
                        self.outstanding.get(owner, 0) < self.max_ongoing:
                    idx = owner
            if idx is None and self.router == "prefix_aware" \
                    and routing_key is not None:
                hashes = self._prefix_hashes(routing_key)
                for h in hashes:  # longest cumulative prefix first
                    owner = self._prefix_owner.get(h)
                    if owner is not None and owner < n and \
                            self.outstanding.get(owner, 0) < self.max_ongoing:
                        idx = owner
                        break
                if idx is None and self.replica_digests:
                    # owner table missed — consult the replicas' own
                    # advertisements (prefixes warmed through other
                    # handles still route hot)
                    for h in hashes:
                        for cand, dig in self.replica_digests.items():
                            if h in dig and cand < n and \
                                    self.outstanding.get(cand, 0) \
                                    < self.max_ongoing:
                                idx = cand
                                break
                        if idx is not None:
                            break
            if idx is None:
                idx = self._pick_pow2()
            for h in hashes:  # adopt/refresh ownership
                self._prefix_owner[h] = idx
                self._prefix_owner.move_to_end(h)
            while len(self._prefix_owner) > self.PREFIX_TABLE_CAP:
                self._prefix_owner.popitem(last=False)
            if model_id is not None:
                self._model_owner[model_id] = idx
                self._model_owner.move_to_end(model_id)
                while len(self._model_owner) > self.MODEL_TABLE_CAP:
                    self._model_owner.popitem(last=False)
            self.outstanding[idx] = self.outstanding.get(idx, 0) + count
            return self.replicas[idx], idx

    def release(self, idx: int, count: int = 1):
        with self.lock:
            self.outstanding[idx] = max(
                0, self.outstanding.get(idx, count) - count)

    def mark_dead(self, actor_id) -> None:
        """Router-local health view: drop a replica the data plane just
        watched die, WITHOUT waiting for the controller's health probes to
        notice.  The controller's own ejection bumps the replica-set
        version, so the next refresh re-syncs; until then this keeps
        retries off the corpse.  (``_apply_refresh`` only rewrites the
        set on a version change, so the local removal is not resurrected
        by a same-version refresh.)"""
        try:
            dead_hex = actor_id.hex()
        except AttributeError:
            dead_hex = str(actor_id)
        with self.lock:
            keep = [r for r in self.replicas
                    if r._actor_id.hex() != dead_hex]
            if len(keep) == len(self.replicas):
                return
            self.replicas = keep
            # indices changed meaning: reset load + affinity tables (the
            # blip in load accounting is noise next to a replica death)
            self.outstanding = {i: 0 for i in range(len(keep))}
            self._prefix_owner.clear()
            self._model_owner.clear()
            self.replica_digests = {}


def _rebuild_handle(name, controller, method, model_id=None):
    return DeploymentHandle(name, controller, _method=method,
                            _model_id=model_id)


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller,
                 _state: _RouterState = None, _method: str = "__call__",
                 _model_id: str = None):
        self._state = _state or _RouterState(deployment_name, controller)
        self._method = _method
        self._model_id = _model_id

    def __reduce__(self):
        # handles cross process boundaries (e.g. composed deployments
        # receive downstream handles as init args — reference pattern);
        # the router state rebuilds fresh on the receiving side
        return (_rebuild_handle,
                (self._state.name, self._state.controller, self._method,
                 self._model_id))

    @property
    def _name(self):
        return self._state.name

    def options(self, method_name: str = None,
                multiplexed_model_id: str = None) -> "DeploymentHandle":
        """Clone sharing router state. ``multiplexed_model_id`` tags
        requests for a ``@serve.multiplexed`` deployment (reference:
        ``handle.options(multiplexed_model_id=...)``)."""
        return DeploymentHandle(
            self._state.name, self._state.controller, _state=self._state,
            _method=method_name if method_name is not None else self._method,
            _model_id=(multiplexed_model_id if multiplexed_model_id
                       is not None else self._model_id))

    ACQUIRE_TIMEOUT_S = 30.0

    def _routing_key(self, args):
        # prefix_aware routing keys off the first positional argument of
        # REQUEST-carrying methods only (the prompt for LLM deployments);
        # bookkeeping methods like poll(request_id) must not churn the
        # affinity table or be routed by a meaningless key
        if self._method in ("__call__", "generate", "submit") and args \
                and isinstance(args[0], (str, bytes, list, tuple)):
            return args[0]
        return None

    def _submit_to(self, acquired, args, kwargs):
        replica, idx = acquired
        try:
            ref = replica.handle_request.remote(self._method, args, kwargs)
        except BaseException:
            self._state.release(idx)
            raise
        self._attach_completion(ref, idx)
        return ref

    def remote(self, *args, **kwargs):
        deadline = time.monotonic() + self.ACQUIRE_TIMEOUT_S
        routing_key = self._routing_key(args)
        if self._model_id is not None:
            kwargs = dict(kwargs)
            kwargs["_multiplexed_model_id"] = self._model_id
        acquired = None
        while acquired is None:
            self._state.refresh()
            acquired = self._state.acquire_replica(routing_key,
                                                   self._model_id)
            if acquired is None:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"deployment {self._name!r} has no running replicas")
                time.sleep(0.1)
                self._state.refresh(force=True)
        return self._submit_to(acquired, args, kwargs)

    async def _acquire_async(self, routing_key=None, model_id=None,
                             count: int = 1):
        """Loop-native acquire-with-retry (ONE copy for both async
        dispatch flavors): every wait is an ``await`` — no ``time.sleep``,
        no blocking controller ``get``."""
        deadline = time.monotonic() + self.ACQUIRE_TIMEOUT_S
        while True:
            await self._state.refresh_async()
            acquired = self._state.acquire_replica(routing_key, model_id,
                                                   count)
            if acquired is not None:
                return acquired
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"deployment {self._name!r} has no running replicas")
            await asyncio.sleep(0.1)
            await self._state.refresh_async(force=True)

    async def remote_async(self, *args, **kwargs):
        """Async-native dispatch: same routing, acquire/retry, and load
        accounting as :meth:`remote`, runnable directly on a server's
        event loop (the proxy's per-request path)."""
        routing_key = self._routing_key(args)
        if self._model_id is not None:
            kwargs = dict(kwargs)
            kwargs["_multiplexed_model_id"] = self._model_id
        acquired = await self._acquire_async(routing_key, self._model_id)
        return self._submit_to(acquired, args, kwargs)

    async def remote_batch_async(self, calls):
        """Coalesced dispatch of ``calls`` — a list of ``(args, kwargs)``
        pairs — as ONE ``handle_request_batch`` actor call to ONE replica
        (round 11 proxy micro-batching).  Load accounting weights the
        replica by ``len(calls)``; per-item failures come back as
        ``_ItemError`` entries in the result list, not exceptions."""
        count = len(calls)
        replica, idx = await self._acquire_async(count=count)
        try:
            ref = replica.handle_request_batch.remote(self._method, calls)
        except BaseException:
            self._state.release(idx, count)
            raise
        self._attach_completion(ref, idx, count)
        return ref

    def _attach_completion(self, ref, idx: int, count: int = 1):
        """Decrement the outstanding count when the reply lands."""
        state = self._state

        def done():
            state.release(idx, count)

        try:
            from ray_tpu_torch.core_worker.worker import CoreWorker

            cw = CoreWorker.current_or_raise()
            cw.memory_store.add_done_callback(ref.object_id, done)
        except Exception:  # noqa: BLE001 — degrade to time-based decay
            # on the ONE shared timer thread (never a Timer per call: a
            # churny out-of-worker client would leak a thread per request)
            _SharedDecay.instance().schedule(done)
