"""In-process object store (reference: core_worker/store_provider/memory_store/).

Holds serialized objects owned by or cached in this worker: task returns,
``put()`` values, and fetched remote objects.  Entries are either concrete
(bytes or an error) or *pending* (a future a ``get`` can block on).  Large
objects additionally live in the node's shared-memory store once the native
object plane is attached (see ray_tpu_torch.object_store).

Spilling (reference: raylet/local_object_manager.h:43): when a put would
exceed the store cap, ready values are spilled largest-first to the external
storage dir and restored transparently on access
(AsyncRestoreSpilledObject:125 equivalent).

Large-value routing: byte values at or above ``memory_store_shm_threshold``
are handed to the node's shm arena (via the router installed by the
CoreWorker) and held as pinned zero-copy views — no heap charge, shared
with every process on the node.  A put that still cannot fit after
spilling is demoted straight to the spill dir instead of raising
``ObjectStoreFullError``: the store's contract is that a put never fails
for capacity, it only gets slower (the round-5 GB-shuffle crash was this
raise surfacing through a reduce task whose single output exceeded the
whole cap).
"""

from __future__ import annotations

import logging
import os
import time as _time
import tempfile
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.common.config import GLOBAL_CONFIG
from ray_tpu_torch.common.ids import ObjectID
from ray_tpu_torch.common.status import ObjectStoreFullError, RtTimeoutError

logger = logging.getLogger(__name__)


@dataclass
class Entry:
    value: Optional[bytes] = None  # serialized value (bytes, or a pinned
    # shm memoryview for values backed by the node store's shared pages)
    error: Optional[bytes] = None  # serialized exception
    location: Optional[Tuple[str, int]] = None  # remote holder (large objects)
    is_ready: bool = False
    size: int = 0
    spilled_path: Optional[str] = None  # on-disk value (spilled)
    shm_backed: bool = False  # value aliases shm pages: no heap charge,
    # never spilled (the pin keeps the pages resident; disk would be a
    # redundant copy of already-durable shared memory)


class MemoryStore:
    def __init__(self):
        self._entries: Dict[ObjectID, Entry] = {}
        self._cv = threading.Condition()
        self._bytes_used = 0
        self._done_callbacks: Dict[ObjectID, list] = {}
        self._spill_dir: Optional[str] = None
        # shm router (installed by the CoreWorker once the node store is
        # probed): bytes -> pinned read-only memoryview over the arena,
        # or None when the arena can't admit the value right now
        self._shm_router = None
        # loss forensics (RT_store_debug=1): per-oid event history so an
        # "unknown object" reply can say exactly what happened to the
        # entry instead of inviting guesswork
        self._debug = bool(os.environ.get("RT_store_debug"))
        self._history: Dict[ObjectID, list] = {}

    def _note(self, object_id: ObjectID, event: str) -> None:
        if self._debug:
            self._history.setdefault(object_id, []).append(
                (round(_time.monotonic(), 3), event))

    def history(self, object_id: ObjectID) -> list:
        return self._history.get(object_id, [])

    # ------------------------------------------------------------- spilling
    def _ensure_spill_dir(self) -> str:
        if self._spill_dir is None:
            base = GLOBAL_CONFIG.get("object_spilling_dir") or None
            self._spill_dir = tempfile.mkdtemp(prefix="rtt_spill_", dir=base)
            try:
                # ownership marker for shutdown GC (object_store/shm.py
                # gc_spill_dirs): a dir whose recorded owner pid is dead
                # is an orphan from a crashed session and gets removed
                with open(os.path.join(self._spill_dir, ".owner"),
                          "w") as f:
                    f.write(str(os.getpid()))
            except OSError:
                pass
        return self._spill_dir

    def _spill_locked(self, need_bytes: int) -> None:
        """Spill ready values, largest first, until `need_bytes` are freed.
        Called under self._cv."""
        candidates = sorted(
            ((e.size, oid) for oid, e in self._entries.items()
             if e.is_ready and e.value is not None and e.size > 0
             and not e.shm_backed),
            key=lambda t: t[0], reverse=True)
        spill_dir = self._ensure_spill_dir()
        for size, oid in candidates:
            if need_bytes <= 0:
                return
            e = self._entries[oid]
            path = os.path.join(spill_dir, oid.hex())
            try:
                with open(path, "wb") as f:
                    f.write(e.value)
            except OSError as err:
                logger.warning("spill of %s failed: %s", oid.hex()[:12], err)
                continue
            # Replace rather than mutate: readers that already hold the old
            # Entry (handlers read entry.value after releasing the lock)
            # keep a value-bearing snapshot; the bytes are reclaimed when
            # the last such reader drops it.
            import dataclasses as _dc
            self._entries[oid] = _dc.replace(e, value=None, spilled_path=path)
            self._bytes_used -= size
            need_bytes -= size
            logger.debug("spilled %s (%d bytes) to %s",
                         oid.hex()[:12], size, path)

    def _restore_locked(self, e: Entry) -> bool:
        """Load a spilled value back into memory (spilling others if the
        restore itself overflows the cap). Returns False if the spill file
        is gone/unreadable — the entry is then lost, not an I/O crash."""
        if e.spilled_path is None or e.value is not None:
            return True
        try:
            with open(e.spilled_path, "rb") as f:
                value = f.read()
        except OSError as err:
            logger.warning("restore of spilled %s failed: %s",
                           e.spilled_path, err)
            return False
        cap = GLOBAL_CONFIG.get("memory_store_max_bytes")
        if self._bytes_used + len(value) > cap:
            self._spill_locked(self._bytes_used + len(value) - cap)
        e.value = value
        self._bytes_used += len(value)
        try:
            os.unlink(e.spilled_path)
        except OSError:
            pass
        e.spilled_path = None
        return True

    def set_shm_router(self, router) -> None:
        """``router(object_id_bytes, bytes) -> Optional[memoryview]`` —
        admit a large value to the node shm arena and return a pinned
        zero-copy view over it (``None``: keep the value on-heap)."""
        self._shm_router = router

    def _demote_incoming_locked(self, object_id: ObjectID, value,
                                size: int) -> Optional[str]:
        """Last-resort admission for a value that cannot fit the heap cap
        even after spilling (e.g. a single value larger than the whole
        cap): write it straight to the spill dir.  Returns the spill path,
        or None when the disk write itself failed."""
        path = os.path.join(self._ensure_spill_dir(), object_id.hex())
        try:
            with open(path, "wb") as f:
                f.write(value)
        except OSError as err:
            logger.warning("demotion of incoming %s (%d bytes) failed: %s",
                           object_id.hex()[:12], size, err)
            return None
        self._note(object_id, f"demoted_incoming({size})")
        return path

    def put(self, object_id: ObjectID, value: Optional[bytes] = None,
            error: Optional[bytes] = None,
            location: Optional[Tuple[str, int]] = None) -> None:
        size = len(value) if value is not None else 0
        shm_backed = isinstance(value, memoryview)
        router = self._shm_router
        route_at = GLOBAL_CONFIG.get("memory_store_shm_threshold")
        if (router is not None and value is not None and not shm_backed
                and 0 < route_at <= size):
            # hand large byte values to the node arena: zero heap charge,
            # and same-node consumers read the shared pages directly
            try:
                view = router(object_id.binary(), value)
            except Exception:  # noqa: BLE001 — routing is best-effort
                logger.debug("shm routing of %s failed",
                             object_id.hex()[:12], exc_info=True)
                view = None
            if view is not None:
                value = view
                shm_backed = True
        charge = 0 if shm_backed else size  # shm pages aren't heap
        spilled_path = None
        with self._cv:
            cap = GLOBAL_CONFIG.get("memory_store_max_bytes")
            high = cap * GLOBAL_CONFIG.get("object_spilling_threshold")
            existing = self._entries.get(object_id)
            self._note(object_id,
                       f"put(v={value is not None},e={error is not None},"
                       f"loc={location is not None},"
                       f"dup={existing is not None and existing.is_ready})")
            if existing is not None and existing.is_ready:
                return  # idempotent: first write wins (retries may re-store)
            if self._bytes_used + charge > high:
                # spill down to the configured fullness ratio so later puts
                # are less likely to pay the spill on their critical path
                self._spill_locked(int(self._bytes_used + charge - high))
            if charge and self._bytes_used + charge > cap:
                # still over: demote THIS value to disk rather than raise —
                # a put never fails for capacity, it only gets slower.
                # (charge == 0 entries — errors, locations, shm views —
                # add no heap and store normally even when the heap is
                # transiently over cap, e.g. after a forced restore.)
                spilled_path = self._demote_incoming_locked(
                    object_id, value, size)
                if spilled_path is None:
                    raise ObjectStoreFullError(
                        f"memory store full ({self._bytes_used + charge} > "
                        f"{cap}) and the spill dir is unwritable")
                value, charge = None, 0
            self._entries[object_id] = Entry(
                value=value, error=error, location=location, is_ready=True,
                size=size, shm_backed=shm_backed,
                spilled_path=spilled_path)
            self._bytes_used += charge
            callbacks = self._done_callbacks.pop(object_id, [])
            self._cv.notify_all()
        for cb in callbacks:  # outside the lock: callbacks may re-enter
            try:
                cb()
            except Exception:  # noqa: BLE001 — observer errors stay local
                pass

    def add_done_callback(self, object_id: ObjectID, callback) -> None:
        """Invoke ``callback()`` once the entry becomes ready (immediately
        if it already is). Used by routing layers for load accounting."""
        with self._cv:
            e = self._entries.get(object_id)
            if e is None or not e.is_ready:
                self._done_callbacks.setdefault(object_id, []).append(callback)
                return
        try:
            callback()
        except Exception:  # noqa: BLE001
            pass

    def remove_done_callback(self, object_id: ObjectID, callback) -> None:
        """Deregister a callback added by :meth:`add_done_callback` that
        will no longer be awaited (e.g. an async getter timed out) — a
        wedged producer must not accumulate one dead closure per
        timed-out wait."""
        with self._cv:
            callbacks = self._done_callbacks.get(object_id)
            if not callbacks:
                return
            try:
                callbacks.remove(callback)
            except ValueError:
                return
            if not callbacks:
                del self._done_callbacks[object_id]

    def mark_pending(self, object_id: ObjectID) -> None:
        with self._cv:
            self._note(object_id, "mark_pending")
            self._entries.setdefault(object_id, Entry())

    def is_pending(self, object_id: ObjectID) -> bool:
        """True when the entry exists but has no value yet (someone is
        waiting on it, e.g. a reconstruct in flight)."""
        with self._cv:
            e = self._entries.get(object_id)
            return e is not None and not e.is_ready

    def contains(self, object_id: ObjectID) -> bool:
        with self._cv:
            e = self._entries.get(object_id)
            return e is not None and e.is_ready

    def get_if_ready(self, object_id: ObjectID) -> Optional[Entry]:
        with self._cv:
            e = self._entries.get(object_id)
            if e is None or not e.is_ready:
                return None
            if e.spilled_path is not None and not self._restore_locked(e):
                del self._entries[object_id]  # spill file lost
                return None
            return e

    def wait_ready(self, object_ids: List[ObjectID], num_ready: int,
                   timeout: Optional[float]) -> Tuple[List[ObjectID], List[ObjectID]]:
        """Block until `num_ready` of `object_ids` are ready. Returns (ready, not_ready)."""
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._cv:
            while True:
                ready = [o for o in object_ids if (e := self._entries.get(o)) and e.is_ready]
                if len(ready) >= num_ready:
                    break
                remaining = None if deadline is None else deadline - _time.monotonic()
                if remaining is not None and remaining <= 0:
                    break
                self._cv.wait(remaining if remaining is not None else 1.0)
            ready_set = set(ready)
            return ready, [o for o in object_ids if o not in ready_set]

    def get_blocking(self, object_id: ObjectID, timeout: Optional[float]) -> Entry:
        ready, _ = self.wait_ready([object_id], 1, timeout)
        if not ready:
            raise RtTimeoutError(f"timed out waiting for {object_id}")
        with self._cv:
            e = self._entries[object_id]
            if e.spilled_path is not None and not self._restore_locked(e):
                del self._entries[object_id]  # lost: let callers reconstruct
                raise RtTimeoutError(
                    f"spilled value for {object_id} lost from disk")
            return e

    def read_range(self, object_id: ObjectID, offset: int, length: int):
        """Byte range of a ready value; spilled values are read directly
        from the spill file WITHOUT restoring (chunked pulls of a spilled
        object stay O(total size) in disk I/O)."""
        with self._cv:
            e = self._entries.get(object_id)
            if e is None or not e.is_ready:
                return None
            if e.value is not None:
                return bytes(memoryview(e.value)[offset:offset + length])
            path = e.spilled_path
        if path is None:
            return None
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                return f.read(length)
        except OSError:
            return None

    def value_meta_blocking(self, object_id: ObjectID,
                            timeout: Optional[float]):
        """Wait for readiness, then report {size|error|location} WITHOUT
        restoring a spilled value (the chunk path reads it from disk)."""
        ready, _ = self.wait_ready([object_id], 1, timeout)
        if not ready:
            return None
        with self._cv:
            e = self._entries.get(object_id)
            if e is None:
                return None
            if e.error is not None:
                return {"error": e.error}
            if e.value is not None or e.spilled_path is not None:
                return {"size": e.size}
            if e.location is not None:
                return {"location": e.location}
            return {}

    def get_ready_no_restore(self, object_id: ObjectID
                             ) -> Tuple[Optional[Entry], bool]:
        """Atomic peek for async getters: ``(entry, False)`` when the
        entry is ready in memory, ``(None, True)`` when it is ready but
        spilled (the caller should run the restoring :meth:`get_if_ready`
        on a thread — disk I/O must not run on an event loop, and a
        separate peek-then-read pair would race the spiller), and
        ``(None, False)`` when not ready."""
        with self._cv:
            e = self._entries.get(object_id)
            if e is None or not e.is_ready:
                return None, False
            if e.value is None and e.spilled_path is not None:
                return None, True
            return e, False

    def peek_shm_backed(self, object_id: ObjectID) -> bool:
        """True when a ready entry holds a pinned shm view — WITHOUT
        restoring a spilled value (used on the post-task release path,
        where a restore would be pure wasted I/O)."""
        with self._cv:
            e = self._entries.get(object_id)
            return (e is not None and e.is_ready and e.shm_backed
                    and e.value is not None)

    def peek_location(self, object_id: ObjectID):
        """Location of a ready entry WITHOUT restoring a spilled value
        (used on free paths, where restoring would be wasted I/O)."""
        with self._cv:
            e = self._entries.get(object_id)
            return e.location if e is not None and e.is_ready else None

    def free(self, object_ids: List[ObjectID]) -> None:
        import traceback
        with self._cv:
            for oid in object_ids:
                if self._debug:
                    caller = traceback.extract_stack(limit=4)[0]
                    self._note(oid, f"free from {caller.name}:{caller.lineno}")
                e = self._entries.pop(oid, None)
                if e is not None:
                    if e.value is not None and not e.shm_backed:
                        self._bytes_used -= e.size
                    if e.spilled_path is not None:
                        try:
                            os.unlink(e.spilled_path)
                        except OSError:
                            pass
                # a freed-before-ready object will never fire its callbacks
                self._done_callbacks.pop(oid, None)

    def drop_shm_views(self) -> None:
        """Drop every entry whose value is a pinned shm view. Process-exit
        path: the arena copy is the durable one, and a dead process's pin
        can never be released — it would make the span unevictable for the
        life of the arena. The gc.collect runs the views' release
        finalizers now rather than at interpreter teardown (os._exit
        skips that)."""
        import gc

        with self._cv:
            for oid in [o for o, e in self._entries.items() if e.shm_backed]:
                del self._entries[oid]
        gc.collect()

    def stats(self) -> dict:
        with self._cv:
            return {"num_objects": len(self._entries), "bytes_used": self._bytes_used}
