"""Streaming generator returns (``num_returns="streaming"``).

Equivalent of the reference's ObjectRefGenerator protocol
(src/ray/protobuf/core_worker.proto:430 ``ReportGeneratorItemReturns``): a
task whose function is a generator reports each yielded item to the *owner*
(the caller) as it is produced, instead of returning everything at task end.
The owner stores each item under ``ObjectID.from_index(task_id, i+1)`` — the
same id scheme as fixed returns — so items are ordinary owned objects:
gettable, borrowable, and recoverable via lineage re-execution.

Design points (TPU-first redesign, not a port):

- **Item transport** rides the existing object plane: small items inline in
  the report RPC; large items stay in the executor's memory/shm store and the
  report carries a location, exactly like fixed task returns.
- **Backpressure** is owner-driven: the owner's report handler delays its
  reply while more than ``streaming_generator_backpressure`` items are
  unconsumed, and the producer sends reports strictly in sequence — so a slow
  consumer throttles the producer with zero extra protocol.
- **At-least-once + dedup**: a retried generator task (worker death
  mid-stream) replays from item 0; the owner ignores indices it already
  stored, so consumed items keep their values and the stream resumes where it
  broke.
- **Cancellation**: dropping the ``ObjectRefGenerator`` unregisters the
  stream; the producer's next report gets ``{"cancel": True}`` and stops
  iterating the user generator.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from ray_tpu_torch.common.ids import ObjectID, TaskID
from .reference import ObjectRef


class _StreamState:
    """Owner-side state of one in-flight generator stream."""

    def __init__(self, spec=None):
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)      # consumers wait here
        self.items: Dict[int, ObjectRef] = {}         # un-emitted item refs
        self.seen = set()                             # all reported indices
        self.next_emit = 0                            # consumer position
        self.consumed = 0
        self.total: Optional[int] = None              # set when stream ends
        self.error: Optional[bytes] = None            # terminal task failure
        self.space_waiters = []                       # (loop, future) pairs
        self.item_waiters = []                        # (loop, future): async
        # consumers parked on the NEXT item (push wakeup, no poll thread)
        self.spec = spec                              # for lineage of items

    # ------------------------------------------------------------- producer
    def add(self, index: int, ref: ObjectRef) -> bool:
        """Record a reported item. Returns False if it was a duplicate
        (replayed by a retried task)."""
        with self.cv:
            if index in self.seen:
                return False
            self.seen.add(index)
            self.items[index] = ref
            self.cv.notify_all()
        self._wake_item_waiters()
        return True

    def finish(self, total: Optional[int]) -> None:
        with self.cv:
            if self.total is None:
                self.total = total if total is not None else len(self.seen)
            self.cv.notify_all()
        self._wake_space_waiters()
        self._wake_item_waiters()

    def fail(self, error_blob: bytes) -> None:
        with self.cv:
            self.error = error_blob
            self.cv.notify_all()
        self._wake_space_waiters()
        self._wake_item_waiters()

    def outstanding(self, index: int) -> int:
        with self.lock:
            return (index + 1) - self.consumed

    def done_or_failed(self) -> bool:
        with self.lock:
            return self.total is not None or self.error is not None

    # ------------------------------------------------------------- consumer
    def next_ref(self, timeout: Optional[float]) -> ObjectRef:
        """Block until the next item (in order) is available.

        Raises StopIteration at end-of-stream, or the task's error if the
        stream failed before producing this index."""
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        with self.cv:
            while True:
                if self.next_emit in self.items:
                    # pop, don't keep: holding the ref here would pin every
                    # consumed value in the owner's memory store for the
                    # stream's whole lifetime (dedup only needs `seen`)
                    ref = self.items.pop(self.next_emit)
                    self.next_emit += 1
                    self.consumed += 1
                    break
                if self.total is not None and self.next_emit >= self.total:
                    raise StopIteration
                if self.error is not None:
                    import pickle

                    raise pickle.loads(self.error)
                remaining = (None if deadline is None
                             else deadline - _time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        "timed out waiting for next generator item")
                self.cv.wait(remaining if remaining is not None else 1.0)
        self._wake_space_waiters()
        return ref

    def next_ref_or_park(self, loop) -> Tuple[Optional[ObjectRef],
                                              Optional["object"]]:
        """Async-consumer step: returns ``(ref, None)`` when the next item
        is available now, or ``(None, future)`` with a future on ``loop``
        that the producer resolves when state changes (item arrival,
        end-of-stream, failure).  Raises StopIteration at end-of-stream and
        the task's error on failure.  Registering the waiter under the same
        lock the producer's ``add`` takes makes the wakeup race-free."""
        fut = None
        with self.cv:
            if self.next_emit in self.items:
                ref = self.items.pop(self.next_emit)
                self.next_emit += 1
                self.consumed += 1
            elif self.total is not None and self.next_emit >= self.total:
                raise StopIteration
            elif self.error is not None:
                import pickle

                raise pickle.loads(self.error)
            else:
                ref = None
                fut = loop.create_future()
                self.item_waiters.append((loop, fut))
        if ref is not None:
            self._wake_space_waiters()
        return ref, fut

    def _wake_space_waiters(self):
        with self.lock:
            waiters, self.space_waiters = self.space_waiters, []
        for loop, fut in waiters:
            try:
                loop.call_soon_threadsafe(
                    lambda f=fut: f.done() or f.set_result(None))
            except RuntimeError:
                pass  # loop closed

    def _wake_item_waiters(self):
        with self.lock:
            waiters, self.item_waiters = self.item_waiters, []
        for loop, fut in waiters:
            try:
                loop.call_soon_threadsafe(
                    lambda f=fut: f.done() or f.set_result(None))
            except RuntimeError:
                pass  # loop closed


class ObjectRefGenerator:
    """Iterator over the ObjectRefs of a streaming task's yielded items.

    ``__next__`` blocks until the producer reports the next item (or the
    stream ends / fails). Dropping the generator cancels the stream at the
    producer. Also usable with ``async for``: ``__anext__`` is
    push-native — the producer wakes the awaiting loop directly, no
    thread parked per consumer.
    """

    def __init__(self, core_worker, task_id: TaskID):
        self._cw = core_worker
        self.task_id = task_id

    # -------------------------------------------------------------- sync API
    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        st = self._cw._generators.get(self.task_id)
        if st is None:
            raise StopIteration
        return st.next_ref(timeout=None)

    def next_with_timeout(self, timeout: float) -> ObjectRef:
        st = self._cw._generators.get(self.task_id)
        if st is None:
            raise StopIteration
        return st.next_ref(timeout=timeout)

    # ------------------------------------------------------------- async API
    def __aiter__(self) -> "ObjectRefGenerator":
        return self

    async def __anext__(self) -> ObjectRef:
        """Push-native async iteration: items wake this coroutine directly
        (producer → ``_wake_item_waiters`` → this loop) — no executor
        thread parked per consumer, which is what lets one proxy loop
        drive many concurrent SSE streams."""
        import asyncio

        loop = asyncio.get_running_loop()
        while True:
            st = self._cw._generators.get(self.task_id)
            if st is None:
                raise StopAsyncIteration
            try:
                ref, fut = st.next_ref_or_park(loop)
            except StopIteration:
                raise StopAsyncIteration from None
            if ref is not None:
                return ref
            await fut

    # ----------------------------------------------------------------- misc
    def completed(self) -> bool:
        st = self._cw._generators.get(self.task_id)
        if st is None:
            return True
        with st.lock:
            return (st.total is not None
                    and st.next_emit >= st.total) or st.error is not None

    def close(self) -> None:
        """Cancel the stream: unregister so the producer's next report is
        answered with cancel=True."""
        self._cw._generators.pop(self.task_id, None)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass

    def __repr__(self) -> str:
        return f"ObjectRefGenerator({self.task_id.hex()[:16]}…)"
