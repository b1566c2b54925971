"""@serve.batch — request coalescing inside a replica.

Reference: ``python/ray/serve/batching.py`` — decorated method receives a
LIST of requests; concurrent callers are queued until ``max_batch_size``
or ``batch_wait_timeout_s`` and executed as one call: batched matmuls
keep the GPU's tensor cores busy, and the LLM path builds its continuous
batching on the same queue primitive.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable, List, Optional


class _Waiter:
    __slots__ = ("value", "error", "event")

    def __init__(self):
        self.value: Any = None
        self.error: Optional[BaseException] = None
        self.event = threading.Event()


class _BatchQueue:
    def __init__(self, fn: Callable[[List[Any]], List[Any]],
                 max_batch_size: int, timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._timeout = timeout_s
        self._lock = threading.Lock()
        self._pending: List[tuple] = []
        self._flush_timer: Optional[threading.Timer] = None

    def submit(self, instance, item) -> Any:
        waiter = _Waiter()
        run_now: Optional[List[tuple]] = None
        with self._lock:
            self._pending.append((instance, item, waiter))
            if len(self._pending) >= self._max:
                run_now, self._pending = self._pending, []
                if self._flush_timer is not None:
                    self._flush_timer.cancel()
                    self._flush_timer = None
            elif self._flush_timer is None:
                self._flush_timer = threading.Timer(self._timeout,
                                                    self._flush)
                self._flush_timer.daemon = True
                self._flush_timer.start()
        if run_now is not None:
            self._run(run_now)
        else:
            waiter.event.wait()
        if waiter.error is not None:
            raise waiter.error
        return waiter.value

    def _flush(self):
        with self._lock:
            batch, self._pending = self._pending, []
            self._flush_timer = None
        if batch:
            self._run(batch)

    def _run(self, batch: List[tuple]):
        instance = batch[0][0]
        items = [b[1] for b in batch]
        waiters = [b[2] for b in batch]
        try:
            if instance is not None:
                results = self._fn(instance, items)
            else:
                results = self._fn(items)
            if len(results) != len(items):
                raise ValueError(
                    f"@batch function returned {len(results)} results for "
                    f"{len(items)} inputs")
            for w, r in zip(waiters, results):
                w.value = r
        except BaseException as e:  # noqa: BLE001 — fan error to callers
            for w in waiters:
                w.error = e
        for w in waiters:
            w.event.set()


# Per-process queue registry: _BatchQueue holds threading primitives that
# must NOT ride along when cloudpickle ships the decorated class to a
# replica — queues are (re)created lazily in whichever process calls.
_QUEUES: dict = {}
_QUEUES_LOCK = threading.Lock()


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorate a (self, requests: List) -> List method or a
    (requests: List) -> List function."""

    def wrap(fn):
        import uuid

        key = f"{getattr(fn, '__qualname__', 'batch_fn')}:{uuid.uuid4().hex}"

        def get_queue(instance) -> _BatchQueue:
            # Queues are keyed per (function, instance): two instances of a
            # batched class must never coalesce into each other's batches.
            # Reach the registry via the module: cloudpickle serializes a
            # by-value function's referenced globals BY VALUE, and the
            # registry lock must never ride along to replicas.
            import ray_tpu_torch.serve.batching as B

            qkey = (key, id(instance))
            q = B._QUEUES.get(qkey)
            if q is None:
                with B._QUEUES_LOCK:
                    q = B._QUEUES.setdefault(
                        qkey, B._BatchQueue(fn, max_batch_size,
                                            batch_wait_timeout_s))
            return q

        @functools.wraps(fn)
        def method_wrapper(self_or_item, *rest):
            if rest:                      # bound method: (self, item)
                return get_queue(self_or_item).submit(self_or_item, rest[0])
            return get_queue(None).submit(None, self_or_item)

        return method_wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
