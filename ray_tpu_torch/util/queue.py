"""Distributed FIFO queue (reference: ``python/ray/util/queue.py`` —
a Queue actor wrapping asyncio.Queue, with blocking/timeout puts and
gets usable from any worker).

The queue is an async actor, so thousands of blocked getters park on
its event loop without holding worker threads; producers/consumers on
any node share it by passing the Queue handle around (it pickles)."""

from __future__ import annotations

from typing import Any, List, Optional


class Empty(Exception):
    """get() timed out on an empty queue (mirrors queue.Empty)."""


class Full(Exception):
    """put() timed out on a full queue (mirrors queue.Full)."""


class _QueueActor:
    def __init__(self, maxsize: int):
        import asyncio

        self._q: "asyncio.Queue" = asyncio.Queue(maxsize=maxsize)

    async def put(self, item: Any, timeout: Optional[float] = None) -> bool:
        import asyncio

        if timeout is None:
            await self._q.put(item)
            return True
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: Optional[float] = None):
        import asyncio

        if timeout is None:
            return (True, await self._q.get())
        try:
            return (True, await asyncio.wait_for(self._q.get(), timeout))
        except asyncio.TimeoutError:
            return (False, None)

    async def put_nowait_batch(self, items: List[Any]) -> int:
        n = 0
        for it in items:
            if self._q.full():
                break
            self._q.put_nowait(it)
            n += 1
        return n

    async def get_nowait_batch(self, max_items: int) -> List[Any]:
        out = []
        while len(out) < max_items and not self._q.empty():
            out.append(self._q.get_nowait())
        return out

    async def qsize(self) -> int:
        return self._q.qsize()

    async def empty(self) -> bool:
        return self._q.empty()

    async def full(self) -> bool:
        return self._q.full()


def _rebuild_queue(actor) -> "Queue":
    return Queue(_actor=actor)


class Queue:
    """Client handle; safe to pass to tasks/actors (pickles by actor
    handle). ``maxsize=0`` means unbounded."""

    def __init__(self, maxsize: int = 0, *, _actor=None):
        if _actor is not None:
            self._actor = _actor
            return
        import ray_tpu_torch

        self._actor = ray_tpu_torch.remote(_QueueActor).options(
            max_concurrency=1000).remote(maxsize)

    def __reduce__(self):
        # rebuild from the existing actor handle — Queue(0) here would
        # silently spawn a NEW queue actor per unpickle
        return (_rebuild_queue, (self._actor,))

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        import ray_tpu_torch

        t = (timeout if block else 0.001)
        ok = ray_tpu_torch.get(self._actor.put.remote(item, t))
        if not ok:
            raise Full("queue full")

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        import ray_tpu_torch

        t = (timeout if block else 0.001)
        ok, item = ray_tpu_torch.get(self._actor.get.remote(t),
                               timeout=None if t is None else t + 30)
        if not ok:
            raise Empty("queue empty")
        return item

    def put_async(self, item: Any):
        """Returns the ObjectRef of the put (fire-and-forget friendly)."""
        return self._actor.put.remote(item, None)

    def put_nowait_batch(self, items: List[Any]) -> int:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.put_nowait_batch.remote(list(items)))

    def get_nowait_batch(self, max_items: int) -> List[Any]:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.get_nowait_batch.remote(max_items))

    def qsize(self) -> int:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.empty.remote())

    def full(self) -> bool:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.full.remote())

    def shutdown(self) -> None:
        import ray_tpu_torch

        try:
            ray_tpu_torch.kill(self._actor)
        except Exception:  # noqa: BLE001
            pass
