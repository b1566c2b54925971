"""ActorPool: round-robin work distribution over a fixed set of actors
(reference: ``python/ray/util/actor_pool.py`` — map/map_unordered/
submit/get_next over pre-created actors).

Distinct from the Data library's internal UDF pool: this is the
general-purpose public utility."""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, Iterator, List, Tuple


class ActorPool:
    def __init__(self, actors: List[Any]):
        if not actors:
            raise ValueError("ActorPool needs at least one actor")
        self._idle = collections.deque(actors)
        self._future_to_actor: dict = {}
        self._pending: collections.deque = collections.deque()  # (fn, value)
        self._index_to_future: dict = {}
        self._next_task_index = 0
        self._next_return_index = 0

    # -------------------------------------------------------------- submit
    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """``fn(actor, value)`` must return an ObjectRef (e.g.
        ``lambda a, v: a.process.remote(v)``). Queued if all actors are
        busy; dispatched as actors free up."""
        if self._idle:
            actor = self._idle.popleft()
            ref = fn(actor, value)
            self._future_to_actor[ref.object_id] = (actor, ref)
            self._index_to_future[self._next_task_index] = ref
        else:
            self._index_to_future[self._next_task_index] = None
            self._pending.append((self._next_task_index, fn, value))
        self._next_task_index += 1

    def _dispatch_pending(self) -> None:
        while self._pending and self._idle:
            index, fn, value = self._pending.popleft()
            actor = self._idle.popleft()
            ref = fn(actor, value)
            self._future_to_actor[ref.object_id] = (actor, ref)
            self._index_to_future[index] = ref

    def _release(self, ref) -> None:
        actor, _ = self._future_to_actor.pop(ref.object_id)
        self._idle.append(actor)
        self._dispatch_pending()

    # ---------------------------------------------------------------- get
    def has_next(self) -> bool:
        return self._next_return_index < self._next_task_index

    def get_next(self, timeout: float = None) -> Any:
        """Next result in SUBMISSION order."""
        import ray_tpu_torch

        if not self.has_next():
            raise StopIteration("no pending results")
        index = self._next_return_index
        ref = self._index_to_future.pop(index, None)
        if ref is None:
            # ordered consumption dispatches strictly in index order, so
            # the oldest unconsumed task is always dispatched; a hole
            # means ordered and unordered gets were interleaved
            raise RuntimeError(
                "get_next after get_next_unordered on the same pool: "
                "pick one consumption order (reference ActorPool has "
                "the same constraint)")
        self._next_return_index += 1
        value = ray_tpu_torch.get(ref, timeout=timeout)
        self._release(ref)
        return value

    def get_next_unordered(self, timeout: float = None) -> Any:
        """Next COMPLETED result, any order."""
        import ray_tpu_torch

        if not self.has_next():
            raise StopIteration("no pending results")
        while True:
            refs = [r for r in self._index_to_future.values()
                    if r is not None]
            if refs:
                ready, _ = ray_tpu_torch.wait(refs, num_returns=1,
                                        timeout=timeout)
                if ready:
                    ref = ready[0]
                    for idx, r in self._index_to_future.items():
                        if r is not None and \
                                r.object_id == ref.object_id:
                            del self._index_to_future[idx]
                            break
                    # unordered consumption still advances the window
                    self._next_return_index += 1
                    value = ray_tpu_torch.get(ref)
                    self._release(ref)
                    return value
            self._dispatch_pending()

    # ---------------------------------------------------------------- map
    def map(self, fn: Callable[[Any, Any], Any],
            values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # -------------------------------------------------------------- manage
    def has_free(self) -> bool:
        return bool(self._idle)

    def pop_idle(self):
        return self._idle.popleft() if self._idle else None

    def push(self, actor) -> None:
        self._idle.append(actor)
        self._dispatch_pending()
