"""One retry/backoff/deadline policy for every cross-process path.

Before this module each boundary rolled its own loop: the transfer pull
chain used fixed 30 s socket timeouts, the task submitter slept a flat
0.3 s once, the RPC client hand-computed exponential backoff, and nested
calls STACKED their budgets — a pull inside a fetch inside a task could
wait 30 s per layer.  ``RetryPolicy`` + ``Deadline`` replace all of
that: exponential backoff with full jitter, an attempt cap, and one
deadline budget threaded through nested calls so every layer shares the
same clock.

Typical shapes::

    # explicit loop (callers that need per-attempt logic)
    policy = RetryPolicy(max_attempts=5, deadline=Deadline(10.0))
    for attempt in policy:                    # 1, 2, 3, ...
        try:
            return do_rpc(timeout=policy.deadline.remaining(cap=5.0))
        except ConnectionError as e:
            if not policy.sleep(attempt):     # backs off, or gives up
                raise

    # wrapped call
    policy.call(lambda: do_rpc(), retry_on=(ConnectionError,))
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Callable, Iterator, Optional, Tuple, Type

__all__ = ["Deadline", "RetryPolicy", "DEFAULT_BASE_S", "DEFAULT_CAP_S"]

DEFAULT_BASE_S = 0.05
DEFAULT_CAP_S = 2.0


class Deadline:
    """An absolute budget on the monotonic clock, passed DOWN call chains.

    ``Deadline(30.0)`` means "this whole operation — every nested retry
    included — has 30 s".  Callees take ``deadline.remaining()`` for
    their per-step timeouts instead of inventing fresh 30 s windows.
    ``Deadline(None)`` is the explicit "no budget" value so signatures
    can always take a Deadline.
    """

    __slots__ = ("_at",)

    def __init__(self, timeout_s: Optional[float] = None):
        self._at = None if timeout_s is None else time.monotonic() + timeout_s

    @classmethod
    def at(cls, monotonic_deadline: Optional[float]) -> "Deadline":
        d = cls(None)
        d._at = monotonic_deadline
        return d

    @property
    def unbounded(self) -> bool:
        return self._at is None

    def remaining(self, cap: Optional[float] = None,
                  floor: float = 0.0) -> Optional[float]:
        """Seconds left (>= floor), or ``cap`` / None when unbounded.

        ``cap`` bounds a single step inside the budget (e.g. one socket
        timeout); ``floor`` keeps an almost-expired budget from handing
        a callee a zero/negative timeout it would misread as "forever".
        """
        if self._at is None:
            return cap
        left = max(floor, self._at - time.monotonic())
        return left if cap is None else min(left, cap)

    def expired(self) -> bool:
        return self._at is not None and time.monotonic() >= self._at

    def __repr__(self):
        if self._at is None:
            return "Deadline(unbounded)"
        return f"Deadline({self._at - time.monotonic():.3f}s left)"


class RetryPolicy:
    """Exponential backoff, full jitter, attempt cap, shared deadline.

    ``max_attempts`` counts TRIES (first call included); 0 = unlimited
    (bounded by the deadline alone).  Backoff before retry N (1-based)
    is uniform in ``[0, min(cap_s, base_s * 2**(N-1))]`` — full jitter,
    the variant that decorrelates a thundering herd of retriers (every
    fixed-sleep loop this replaces woke all waiters on the same tick).
    The sleep is additionally clipped to the deadline's remaining
    budget, and a retry that could only start AT the deadline is not
    attempted at all.
    """

    def __init__(self, max_attempts: int = 0, *,
                 base_s: float = DEFAULT_BASE_S,
                 cap_s: float = DEFAULT_CAP_S,
                 deadline: Optional[Deadline] = None,
                 rng: Optional[random.Random] = None):
        if max_attempts < 0:
            raise ValueError("max_attempts must be >= 0 (0 = unlimited)")
        self.max_attempts = max_attempts
        self.base_s = base_s
        self.cap_s = cap_s
        self.deadline = deadline if deadline is not None else Deadline(None)
        self._rng = rng if rng is not None else random

    # -- core decision -----------------------------------------------------

    def next_delay(self, attempt: int) -> Optional[float]:
        """Backoff before retry ``attempt`` (1-based count of FAILED
        tries so far), or None when the policy is exhausted."""
        if self.max_attempts and attempt >= self.max_attempts:
            return None
        if self.deadline.expired():
            return None
        delay = self._rng.uniform(
            0.0, min(self.cap_s, self.base_s * (2 ** (attempt - 1))))
        left = self.deadline.remaining()
        if left is not None:
            if left <= 0:
                return None
            delay = min(delay, left)
        return delay

    def __iter__(self) -> Iterator[int]:
        """Yield attempt numbers 1, 2, ... while the policy allows."""
        attempt = 0
        while True:
            attempt += 1
            if self.max_attempts and attempt > self.max_attempts:
                return
            if attempt > 1 and self.deadline.expired():
                return
            yield attempt

    # -- sleep helpers (loop style) ---------------------------------------

    def sleep(self, attempt: int) -> bool:
        """Back off before retry ``attempt``; False = give up instead."""
        delay = self.next_delay(attempt)
        if delay is None:
            return False
        if delay > 0:
            time.sleep(delay)
        return True

    async def asleep(self, attempt: int) -> bool:
        delay = self.next_delay(attempt)
        if delay is None:
            return False
        if delay > 0:
            await asyncio.sleep(delay)
        return True

    # -- wrapped-call helpers ---------------------------------------------

    def call(self, fn: Callable, *,
             retry_on: Tuple[Type[BaseException], ...] = (ConnectionError,
                                                          TimeoutError)):
        """Run ``fn()`` under this policy; re-raises the last error."""
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except retry_on:
                if not self.sleep(attempt):
                    raise

    async def call_async(self, fn: Callable, *,
                         retry_on: Tuple[Type[BaseException], ...] = (
                             ConnectionError, TimeoutError)):
        """Run ``await fn()`` under this policy; re-raises the last error."""
        attempt = 0
        while True:
            attempt += 1
            try:
                return await fn()
            except retry_on:
                if not await self.asleep(attempt):
                    raise
