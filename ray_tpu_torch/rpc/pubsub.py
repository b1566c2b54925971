"""Long-poll pub/sub (reference: src/ray/pubsub/publisher.h, subscriber.h).

The publisher keeps a bounded mailbox per subscriber; subscribers long-poll
(`pubsub_poll`) and receive message batches.  Used for object location
updates, actor state changes, node events, and log streams — anywhere the
control plane pushes state to many listeners without a persistent stream.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.common import faults

from .rpc import IoContext, RetryableRpcClient, RpcError, RpcServer

_MAILBOX_CAP = 10_000


class Publisher:
    """Server-side half. Attach to an RpcServer with :meth:`attach`."""

    def __init__(self):
        # subscriber_id -> channel -> set of keys (empty set = all keys)
        self._subs: Dict[str, Dict[str, set]] = defaultdict(dict)
        self._mail: Dict[str, List[tuple]] = defaultdict(list)
        self._wakeups: Dict[str, asyncio.Event] = {}
        self._lock = threading.Lock()
        # wakeup coalescing: a burst of publishes (batched actor ALIVEs,
        # resource gossip) schedules ONE loop callback that fires every
        # pending subscriber event, instead of one call_soon_threadsafe
        # (pipe write + loop iteration) per message per subscriber
        self._pending_wakeups: set = set()
        self._wakeup_scheduled = False

    def attach(self, server: RpcServer, prefix: str = "pubsub_"):
        server.register(prefix + "subscribe", self._handle_subscribe)
        server.register(prefix + "unsubscribe", self._handle_unsubscribe)
        server.register(prefix + "poll", self._handle_poll)

    async def _handle_subscribe(self, subscriber_id: str, channel: str, key: Optional[str] = None):
        with self._lock:
            keys = self._subs[subscriber_id].setdefault(channel, set())
            if key is not None:
                keys.add(key)
        return True

    async def _handle_unsubscribe(self, subscriber_id: str, channel: Optional[str] = None):
        with self._lock:
            if channel is None:
                self._subs.pop(subscriber_id, None)
                self._mail.pop(subscriber_id, None)
                self._wakeups.pop(subscriber_id, None)
            else:
                self._subs.get(subscriber_id, {}).pop(channel, None)
        return True

    async def _handle_poll(self, subscriber_id: str, timeout: float = 30.0):
        with self._lock:
            known = subscriber_id in self._subs
        if not known:
            # Publisher restarted (GCS failover) and lost the subscription
            # table; the poller must re-issue its subscribes before messages
            # can flow again.
            return "__resubscribe__"
        event = self._wakeups.setdefault(subscriber_id, asyncio.Event())
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                batch = self._mail.pop(subscriber_id, [])
            if batch:
                return batch
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return []
            event.clear()
            try:
                await asyncio.wait_for(event.wait(), remaining)
            except asyncio.TimeoutError:
                return []

    def publish(self, channel: str, key: str, message: Any):
        """Thread-safe; deliver to all subscribers matching (channel, key)."""
        try:
            faults.fault_point("pubsub.publish")
        except faults.FaultInjected:
            # a lost control-plane event, not a raised one: publishers
            # are fire-and-forget, so the fault manifests as listeners
            # simply never hearing this message (they must converge via
            # polling / later events, never hang on one publish)
            return
        with self._lock:
            targets = []
            for sub_id, channels in self._subs.items():
                keys = channels.get(channel)
                if keys is None:
                    continue
                if keys and key not in keys:
                    continue
                box = self._mail[sub_id]
                if len(box) < _MAILBOX_CAP:
                    box.append((channel, key, message))
                targets.append(sub_id)
            if not targets:
                return
            self._pending_wakeups.update(targets)
            if self._wakeup_scheduled:
                return  # a flush is already on its way: ride it
            self._wakeup_scheduled = True
        IoContext.current().loop.call_soon_threadsafe(self._flush_wakeups)

    def _flush_wakeups(self):
        with self._lock:
            targets = self._pending_wakeups
            self._pending_wakeups = set()
            self._wakeup_scheduled = False
        for sub_id in targets:
            ev = self._wakeups.get(sub_id)
            if ev is not None:
                ev.set()


class Subscriber:
    """Client-side half: background long-poll loop dispatching to callbacks."""

    def __init__(self, subscriber_id: str, address: Tuple[str, int], prefix: str = "pubsub_"):
        self.subscriber_id = subscriber_id
        self._prefix = prefix
        self._client = RetryableRpcClient(address)
        self._callbacks: Dict[str, Callable[[str, Any], None]] = {}
        self._keys: Dict[str, Optional[str]] = {}
        self._stopped = threading.Event()
        self._task = None
        self._io = IoContext.current()
        # Callbacks run on a dedicated thread (ordered), never on the shared IO
        # loop — a blocking callback must not stall every RPC in the process.
        import queue as _queue

        self._dispatch_q: "_queue.Queue" = _queue.Queue()
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._dispatcher.start()

    def _dispatch_loop(self):
        while True:
            item = self._dispatch_q.get()
            if item is None:
                return
            cb, key, message = item
            try:
                cb(key, message)
            except Exception:  # noqa: BLE001 - subscriber callbacks must not kill the loop
                import logging

                logging.getLogger(__name__).exception("pubsub callback failed")

    def subscribe(self, channel: str, callback: Callable[[str, Any], None], key: Optional[str] = None):
        self._callbacks[channel] = callback
        self._keys[channel] = key
        self._client.call(self._prefix + "subscribe", subscriber_id=self.subscriber_id, channel=channel, key=key)
        if self._task is None:
            self._task = True
            self._io.spawn_threadsafe(self._poll_loop())

    async def _poll_loop(self):
        from ray_tpu_torch.common.retry import RetryPolicy

        backoff = RetryPolicy(base_s=0.2, cap_s=1.0)  # unbounded attempts:
        failures = 0  # a subscriber must outlive any publisher outage
        while not self._stopped.is_set():
            try:
                batch = await self._client.call_async(
                    self._prefix + "poll", subscriber_id=self.subscriber_id, timeout=35.0
                )
                failures = 0
            except Exception:  # noqa: BLE001 - keep polling through transient failures
                if self._stopped.is_set():
                    return
                failures += 1
                await backoff.asleep(failures)
                continue
            if batch == "__resubscribe__":
                # publisher restarted: replay every subscription, then poll
                for channel in list(self._callbacks):
                    try:
                        await self._client.call_async(
                            self._prefix + "subscribe",
                            subscriber_id=self.subscriber_id,
                            channel=channel, key=self._keys.get(channel))
                    except Exception:  # noqa: BLE001
                        break
                await asyncio.sleep(0.05)
                continue
            for channel, key, message in batch or []:
                cb = self._callbacks.get(channel)
                if cb is not None:
                    self._dispatch_q.put((cb, key, message))

    def close(self):
        self._stopped.set()
        self._dispatch_q.put(None)
        self._client.close()
