"""Serve ingress proxies: HTTP and gRPC.

Reference: ``python/ray/serve/_private/proxy.py`` (``HTTPProxy:696`` ASGI,
``gRPCProxy:520``, ``ProxyActor:1008``) with route-table push via long-poll
(``long_poll.py``). Here the proxy is an async actor:

- HTTP/1.1 server on asyncio streams (no external web framework): requests
  are parsed into a picklable :class:`Request`, routed by a prebuilt
  longest-prefix matcher to a :class:`DeploymentHandle`, and the replica's
  return value is rendered (str/bytes/dict/Response).
  ``Accept: text/event-stream`` switches to SSE streaming.
- The data plane is ASYNC-NATIVE (round 11): dispatch awaits the replica
  reply on the proxy's own event loop via ``get_async`` — no thread-pool
  hop, no executor thread parked in a blocking ``get`` per request.  SSE
  rides the streaming-generator protocol push-first (items wake the loop
  directly; ``writer.drain`` backpressures a slow client through the
  owner-side generator backpressure to the replica), with the submit/poll
  protocol kept only as a fallback for pre-generator replicas.
- Per-stage latency accounting (route/queue/replica/render/write) feeds
  ``util/metrics`` histograms and the actor's ``debug_state()``; the
  ``executor_hops`` counter proves the hot path takes zero
  ``run_in_executor`` hops.
- gRPC server (grpc.aio, generic handler — no compiled protos): unary call
  to ``/<app>/<method>`` with a pickled ``(args, kwargs)`` payload, reply is
  the pickled return value.
- The route table is version-stamped; the proxy long-polls the controller
  (``listen_for_route_table``) so redeploys propagate promptly without a
  hot refresh loop.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import json
import logging
import math
import pickle
import time
import urllib.parse
from typing import Any, Dict, List, Optional, Tuple

# hoisted off the per-request path: a `from ray_tpu_torch.api import ...`
# inside the handler costs ~10µs of import machinery per call at proxy
# request rates (no cycle: ray_tpu_torch.api never imports serve)
from ray_tpu_torch.api import get_async
from ray_tpu_torch.common import faults
from ray_tpu_torch.common.status import ActorDiedError, TaskError
from ray_tpu_torch.serve.controller import _ItemError

logger = logging.getLogger(__name__)

PROXY_NAME = "SERVE_PROXY"


@dataclasses.dataclass
class Request:
    """Picklable HTTP request passed to deployment callables."""

    method: str
    path: str
    query: Dict[str, str]
    headers: Dict[str, str]
    body: bytes

    def json(self) -> Any:
        return json.loads(self.body or b"null")

    @property
    def text(self) -> str:
        return self.body.decode("utf-8", "replace")


@dataclasses.dataclass
class Response:
    """Explicit response: deployments may return one for full control."""

    body: Any = b""
    status: int = 200
    content_type: str = "application/octet-stream"
    headers: Optional[Dict[str, str]] = None


class SSEBatch(list):
    """Several SSE data events in ONE streamed item.

    A deployment's ``stream`` generator may yield ``SSEBatch([...])`` to
    amortize the per-item report RPC of the streaming-generator protocol
    when it produces in bursts (the LLM engine emits every token decoded
    since the last poll): the proxy renders one ``data:`` event per
    element and ships them in a single coalesced write.  A plain ``list``
    yield stays ONE event whose payload is the list."""


def _render(result: Any) -> Tuple[int, str, bytes, Dict[str, str]]:
    """Map a deployment return value onto (status, content-type, body)."""
    if isinstance(result, Response):
        body = result.body
        if isinstance(body, str):
            body = body.encode()
        elif not isinstance(body, (bytes, bytearray)):
            body = json.dumps(body).encode()
        return (result.status, result.content_type, bytes(body),
                result.headers or {})
    if isinstance(result, (bytes, bytearray)):
        return 200, "application/octet-stream", bytes(result), {}
    if isinstance(result, str):
        return 200, "text/plain; charset=utf-8", result.encode(), {}
    return 200, "application/json", json.dumps(result).encode(), {}


# Request/Response cross the proxy→replica boundary on EVERY request;
# registering them as plain-safe keeps them on the C pickler (both
# classes are framework-owned, so pickle's by-reference class encoding is
# importable in every worker).  Unregistered, the serializer's whitelist
# walk fails on the dataclass and falls back to cloudpickle's
# Python-level pickler — measured ~70µs per request on the proxy loop.
def _register_plain_safe_types():
    from ray_tpu_torch.core_worker import serialization as _ser

    _ser.register_plain_safe(
        Request, lambda v, budget: _ser._plain_safe(vars(v), budget=budget))
    _ser.register_plain_safe(
        Response, lambda v, budget: _ser._plain_safe(vars(v), budget=budget))
    _ser.register_plain_safe(
        SSEBatch, lambda v, budget: _ser._plain_safe(list(v), budget=budget))


_register_plain_safe_types()


class _BadRequest(Exception):
    """Parse-level rejection: (status, message) to answer before closing
    the connection — malformed bytes must produce a response, never an
    unhandled exception that kills the connection silently."""

    def __init__(self, status: int, message: bytes):
        self.status = status
        self.message = message
        super().__init__(message)


class _StageClock:
    """Per-request stage timer: ``lap(stage)`` records the time since the
    previous lap under that stage name."""

    __slots__ = ("stats", "t0", "last")

    def __init__(self, stats: "_StageStats"):
        self.stats = stats
        self.t0 = time.perf_counter()
        self.last = self.t0

    def lap(self, stage: str) -> None:
        now = time.perf_counter()
        self.stats.observe(stage, now - self.last)
        self.last = now

    def skip(self) -> None:
        """Reset the lap origin without recording (the elapsed span was
        accounted elsewhere, e.g. by the batcher's queue/replica laps)."""
        self.last = time.perf_counter()

    def finish(self) -> None:
        self.stats.observe("total", time.perf_counter() - self.t0)


class _StageStats:
    """Per-stage latency accounting for the request hot path.

    Feeds two sinks: the process metrics registry (``util/metrics``
    histogram ``rt_serve_stage_seconds`` + counters, scrapable via
    ``prometheus_text``/``collect_cluster_metrics``) and bounded local
    sample buffers that ``ProxyActor.debug_state`` turns into percentiles.
    ``executor_hops`` counts every ``run_in_executor`` hop the request
    path takes — the async-native contract is that it stays ZERO; tests
    assert on it."""

    STAGES = ("route", "queue", "replica", "render", "write", "total")

    def __init__(self):
        from ray_tpu_torch.util.metrics import Counter, Histogram

        self._hist = Histogram(
            "rt_serve_stage_seconds",
            "per-stage proxy request latency",
            boundaries=[0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                        0.1, 0.25, 1.0, 5.0],
            tag_keys=("stage",))
        self._requests_total = Counter(
            "rt_serve_requests_total", "requests dispatched by the proxy")
        self._shed_counter = Counter(
            "rt_serve_shed_total",
            "requests shed by admission control before dispatch",
            tag_keys=("status",))
        self._hops_counter = Counter(
            "rt_serve_executor_hops_total",
            "run_in_executor hops taken on the proxy request path "
            "(async-native contract: zero)")
        self.requests = 0
        self.executor_hops = 0
        self.shed: Dict[int, int] = collections.Counter()
        self.stream_protocols: Dict[str, int] = collections.Counter()
        self.batch_sizes: Dict[int, int] = collections.Counter()
        self._samples: Dict[str, collections.deque] = {
            s: collections.deque(maxlen=4096) for s in self.STAGES}

    def clock(self) -> _StageClock:
        self.requests += 1
        self._requests_total.inc()
        return _StageClock(self)

    def observe(self, stage: str, elapsed: float) -> None:
        self._hist.observe(elapsed, tags={"stage": stage})
        buf = self._samples.get(stage)
        if buf is not None:
            buf.append(elapsed)

    def count_executor_hop(self) -> None:
        self.executor_hops += 1
        self._hops_counter.inc()

    def count_shed(self, status: int) -> None:
        self.shed[status] += 1
        self._shed_counter.inc(tags={"status": str(status)})

    def snapshot(self) -> Dict[str, Any]:
        stages = {}
        for stage, buf in self._samples.items():
            if not buf:
                continue
            ordered = sorted(buf)
            n = len(ordered)
            stages[stage] = {
                "count": n,
                "p50_ms": round(ordered[n // 2] * 1000, 3),
                "p99_ms": round(ordered[min(n - 1, (n * 99) // 100)]
                                * 1000, 3),
            }
        return {"requests": self.requests,
                "executor_hops": self.executor_hops,
                "shed": {str(k): v for k, v in sorted(self.shed.items())},
                "stream_protocols": dict(self.stream_protocols),
                "batch_sizes": {str(k): v
                                for k, v in sorted(self.batch_sizes.items())},
                "stages": stages}


class _RouteMatcher:
    """Prebuilt route table: exact-prefix dict hit first, then prefixes
    longest-first (built ONCE per route-table version — the per-request
    cost is a dict lookup, not an iteration over every route)."""

    __slots__ = ("exact", "prefixes", "root")

    def __init__(self, routes: Dict[str, Any]):
        self.exact: Dict[str, Tuple[str, Any]] = {}
        self.prefixes: List[Tuple[str, str, Any]] = []
        self.root: Optional[Tuple[str, Any]] = None
        for prefix, handle in routes.items():
            norm = prefix.rstrip("/") or "/"
            if norm == "/":
                self.root = ("/", handle)
                continue
            self.exact[norm] = (norm, handle)
            self.prefixes.append((norm + "/", norm, handle))
        self.prefixes.sort(key=lambda t: len(t[0]), reverse=True)

    def match(self, path: str) -> Optional[Tuple[str, Any]]:
        hit = self.exact.get(path)
        if hit is not None:
            return hit
        for pref, norm, handle in self.prefixes:
            if path.startswith(pref):
                return (norm, handle)
        return self.root


class _Admission:
    """Per-route admission control + load shedding.

    The proxy answers overload BEFORE dispatch, so excess traffic never
    reaches a replica and accepted-traffic p99 stays flat.  The budget is
    ``capacity + queue``: capacity is ``max_ongoing_requests × healthy
    replicas`` from the handle's router view (which the controller's
    health probes and the data plane's ``mark_dead`` keep current), and
    queue is sized from the route's replica-latency EWMA (the batcher's)
    so admitted-but-queued work clears within ``QUEUE_WAIT_BUDGET_S`` —
    bounding how far past an unloaded p99 an accepted request can land.

    Past the budget: a typed ``503`` with ``Retry-After`` derived from
    the same EWMA, or ``429`` when at least two clients compete and this
    one already holds its fair share of the budget (single-client
    overload is plain overload, not a fairness violation).  All counters
    live on the proxy's event loop — no lock.
    """

    __slots__ = ("handle", "inflight", "per_client", "shed_503", "shed_429")

    QUEUE_WAIT_BUDGET_S = 0.2

    def __init__(self, handle):
        self.handle = handle
        self.inflight = 0
        self.per_client: Dict[str, int] = {}
        self.shed_503 = 0
        self.shed_429 = 0

    def budget(self) -> Tuple[int, int, float]:
        """(budget, capacity, ewma_s) from the live router view."""
        state = self.handle._state
        with state.lock:
            n = len(state.replicas)
            max_ongoing = state.max_ongoing
        capacity = max(1, max_ongoing) * max(1, n)
        batcher = getattr(self.handle, "_proxy_batcher", None)
        ewma = batcher.ewma if batcher is not None else 0.0
        if ewma <= self.QUEUE_WAIT_BUDGET_S:  # fast (or cold) route
            queue = capacity
        else:  # slow route: only as much queue as clears in the budget
            queue = max(1, int(capacity * self.QUEUE_WAIT_BUDGET_S / ewma))
        return capacity + queue, capacity, ewma

    def try_admit(self, client: str):
        """``None`` admits (and counts) the request; otherwise returns
        ``(status, retry_after_s, body)`` to answer without dispatching."""
        budget, capacity, ewma = self.budget()
        if self.inflight < budget:
            self.inflight += 1
            self.per_client[client] = self.per_client.get(client, 0) + 1
            return None
        retry_after = max(1, math.ceil(ewma * self.inflight / capacity))
        n_clients = len(self.per_client)
        if n_clients >= 2:
            fair = max(1, budget // n_clients)
            if self.per_client.get(client, 0) >= fair:
                self.shed_429 += 1
                return (429, retry_after,
                        b"over per-client fair share; retry later")
        self.shed_503 += 1
        return (503, retry_after, b"deployment over capacity; retry later")

    def release(self, client: str) -> None:
        self.inflight = max(0, self.inflight - 1)
        left = self.per_client.get(client, 0) - 1
        if left <= 0:
            self.per_client.pop(client, None)
        else:
            self.per_client[client] = left

    def snapshot(self) -> Dict[str, Any]:
        budget, capacity, ewma = self.budget()
        return {"inflight": self.inflight, "budget": budget,
                "capacity": capacity, "ewma_ms": round(ewma * 1000, 3),
                "clients": len(self.per_client),
                "shed_503": self.shed_503, "shed_429": self.shed_429}


class _Batcher:
    """Per-route request coalescing (round 11, the PR-7 'fewer crossings'
    pattern applied to the data plane): while one actor call is in
    flight, every request that arrives queues here, and the next drain
    ships the WHOLE queue as one ``handle_request_batch`` call — the
    per-call submit/reply machinery (task spec, seq bookkeeping, framing,
    reply wake) amortizes across the batch.  An idle route pays nothing:
    the first request of a quiet period submits immediately with batch
    size 1 over the ordinary single-call path.  Batch size is capped at
    the deployment's ``max_ongoing_requests`` and the replica harness
    runs items concurrently on a pool of that same width, so blocking
    handlers keep the latency profile of independent calls.

    Batchmates share fate on TIMING (the call returns when the slowest
    item finishes) and on transport failure/timeout (all answer 500);
    only user exceptions are isolated per item (``_ItemError``).  That
    trade only pays where per-call overhead dominates, so coalescing is
    ADAPTIVE: an EWMA of the replica turnaround above
    ``BYPASS_LATENCY_S`` flips the route to independent per-request
    dispatch (slow handlers gain nothing from amortizing ~0.3ms of
    submit cost and would suffer head-of-line waits), and flips back
    when the route is fast again.  Batches dispatch on up to
    ``len(replicas)`` concurrent lanes, so a multi-replica route keeps
    cross-replica parallelism (one lane per replica-sized batch; a
    single-replica route pipelines exactly one batch at a time)."""

    __slots__ = ("handle", "stats", "queue", "inflight", "ewma", "_tasks")

    BYPASS_LATENCY_S = 0.05

    def __init__(self, handle, stats: _StageStats):
        self.handle = handle
        self.stats = stats
        self.queue: collections.deque = collections.deque()
        self.inflight = 0         # drain lanes currently running
        self.ewma = 0.0
        self._tasks: set = set()  # pinned: the loop's refs are weak

    def _note_latency(self, dt: float) -> None:
        self.ewma = dt if self.ewma == 0.0 else 0.8 * self.ewma + 0.2 * dt

    async def call(self, req: Request):
        if self.ewma > self.BYPASS_LATENCY_S:
            return await self._call_single(req)
        fut = asyncio.get_running_loop().create_future()
        self.queue.append((req, fut, time.perf_counter()))
        self._maybe_spawn_lane()
        return await fut

    def _maybe_spawn_lane(self):
        """Start another drain lane when work is queued and a lane is
        free — lane count is bounded by the replica count so a
        multi-replica route dispatches batches in parallel (pow2 routing
        spreads them) while a single replica pipelines one at a time."""
        lanes = max(1, len(self.handle._state.replicas))
        if not self.queue or self.inflight >= lanes:
            return
        self.inflight += 1
        # pin the task (the IoContext lesson: the loop holds only a weak
        # reference; a GC'd drainer strands every queued future)
        task = asyncio.get_running_loop().create_task(self._drain())
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _call_single(self, req: Request):
        """Slow-route path: independent dispatch, no shared fate, no
        head-of-line wait behind an in-flight batch."""
        t0 = time.perf_counter()
        results, submit_t = await self._call_batch([req])
        done_t = time.perf_counter()
        self.stats.observe("queue", submit_t - t0)
        self.stats.observe("replica", done_t - submit_t)
        self.stats.batch_sizes[1] += 1
        self._note_latency(done_t - submit_t)
        return results[0]

    async def _drain(self):
        try:
            while self.queue:
                cap = max(1, self.handle._state.max_ongoing)
                batch = []
                while self.queue and len(batch) < cap:
                    batch.append(self.queue.popleft())
                self._maybe_spawn_lane()  # leftovers + a free lane: parallel
                self.stats.batch_sizes[len(batch)] += 1
                try:
                    results, submit_t = await self._call_batch(
                        [item[0] for item in batch])
                except Exception as e:  # noqa: BLE001 — whole batch failed
                    for _, fut, _enq in batch:
                        if not fut.done():
                            fut.set_exception(e)
                    continue
                done_t = time.perf_counter()
                self._note_latency(done_t - submit_t)
                if len(results) < len(batch):  # defensive: short reply
                    for _, fut, _enq in batch[len(results):]:
                        if not fut.done():
                            fut.set_exception(RuntimeError(
                                "batched reply shorter than the batch"))
                for (req, fut, enq_t), res in zip(batch, results):
                    self.stats.observe("queue", submit_t - enq_t)
                    self.stats.observe("replica", done_t - submit_t)
                    if fut.done():
                        continue
                    if isinstance(res, _ItemError):
                        fut.set_exception(res.error)
                    else:
                        fut.set_result(res)
        finally:
            self.inflight -= 1

    async def _call_batch(self, reqs: List[Request]):
        handle = self.handle
        for attempt in range(3):
            # A replica can die between routing and execution (downscale
            # drain timeout, crash) or fail with a transport-typed error
            # (ConnectionError — injected faults included): re-route the
            # WHOLE batch to a fresh replica like the reference router
            # does, so one dead replica never fails batchmates.
            if len(reqs) == 1:
                ref = await handle.remote_async(reqs[0])
            else:
                ref = await handle.remote_batch_async(
                    [((r,), {}) for r in reqs])
            submit_t = time.perf_counter()
            try:
                out = await get_async(ref, timeout=120.0)
                return (out if len(reqs) > 1 else [out]), submit_t
            except (ActorDiedError, ConnectionError, TaskError) as e:
                if isinstance(e, TaskError) and not isinstance(
                        getattr(e, "cause", None), ConnectionError):
                    raise  # a user exception — 500 is correct, no retry
                # a ConnectionError raised INSIDE the replica harness
                # (injected faults included) crosses the object plane
                # wrapped as TaskError(cause=ConnectionError): transport
                # is suspect either way, so re-route like a dead replica
                if attempt == 2:
                    raise
                dead = getattr(e, "actor_id", None)
                if dead is not None:
                    # the data plane saw the corpse before the controller
                    # did: update the router-local health view so the
                    # retry cannot land on the same dead replica
                    handle._state.mark_dead(dead)
                await handle._state.refresh_async(force=True)


class ProxyActor:
    """Ingress actor: one per cluster by default (reference ProxyActor)."""

    # request bodies buffer in the proxy before dispatch; bound them like
    # every other input dimension (413 past this)
    MAX_BODY_BYTES = 64 << 20

    def __init__(self, http_host: str = "127.0.0.1", http_port: int = 0,
                 grpc_port: Optional[int] = None):
        self._http_host = http_host
        self._http_port = http_port
        self._grpc_port = grpc_port
        self._routes: Dict[str, Any] = {}       # route_prefix -> handle
        self._matcher = _RouteMatcher({})
        self._route_version = -1
        self._server: Optional[asyncio.AbstractServer] = None
        self._grpc_server = None
        self._started = asyncio.Event()
        self._starting = False
        self._stats = _StageStats()
        # replica actor id -> supports_generator_stream (one probe RPC per
        # replica, not one per stream)
        self._gen_support: Dict[bytes, bool] = {}

    # -------------------------------------------------------------- control
    async def start(self) -> Dict[str, Any]:
        """Bind servers; returns the bound addresses. Idempotent: a second
        caller racing the first gets the already-bound address."""
        if self._server is not None or self._starting:
            await self._started.wait()
            return self.address()
        self._starting = True  # set before ANY await: guards double-bind
        self._install_hop_counter()
        try:
            self._server = await asyncio.start_server(
                self._handle_conn, self._http_host, self._http_port)
            self._http_port = self._server.sockets[0].getsockname()[1]
            await self._refresh_routes()
            if self._grpc_port is not None:
                await self._start_grpc()
        except BaseException:
            # a failed bind must not wedge every future start() behind
            # an event that will never be set
            self._starting = False
            if self._server is not None:
                self._server.close()
                self._server = None
            raise
        # pin the task: the loop holds only weak references (the IoContext
        # lesson) and a GC'd poll loop would silently freeze the route table
        self._poll_task = asyncio.get_running_loop().create_task(
            self._route_poll_loop())
        self._started.set()
        logger.info("serve proxy: http on %s:%d grpc on %s",
                    self._http_host, self._http_port, self._grpc_port)
        return {"http_host": self._http_host, "http_port": self._http_port,
                "grpc_port": self._grpc_port}

    def _install_hop_counter(self):
        """Wrap this loop's ``run_in_executor`` so EVERY executor hop
        taken on the proxy's event loop increments ``executor_hops``.
        This is what makes the zero-hop acceptance test non-vacuous: a
        future change that sneaks a thread hop back into the dispatch
        path (directly or through a helper awaited on this loop) moves
        the counter, instead of the counter being a constant 0 that
        nothing ever writes."""
        loop = asyncio.get_running_loop()
        # always (re)point at THIS proxy's stats: a restarted proxy on the
        # same worker loop must not leave the counter wired to a dead
        # predecessor's stats object (that would make it a constant zero)
        loop._rt_hop_stats = self._stats
        if getattr(loop, "_rt_hop_counted", False):
            return
        orig = loop.run_in_executor

        def counted(executor, func, *args):
            stats = getattr(loop, "_rt_hop_stats", None)
            if stats is not None:
                stats.count_executor_hop()
            return orig(executor, func, *args)

        loop.run_in_executor = counted
        loop._rt_hop_counted = True

    def address(self) -> Dict[str, Any]:
        return {"http_host": self._http_host, "http_port": self._http_port,
                "grpc_port": self._grpc_port}

    def num_requests(self) -> int:
        return self._stats.requests

    def debug_state(self) -> Dict[str, Any]:
        """Per-stage latency percentiles + executor-hop count (reference:
        proxy state in serve debug dumps).  The ``executor_hops`` field is
        the zero-threadpool acceptance hook: it counts every
        ``run_in_executor`` hop the request path took."""
        state = self._stats.snapshot()
        state["route_version"] = self._route_version
        state["routes"] = {p: h._name for p, h in self._routes.items()}
        state["admission"] = {
            p: h._proxy_admission.snapshot()
            for p, h in self._routes.items()
            if getattr(h, "_proxy_admission", None) is not None}
        return state

    async def stop(self) -> bool:
        if self._server is not None:
            self._server.close()
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=1.0)
        return True

    # ---------------------------------------------------------- route table
    def _controller(self):
        from ray_tpu_torch.serve.api import _get_or_create_controller

        return _get_or_create_controller()

    async def _refresh_routes(self):
        from ray_tpu_torch.serve.handle import DeploymentHandle

        controller = self._controller()
        version, table = await get_async(
            controller.get_route_table.remote(), timeout=30.0)
        if version != self._route_version:
            self._routes = {
                prefix: DeploymentHandle(app_name, controller)
                for prefix, app_name in table.items()}
            self._matcher = _RouteMatcher(self._routes)
            self._route_version = version

    async def _route_poll_loop(self):
        """Long-poll the controller: returns promptly on version change,
        every ~15 s otherwise (reference long_poll.py)."""
        controller = self._controller()
        while self._server is not None and self._server.is_serving():
            try:
                await get_async(
                    controller.listen_for_route_table.remote(
                        self._route_version), timeout=60.0)
                await self._refresh_routes()
            except Exception:  # noqa: BLE001 — controller restarting
                await asyncio.sleep(1.0)

    def _match_route(self, path: str):
        """Longest-prefix route match over the prebuilt matcher."""
        return self._matcher.match(path)

    # ------------------------------------------------------------- http
    async def _read_request(self, reader: asyncio.StreamReader
                            ) -> Optional[Tuple[Request, bool]]:
        """Parse ONE request off the connection at the bytes level.

        Returns ``(request, keep_alive)``, ``None`` at end-of-stream, or
        raises :class:`_BadRequest` — malformed input (bad request line,
        non-UTF-8 header bytes, unparsable content-length, chunked
        transfer-encoding) gets an error RESPONSE, never a silently
        killed connection."""
        line = await reader.readline()
        if not line or line in (b"\r\n", b"\n"):
            return None
        parts = line.rstrip(b"\r\n").split(b" ")
        if len(parts) != 3:
            raise _BadRequest(400, b"bad request line")
        try:
            method = parts[0].decode("ascii")
            target = parts[1].decode("ascii")
        except UnicodeDecodeError:
            raise _BadRequest(400, b"bad request line") from None
        http10 = parts[2] == b"HTTP/1.0"
        headers: Dict[str, str] = {}
        while True:
            hline = await reader.readline()
            if hline in (b"\r\n", b"\n", b""):
                break
            name_b, sep, value_b = hline.partition(b":")
            if not sep:
                raise _BadRequest(400, b"bad header line")
            try:
                name = name_b.decode("ascii").strip().lower()
                value = value_b.decode("utf-8").strip()
            except UnicodeDecodeError:
                raise _BadRequest(400, b"bad header encoding") from None
            headers[name] = value
        if "chunked" in headers.get("transfer-encoding", "").lower():
            # explicit rejection beats dispatching a silently-empty body
            raise _BadRequest(501, b"chunked transfer-encoding "
                                   b"not supported")
        try:
            length = int(headers.get("content-length", "0") or "0")
            if length < 0:
                raise ValueError
        except ValueError:
            raise _BadRequest(400, b"bad content-length") from None
        if length > self.MAX_BODY_BYTES:
            # every other input dimension is bounded; an unbounded body
            # would let one request buffer the ingress actor to death
            raise _BadRequest(413, b"body too large")
        body = await reader.readexactly(length) if length else b""
        parsed = urllib.parse.urlsplit(target)
        query = dict(urllib.parse.parse_qsl(parsed.query))
        req = Request(method=method.upper(), path=parsed.path,
                      query=query, headers=headers, body=body)
        conn_tok = headers.get("connection", "").lower()
        keep_alive = (conn_tok == "keep-alive") if http10 \
            else (conn_tok != "close")
        return req, keep_alive

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        """Connection loop: requests are served strictly in order, so a
        client may PIPELINE requests on one keep-alive connection and
        responses come back in request order (HTTP/1.1 semantics)."""
        try:
            while True:
                try:
                    parsed = await self._read_request(reader)
                except _BadRequest as e:
                    # the framing is no longer trustworthy: answer, then
                    # close THIS connection — the listener stays healthy
                    await self._write_simple(writer, e.status, e.message)
                    return
                except ValueError:
                    # a line over the stream reader's limit (readline
                    # raises) — still a malformed request, still answered
                    await self._write_simple(writer, 400,
                                             b"request line/header too long")
                    return
                if parsed is None:
                    return
                req, keep_alive = parsed
                await self._dispatch(req, writer)
                if not keep_alive:
                    return
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _dispatch(self, req: Request, writer: asyncio.StreamWriter):
        if req.path == "/-/routes":  # reference exposes the route table
            table = {p: h._name for p, h in self._routes.items()}
            await self._write_response(
                writer, 200, "application/json", json.dumps(table).encode())
            return
        if req.path == "/-/healthz":
            await self._write_response(writer, 200, "text/plain", b"ok")
            return
        clock = self._stats.clock()
        match = self._match_route(req.path)
        if match is None:
            await self._refresh_routes()
            match = self._match_route(req.path)
        clock.lap("route")
        if match is None:
            await self._write_simple(writer, 404, b"no matching route")
            clock.finish()  # failed requests must not vanish from 'total'
            return
        prefix, handle = match
        admission = getattr(handle, "_proxy_admission", None)
        if admission is None:
            admission = _Admission(handle)
            handle._proxy_admission = admission
        client = req.headers.get("x-client-id") or self._peer_key(writer)
        try:
            # the budget reads capacity off the router view; refresh it
            # first (a cached no-op within REFRESH_INTERVAL_S) so
            # admission tracks `max_ongoing × healthy replicas`, not the
            # cold-handle default
            await handle._state.refresh_async()
        except Exception:  # noqa: BLE001 — stale view beats failing closed
            pass
        shed = admission.try_admit(client)
        if shed is not None:
            # Load shedding happens HERE, before any dispatch work: the
            # replica never sees the request, so accepted traffic keeps
            # its latency profile while excess gets a typed answer.
            status, retry_after, msg = shed
            self._stats.count_shed(status)
            await self._write_response(writer, status, "text/plain", msg,
                                       {"retry-after": str(retry_after)})
            clock.finish()
            return
        try:
            if req.headers.get("accept") == "text/event-stream":
                await self._dispatch_stream(req, handle, writer, clock)
                return
            batcher = getattr(handle, "_proxy_batcher", None)
            if batcher is None:
                batcher = _Batcher(handle, self._stats)
                handle._proxy_batcher = batcher
            try:
                # Dispatch + reply wait are awaits on THIS loop — no thread
                # hop, no blocking get; concurrent arrivals coalesce into one
                # batched actor call (the batcher records queue/replica laps).
                result = await batcher.call(req)
            except Exception as e:  # noqa: BLE001 — replica/user error → 500
                await self._write_response(
                    writer, 500, "text/plain",
                    f"deployment error: {e}".encode()[:4096])
                # tail latency during incidents must include the failures —
                # a 'total' computed only from successes understates exactly
                # when it matters
                clock.finish()
                return
            clock.skip()
            status, ctype, body, extra = _render(result)
            clock.lap("render")
            await self._write_response(writer, status, ctype, body, extra)
            clock.lap("write")
            clock.finish()
        finally:
            # SSE streams hold their admission slot for the whole stream
            # life (they run inside this try), so long streams count
            # toward the route budget exactly like in-flight unary calls.
            admission.release(client)

    @staticmethod
    def _peer_key(writer: asyncio.StreamWriter) -> str:
        """Fair-share client identity: explicit ``x-client-id`` header
        wins (set by trusted edge LBs); otherwise the peer address."""
        peer = writer.get_extra_info("peername")
        return peer[0] if isinstance(peer, tuple) else str(peer)

    # --------------------------------------------------------------- sse
    async def _replica_supports_generator(self, replica) -> bool:
        key = replica._actor_id.binary()
        cached = self._gen_support.get(key)
        if cached is not None:
            return cached
        try:
            supports = await get_async(
                replica.supports_generator_stream.remote(), timeout=30.0)
        except Exception:  # noqa: BLE001 — older replica OR a transient
            # probe failure: use the poll protocol for THIS stream but do
            # NOT cache, or one slow probe would pin a push-capable
            # replica to the poll path for the proxy's lifetime
            return False
        if len(self._gen_support) > 4096:
            self._gen_support.clear()  # bound the cache across redeploys
        self._gen_support[key] = supports
        return supports

    async def _dispatch_stream(self, req: Request, handle,
                               writer: asyncio.StreamWriter,
                               clock: _StageClock):
        """SSE streaming.  Replicas exposing a generator ``stream`` method
        ride the streaming-generator protocol — PUSH-based: each item
        wakes this loop directly and ``drain`` backpressure propagates a
        slow client to the replica.  The submit/poll protocol survives
        only as a fallback for pre-generator replicas."""
        # Sticky routing: the stream must hit ONE replica for its whole
        # life (generator state / request id live in that replica).
        await handle._state.refresh_async()
        acquired = handle._state.acquire_replica()
        if acquired is None:
            await self._write_response(writer, 500, "text/plain",
                                       b"no running replicas")
            return
        replica, ridx = acquired
        clock.lap("queue")
        try:
            if await self._replica_supports_generator(replica):
                self._stats.stream_protocols["generator"] += 1
                await self._stream_via_generator(req, replica, writer)
            else:
                self._stats.stream_protocols["poll"] += 1
                await self._stream_via_poll(req, replica, writer)
        finally:
            handle._state.release(ridx)
            clock.lap("replica")
            clock.finish()

    async def _stream_via_generator(self, req, replica,
                                    writer: asyncio.StreamWriter):
        gen = replica.handle_request_stream.options(
            num_returns="streaming").remote((req,), {})
        try:
            writer.write(b"HTTP/1.1 200 OK\r\n"
                         b"content-type: text/event-stream\r\n"
                         b"cache-control: no-cache\r\n"
                         b"transfer-encoding: chunked\r\n\r\n")
            await writer.drain()
            # push path: __anext__ parks on the stream state and the
            # producer's report wakes this loop; awaiting drain() before
            # the next item is the client-side backpressure that (via the
            # owner's delayed report replies) throttles the replica
            async for ref in gen:
                chunk = await get_async(ref, timeout=60.0)
                if isinstance(chunk, SSEBatch):
                    await self._write_chunks(
                        writer,
                        [b"data: " + json.dumps(c).encode() + b"\n\n"
                         for c in chunk])
                else:
                    await self._write_chunk(
                        writer,
                        b"data: " + json.dumps(chunk).encode() + b"\n\n")
            await self._write_chunk(writer, b"data: [DONE]\n\n")
        except (ConnectionError, OSError):
            gen.close()  # consumer gone: cancel the stream at the replica
            return
        except Exception as e:  # noqa: BLE001
            try:
                await self._write_chunk(
                    writer,
                    b"event: error\ndata: " + str(e).encode() + b"\n\n")
            except Exception:  # noqa: BLE001
                pass
        try:
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        except Exception:  # noqa: BLE001
            pass

    async def _stream_via_poll(self, req, replica,
                               writer: asyncio.StreamWriter):
        """Legacy submit/poll protocol (pre-generator replicas): the
        deployment implements ``submit(request) -> req_id`` and
        ``poll(req_id) -> {"chunks": [...], "done": bool}``."""
        try:
            req_id = await get_async(
                replica.handle_request.remote("submit", (req,), {}),
                timeout=60.0)
        except Exception as e:  # noqa: BLE001
            await self._write_response(
                writer, 500, "text/plain",
                f"stream submit failed: {e}".encode()[:4096])
            return
        try:
            writer.write(b"HTTP/1.1 200 OK\r\n"
                         b"content-type: text/event-stream\r\n"
                         b"cache-control: no-cache\r\n"
                         b"transfer-encoding: chunked\r\n\r\n")
            await writer.drain()
            while True:
                out = await get_async(
                    replica.handle_request.remote("poll", (req_id,), {}),
                    timeout=60.0)
                for chunk in out.get("chunks", ()):
                    payload = json.dumps(chunk).encode()
                    await self._write_chunk(
                        writer, b"data: " + payload + b"\n\n")
                if out.get("done"):
                    await self._write_chunk(writer, b"data: [DONE]\n\n")
                    break
                await asyncio.sleep(0.02)
        except (ConnectionError, OSError):
            return
        except Exception as e:  # noqa: BLE001
            try:
                await self._write_chunk(
                    writer, b"event: error\ndata: " + str(e).encode() + b"\n\n")
            except Exception:  # noqa: BLE001
                pass
        try:
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        except Exception:  # noqa: BLE001
            pass

    @staticmethod
    async def _write_chunk(writer: asyncio.StreamWriter, data: bytes):
        faults.fault_point("serve.proxy.write")
        writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        await writer.drain()

    _REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
                413: "Payload Too Large", 429: "Too Many Requests",
                500: "Internal Server Error", 501: "Not Implemented",
                503: "Service Unavailable"}

    @classmethod
    async def _write_response(cls, writer: asyncio.StreamWriter, status: int,
                              ctype: str, body: bytes,
                              extra: Optional[Dict[str, str]] = None):
        # FaultInjected is a ConnectionError: an injected write fault
        # tears THIS connection (the conn loop's handler closes it) and
        # nothing else — the listener and other connections stay healthy.
        faults.fault_point("serve.proxy.write")
        # ONE coalesced write per response (head + body in a single
        # buffer hand-off); drain is a no-op below the transport
        # high-water mark, so pipelined small responses never stall here
        reason = cls._REASONS.get(status, "OK")
        head = [f"HTTP/1.1 {status} {reason}",
                f"content-type: {ctype}",
                f"content-length: {len(body)}"]
        for k, v in (extra or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        await writer.drain()

    @staticmethod
    async def _write_simple(writer, status: int, msg: bytes):
        await ProxyActor._write_response(writer, status, "text/plain", msg)

    @staticmethod
    async def _write_chunks(writer: asyncio.StreamWriter, parts: List[bytes]):
        """Several SSE events, ONE buffer hand-off + drain."""
        buf = bytearray()
        for data in parts:
            buf += f"{len(data):x}\r\n".encode() + data + b"\r\n"
        writer.write(bytes(buf))
        await writer.drain()

    # ------------------------------------------------------------- grpc
    async def _start_grpc(self):
        """Generic unary gRPC ingress: /<app>/<method>, pickled payloads
        (reference gRPCProxy:520 serves user protos; we stay proto-less).
        Same async-native dispatch as HTTP: no executor hop."""
        import grpc

        proxy = self

        class Generic(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                path = handler_call_details.method  # "/<app>/<method>"

                async def unary(request_bytes, context):
                    _, app, method = path.split("/", 2)
                    handle = None
                    for prefix, h in proxy._routes.items():
                        if h._name == app or prefix.strip("/") == app:
                            handle = h
                            break
                    if handle is None:
                        await proxy._refresh_routes()
                        for prefix, h in proxy._routes.items():
                            if h._name == app or prefix.strip("/") == app:
                                handle = h
                                break
                    if handle is None:
                        # outside any try: abort signals by raising and must
                        # not be re-wrapped as INTERNAL
                        await context.abort(grpc.StatusCode.NOT_FOUND,
                                            f"no deployment {app!r}")
                    try:
                        args, kwargs = pickle.loads(request_bytes) \
                            if request_bytes else ((), {})
                        ref = await handle.options(method).remote_async(
                            *args, **kwargs)
                        result = await get_async(ref, timeout=120.0)
                        return pickle.dumps(result)
                    except Exception as e:  # noqa: BLE001
                        await context.abort(grpc.StatusCode.INTERNAL, str(e))

                return grpc.unary_unary_rpc_method_handler(
                    unary,
                    request_deserializer=lambda b: b,
                    response_serializer=lambda b: b)

        from grpc import aio as grpc_aio

        self._grpc_server = grpc_aio.server()
        self._grpc_server.add_generic_rpc_handlers((Generic(),))
        bound = self._grpc_server.add_insecure_port(
            f"{self._http_host}:{self._grpc_port or 0}")
        self._grpc_port = bound
        await self._grpc_server.start()
