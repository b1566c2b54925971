"""Asyncio RPC layer: framed-message server + multiplexed retryable client.

Fills the role of the reference's gRPC wrappers (src/ray/rpc/grpc_server.h,
grpc_client.h, retryable_grpc_client.h).  Design notes:

- Transport is a length-prefixed pickle envelope over TCP.  We deliberately do
  not use gRPC: the control plane is low-rate, the data plane goes through the
  shared-memory object store, and a single-runtime asyncio stack keeps every
  per-node daemon on one event loop (this box schedules everything on few
  cores; the reference's dedicated poller threads would only add contention).
- Every process runs at most one IO event loop in a background thread
  (:class:`IoContext`), mirroring the reference's instrumented io_context per
  component (src/ray/common/asio/instrumented_io_context.h).  Handler timings
  are recorded for debug dumps.
- ``RetryableRpcClient`` reconnects with exponential backoff until a deadline,
  like retryable_grpc_client.cc, and consults the chaos hooks
  (:mod:`ray_tpu_torch.rpc.chaos`) on every call.
"""

from __future__ import annotations

import asyncio
import itertools
import pickle
import struct
import threading
import time
import traceback
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple

from ray_tpu_torch.common.config import GLOBAL_CONFIG
from ray_tpu_torch.common.retry import Deadline, RetryPolicy
from ray_tpu_torch.common.status import RtConnectionError, RtTimeoutError
from . import chaos

_HEADER = struct.Struct("<IB")  # payload length, frame type
_FRAME_REQ = 1
_FRAME_RESP = 2
_FRAME_HELLO = 3  # version handshake (rpc/protocol.py)

# schema.validate, bound on first validated dispatch (schema imports parts
# of common/ that import this module — a boot-time cycle, not a real dep)
_validate = None

Address = Tuple[str, int]


class RpcError(RtConnectionError):
    pass


class RpcProtocolError(RpcError):
    """Version negotiation failed — NOT retryable (a peer speaking an
    incompatible protocol will not heal on reconnect)."""


class RpcMethodNotFound(RpcError):
    """Peer answered but doesn't serve this method — NOT retryable on the
    same connection (an unpromoted GCS standby looks exactly like this;
    rotating clients treat it as "not the leader, try the next address")."""


class RpcRetriesExhausted(RtTimeoutError):
    """Reconnect-with-backoff burned the whole per-address deadline — the
    peer is dead at the transport level, not merely slow.  Distinct from a
    plain per-call RtTimeoutError (slow-but-alive handler) so failover
    clients rotate only on the former."""


class RemoteMethodError(Exception):
    """Handler raised; carries the remote traceback."""

    def __init__(self, method: str, cause: BaseException, tb: str):
        self.method = method
        self.cause = cause
        self.tb = tb
        super().__init__(f"RPC handler {method!r} raised {cause!r}\n--- remote ---\n{tb}")


async def _read_frame(reader: asyncio.StreamReader):
    header = await reader.readexactly(_HEADER.size)
    length, ftype = _HEADER.unpack(header)
    body = await reader.readexactly(length)
    return ftype, pickle.loads(body)


def _write_frame(writer: asyncio.StreamWriter, ftype: int, msg: Any):
    body = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    writer.write(_HEADER.pack(len(body), ftype) + body)


class IoContext:
    """One background asyncio loop per process, shared by all clients/servers.

    Sync code submits coroutines with :meth:`run`; async code just uses the
    loop directly.  Named-handler timing stats mimic the reference's
    event_stats.cc so `debug_state` dumps show where loop time goes.
    """

    _singleton: Optional["IoContext"] = None
    _singleton_lock = threading.Lock()

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, name="rt-io", daemon=True)
        self.stats: Dict[str, Tuple[int, float]] = {}
        self._stats_lock = threading.Lock()
        self._thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    @classmethod
    def current(cls) -> "IoContext":
        with cls._singleton_lock:
            if cls._singleton is None or not cls._singleton._thread.is_alive():
                cls._singleton = cls()
            return cls._singleton

    def run(self, coro: Awaitable, timeout: Optional[float] = None):
        """Block the calling (non-loop) thread on a coroutine."""
        import concurrent.futures as cf

        cfut: cf.Future = cf.Future()
        task_box: list = []

        def _do():
            task = self.spawn(coro)
            task_box.append(task)

            def _copy(t: asyncio.Task):
                if t.cancelled():
                    cfut.cancel()
                elif t.exception() is not None:
                    cfut.set_exception(t.exception())
                else:
                    cfut.set_result(t.result())

            task.add_done_callback(_copy)

        self.loop.call_soon_threadsafe(_do)
        try:
            return cfut.result(timeout)
        except cf.TimeoutError:
            if cfut.done():
                # TimeoutError raised BY the coroutine (cf.TimeoutError is
                # builtins.TimeoutError since 3.8): propagate it untouched
                # instead of mislabeling it as run()'s own wait expiring.
                raise
            # don't leave the coroutine running (and its side effects live)
            # after the caller has taken the timeout path
            self.loop.call_soon_threadsafe(
                lambda: task_box and task_box[0].cancel())
            raise RtTimeoutError(f"rpc timed out after {timeout}s")
        except cf.CancelledError:
            raise RtTimeoutError("operation cancelled")

    # The event loop holds only WEAK references to tasks; any fire-and-forget
    # task must be pinned here or the GC can destroy it mid-await ("Task was
    # destroyed but it is pending!"), silently dropping RPCs.
    _pinned_tasks: set = set()

    def spawn(self, coro) -> "asyncio.Task":
        """ensure_future with a strong reference for the task's lifetime.
        Must be called from the loop thread."""
        task = asyncio.ensure_future(coro)
        IoContext._pinned_tasks.add(task)
        task.add_done_callback(IoContext._pinned_tasks.discard)
        return task

    def spawn_threadsafe(self, coro):
        """Spawn from any thread; fire-and-forget."""
        def _do():
            self.spawn(coro)
        self.loop.call_soon_threadsafe(_do)

    def record(self, name: str, elapsed: float):
        with self._stats_lock:
            count, total = self.stats.get(name, (0, 0.0))
            self.stats[name] = (count + 1, total + elapsed)


def _schema_validation_enabled() -> bool:
    """Wire-contract validation (rpc/schema.py). Reads the config registry
    each time — GLOBAL_CONFIG caches internally and reset_cache()/
    system_config propagation must be able to flip the knob at runtime
    (a process-global cache here would pin the boot-time value)."""
    try:
        return bool(GLOBAL_CONFIG.get("rpc_schema_validation"))
    except Exception:  # noqa: BLE001
        return True


class RpcServer:
    """Registers async handlers by method name; serves framed requests.

    Handlers: ``async def handler(**kwargs) -> result``.  Results/exceptions
    are pickled back.  One connection carries many concurrent requests.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 validate_schemas: bool = True):
        self.host = host
        self.port = port
        # Core services share one method namespace with the wire-schema
        # table; servers whose methods collide by NAME but not by contract
        # (e.g. the ray:// session driver's create_actor) opt out.
        self.validate_schemas = validate_schemas
        self._handlers: Dict[str, Callable[..., Awaitable[Any]]] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._io = IoContext.current()
        self._conns: set = set()
        self._stopping = False

    def register(self, method: str, handler: Callable[..., Awaitable[Any]]):
        self._handlers[method] = handler

    def register_service(self, service: object, prefix: str = ""):
        """Register every public async method of `service`."""
        for name in dir(service):
            if name.startswith("_"):
                continue
            fn = getattr(service, name)
            if callable(fn) and asyncio.iscoroutinefunction(fn):
                self.register(prefix + name, fn)

    @property
    def address(self) -> Address:
        return (self.host, self.port)

    def start(self):
        self._io.run(self._start())

    async def _start(self):
        self._stopping = False
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        if self._stopping:
            # accepted before stop() closed the listener, handler run after
            # it closed the known connections: wait_closed() would wait on
            # this one for as long as the peer keeps it open
            writer.close()
            return
        self._conns.add(writer)
        write_lock = asyncio.Lock()
        # a connection whose first frame is a REQ (no HELLO) is a legacy
        # peer: served as protocol 1 (rpc/protocol.py rolling-upgrade path)
        peer_protocol = 1
        try:
            while True:
                ftype, msg = await _read_frame(reader)
                if ftype == _FRAME_HELLO:
                    from ray_tpu_torch.rpc import protocol as _proto

                    from ray_tpu_torch.rpc.schema import SCHEMA_VERSION

                    hello = {"protocol": _proto.PROTOCOL_VERSION,
                             "min_protocol": _proto.MIN_SUPPORTED_PROTOCOL,
                             "schema": SCHEMA_VERSION}
                    try:
                        peer_protocol = _proto.negotiate(
                            int(msg.get("protocol", 1)),
                            int(msg.get("min_protocol", 1)))
                    except _proto.ProtocolError as e:
                        hello["error"] = str(e)
                        async with write_lock:
                            _write_frame(writer, _FRAME_HELLO, hello)
                            await writer.drain()
                        return  # finally: close the incompatible peer
                    async with write_lock:
                        _write_frame(writer, _FRAME_HELLO, hello)
                        await writer.drain()
                    continue
                if ftype != _FRAME_REQ:
                    continue
                self._io.spawn(
                    self._dispatch(msg, writer, write_lock, peer_protocol))
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, msg: dict, writer: asyncio.StreamWriter,
                        write_lock: asyncio.Lock, peer_protocol: int = 1):
        req_id, method, kwargs = msg["id"], msg["method"], msg["kwargs"]
        start = time.monotonic()
        handler = self._handlers.get(method)
        if handler is None:
            reply = {"id": req_id, "error": ("nomethod", f"unknown method {method!r}", "")}
        else:
            try:
                if self.validate_schemas and _schema_validation_enabled():
                    global _validate
                    if _validate is None:
                        from ray_tpu_torch.rpc.schema import validate as _validate
                    # the request's own stamp (if any) can only lower the
                    # connection-negotiated version, never raise it
                    v = min(peer_protocol, int(msg.get("v", peer_protocol)))
                    kwargs = _validate(method, kwargs, peer_protocol=v)
                result = await handler(**kwargs)
                reply = {"id": req_id, "result": result}
            except Exception as e:  # noqa: BLE001 - handler errors go to caller
                reply = {"id": req_id, "error": ("raised", e, traceback.format_exc())}
        self._io.record(f"rpc.{method}", time.monotonic() - start)
        async with write_lock:
            try:
                _write_frame(writer, _FRAME_RESP, reply)
                await writer.drain()
            except (ConnectionError, OSError) as e:
                import logging
                logging.getLogger(__name__).warning("reply write for %s failed: %s", method, e)
            except Exception:  # unpicklable result/exception: degrade to string
                try:
                    detail = repr(reply.get("result", reply.get("error")))
                    _write_frame(
                        writer,
                        _FRAME_RESP,
                        {"id": req_id, "error": ("unserializable", detail, "")},
                    )
                    await writer.drain()
                except (ConnectionError, OSError):
                    pass

    def stop(self):
        if self._server is not None:
            self._io.run(self._stop())

    async def _stop(self):
        assert self._server is not None
        self._stopping = True
        self._server.close()
        for w in list(self._conns):
            try:
                w.close()
            except Exception:
                pass
        await self._server.wait_closed()
        self._server = None


class RpcClient:
    """Single-connection multiplexed client. Not retryable; see RetryableRpcClient."""

    def __init__(self, address: Address):
        self.address = tuple(address)
        self._io = IoContext.current()
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._ids = itertools.count(1)
        self._conn_lock: Optional[asyncio.Lock] = None
        self._write_lock: Optional[asyncio.Lock] = None
        self._hello_fut: Optional[asyncio.Future] = None
        # what this connection speaks after negotiation (protocol.py)
        self.negotiated_protocol: Optional[int] = None

    async def _ensure_connected(self):
        if self._conn_lock is None:
            self._conn_lock = asyncio.Lock()
            self._write_lock = asyncio.Lock()
        async with self._conn_lock:
            if self._writer is not None:
                return
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(*self.address),
                    GLOBAL_CONFIG.get("rpc_connect_timeout_s"),
                )
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                raise RpcError(f"connect to {self.address} failed: {e}") from e
            self._writer = writer
            self._io.spawn(self._read_loop(reader))
            await self._handshake(writer)

    async def _handshake(self, writer: asyncio.StreamWriter):
        """First frames on the wire: HELLO out, HELLO back (protocol.py).
        Completes before any request is written.

        A pre-handshake (protocol-1) server drops the unknown HELLO frame
        without replying.  With ``rpc_require_hello=False`` (rolling-
        upgrade mode) a HELLO timeout on an otherwise-live connection is
        therefore read as "legacy peer" and the connection degrades to
        protocol 1 (the new-client→old-server half of the contract;
        old-client→new-server is the server's REQ-first path), remembered
        so reconnects skip the wait.  By default the flag is True and the
        timeout is a transport failure — a wedged-but-accepting NEW server
        must keep triggering retry/rotation (GCS failover), not a silent
        permanent downgrade."""
        from ray_tpu_torch.rpc import protocol as _proto

        if getattr(self, "_peer_is_legacy", False):
            self.negotiated_protocol = 1
            return
        self._hello_fut = asyncio.get_running_loop().create_future()
        try:
            from ray_tpu_torch.rpc.schema import SCHEMA_VERSION

            _write_frame(writer, _FRAME_HELLO,
                         {"protocol": _proto.PROTOCOL_VERSION,
                          "min_protocol": _proto.MIN_SUPPORTED_PROTOCOL,
                          "schema": SCHEMA_VERSION})
            await writer.drain()
            hello = await asyncio.wait_for(
                self._hello_fut, GLOBAL_CONFIG.get("rpc_connect_timeout_s"))
        except asyncio.TimeoutError as e:
            if not GLOBAL_CONFIG.get("rpc_require_hello"):
                # rolling-upgrade mode: live connection, no HELLO back —
                # assume legacy protocol-1 server
                self._peer_is_legacy = True
                self.negotiated_protocol = 1
                self._hello_fut = None
                return
            self._fail_all(RpcError(f"handshake with {self.address} failed"))
            raise RpcError(
                f"handshake with {self.address} timed out: {e}") from e
        except (ConnectionError, OSError) as e:
            self._fail_all(RpcError(f"handshake with {self.address} failed"))
            raise RpcError(
                f"handshake with {self.address} failed: {e}") from e
        finally:
            self._hello_fut = None
        if "error" in hello:
            self._fail_all(RpcProtocolError(str(hello["error"])))
            raise RpcProtocolError(
                f"protocol negotiation with {self.address} failed: "
                f"{hello['error']}")
        try:
            self.negotiated_protocol = _proto.negotiate(
                int(hello.get("protocol", 1)),
                int(hello.get("min_protocol", 1)))
        except _proto.ProtocolError as e:
            raise RpcProtocolError(
                f"protocol negotiation with {self.address} failed: {e}"
            ) from e

    async def _read_loop(self, reader: asyncio.StreamReader):
        try:
            while True:
                ftype, msg = await _read_frame(reader)
                if ftype == _FRAME_HELLO:
                    fut = self._hello_fut
                    if fut is not None and not fut.done():
                        fut.set_result(msg)
                    continue
                fut = self._pending.pop(msg["id"], None)
                if fut is not None and not fut.done():
                    if "error" in msg:
                        kind, cause, tb = msg["error"]
                        if kind == "raised" and isinstance(cause, BaseException):
                            fut.set_exception(RemoteMethodError(msg.get("method", "?"), cause, tb))
                        elif kind == "nomethod":
                            # typed so callers (and the retry loop) can tell
                            # "peer doesn't serve this" from transport failure
                            fut.set_exception(RpcMethodNotFound(str(cause)))
                        else:
                            fut.set_exception(RpcError(f"{kind}: {cause}"))
                    else:
                        fut.set_result(msg.get("result"))
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            self._fail_all(RpcError(f"connection to {self.address} lost: {e}"))
        except Exception as e:  # noqa: BLE001 - corrupt frame: surface loudly
            import logging
            logging.getLogger(__name__).exception("read loop died: %s", e)
            self._fail_all(RpcError(f"read loop on {self.address} died: {e}"))

    def _fail_all(self, exc: Exception):
        self._writer = None
        hello = self._hello_fut
        if hello is not None and not hello.done():
            hello.set_exception(exc)
        pending, self._pending = self._pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(exc)

    async def call_async(self, method: str, timeout: Optional[float] = None, **kwargs):
        fail_req, fail_resp = chaos.maybe_inject_failure(method)
        if fail_req:
            raise chaos.RpcChaosError(f"injected request failure for {method}")
        await self._ensure_connected()
        req_id = next(self._ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        async with self._write_lock:
            writer = self._writer
            if writer is None:  # connection died while we awaited the lock
                self._pending.pop(req_id, None)
                raise RpcError(f"connection to {self.address} lost before write")
            try:
                _write_frame(writer, _FRAME_REQ,
                             {"id": req_id, "method": method,
                              "kwargs": kwargs,
                              "v": self.negotiated_protocol or 1})
                await writer.drain()
            except (ConnectionError, OSError) as e:
                self._pending.pop(req_id, None)
                self._fail_all(RpcError(f"write to {self.address} failed: {e}"))
                raise RpcError(f"write to {self.address} failed: {e}") from e
        try:
            result = await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            self._pending.pop(req_id, None)
            raise RtTimeoutError(f"rpc {method} to {self.address} timed out")
        except BaseException:  # incl. outer cancellation: don't leak the pending slot
            self._pending.pop(req_id, None)
            raise
        if fail_resp:
            raise chaos.RpcChaosError(f"injected response failure for {method}")
        return result

    def call(self, method: str, timeout: Optional[float] = None, **kwargs):
        return self._io.run(self.call_async(method, timeout=timeout, **kwargs), timeout)

    def close(self):
        writer, self._writer = self._writer, None
        if writer is not None:
            def _close():
                try:
                    writer.close()
                except Exception:
                    pass
            self._io.loop.call_soon_threadsafe(_close)


class RetryableRpcClient:
    """Retries connection-level failures with exponential backoff until a
    deadline (reference: retryable_grpc_client.cc).  Handler-raised exceptions
    are NOT retried — they are application errors."""

    def __init__(self, address: Address, max_attempts: int = 1 << 30, deadline_s: Optional[float] = None,
                 abort_check=None):
        self.address = tuple(address)
        self._client = RpcClient(address)
        self._max_attempts = max_attempts
        # Bounded by default: without a deadline, a dead peer would otherwise
        # be retried forever (reference bounds this with
        # gcs_rpc_server_reconnect_timeout_s).
        if deadline_s is None:
            deadline_s = float(GLOBAL_CONFIG.get("gcs_rpc_server_reconnect_timeout_s"))
        self._deadline_s = deadline_s
        # Optional async predicate consulted after each connection-level
        # failure: True = the peer is confirmed permanently gone (e.g. its
        # raylet reaped the process), so reconnecting cannot help — fail
        # now instead of burning the remaining deadline.
        self._abort_check = abort_check

    async def call_async(self, method: str, timeout: Optional[float] = None, **kwargs):
        policy = RetryPolicy(
            base_s=GLOBAL_CONFIG.get("rpc_retry_base_ms") / 1000.0,
            cap_s=GLOBAL_CONFIG.get("rpc_retry_max_ms") / 1000.0,
            deadline=Deadline(self._deadline_s))
        attempt = 0
        while True:
            try:
                return await self._client.call_async(method, timeout=timeout, **kwargs)
            except (RpcProtocolError, RpcMethodNotFound):
                raise  # neither heals on reconnect to the same peer
            except (RpcError, chaos.RpcChaosError) as e:
                attempt += 1
                if attempt >= self._max_attempts:
                    raise
                if self._abort_check is not None and await self._abort_check(e):
                    raise
                if not await policy.asleep(attempt):
                    # per-address reconnect budget spent: typed so failover
                    # clients rotate and plain callers see "peer is dead"
                    raise RpcRetriesExhausted(
                        f"rpc {method} retries exhausted: {e}") from e
                self._client.close()
                self._client = RpcClient(self.address)

    def call(self, method: str, timeout: Optional[float] = None, **kwargs):
        return IoContext.current().run(self.call_async(method, timeout=timeout, **kwargs))

    def close(self):
        self._client.close()
