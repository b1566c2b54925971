"""Node-to-node object transfer service (reference: object_manager
push/pull).

One :class:`TransferServer` per raylet serves chunked reads of this
node's arena objects over a plain TCP socket: sealed objects stream
straight from the pinned arena view (``sendall`` over memoryview
slices — zero-copy on the holder, no pickle anywhere on the wire), and
spilled objects stream from their spill file without being restored
into the holder's arena.  The receiving side
(:func:`pull_object`) lands chunks directly into a create/seal arena
allocation — the zero-copy OOB put path extended across the wire — so a
cross-node fetch costs one wire copy into shared pages instead of a
pickle round-trip plus per-chunk owner RPCs through the owner's Python
loop (`h_get_object_chunk`, kept as the fallback/oracle path behind
``RT_transfer_service=0``).

Wire protocol (little-endian, fixed framing, connections are reusable):

    request  := b"RTX1" | u8 oid_len | oid bytes
    response := u8 status | u64 size | size raw bytes   (status 1 = hit)

All socket work is blocking and lives on dedicated daemon threads
(server: accept thread + thread per connection, the `_SpillEngine`
idiom) or is driven by callers from executor threads — nothing here may
run on an event loop.

Partial downloads are crash-safe: before landing into an unsealed arena
span the puller drops a ``<oid>.pull.<pid>`` marker next to the arena's
spill dir; :func:`gc_transfer_scratch` (session shutdown, the
``gc_spill_dirs`` owner-pid pattern) aborts spans whose puller died and
removes the markers.
"""

from __future__ import annotations

import os
import re
import socket
import struct
import threading
from typing import Dict, Optional, Tuple

from ray_tpu_torch.common import faults
from ray_tpu_torch.common.config import GLOBAL_CONFIG
from ray_tpu_torch.common.retry import Deadline
from ray_tpu_torch.object_store.shm import (
    _SPILL_MAGIC,
    ShmObjectStore,
    _pid_alive,
    node_shm_name,
)

_MAGIC = b"RTX1"
_RESP = struct.Struct("<BQ")


class TransferError(OSError):
    """The holder broke mid-stream (died, closed, refused) — the caller
    should retry against another location or fall back to the owner."""


class TransferNotFound(KeyError):
    """The holder answered but no longer has the object (freed or
    demoted-and-collected between the directory read and the pull)."""


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None on clean EOF at a message boundary."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            return None if got == 0 else bytes(buf[:got])
        got += r
    return bytes(buf)


def _recv_into_exact(sock: socket.socket, view: memoryview, n: int,
                     chunk: int) -> None:
    """recv_into `view` until n bytes landed, reading at most `chunk`
    per call (bounds the kernel copy window; tests shrink it to force
    multi-chunk transfers)."""
    got = 0
    while got < n:
        want = min(chunk, n - got)
        r = sock.recv_into(view[got:got + want], want)
        if r == 0:
            raise TransferError(
                f"holder closed mid-stream at {got}/{n} bytes")
        got += r


class TransferServer:
    """Per-node socket server streaming this node's objects.

    The arena handle attaches lazily on the first request — the hosting
    raylet starts the server unconditionally, but a node that never
    holds a large object never maps the segment.
    """

    def __init__(self, node_id, host: str = "127.0.0.1",
                 store: Optional[ShmObjectStore] = None):
        self._node_id = node_id
        self._host = host
        self._store = store
        self._store_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._stopped = False
        self.port: Optional[int] = None
        self.stats = {"requests": 0, "hits": 0, "spill_streams": 0,
                      "misses": 0}

    # ------------------------------------------------------------ lifecycle
    def start(self) -> Tuple[str, int]:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._host, 0))
        s.listen(128)
        self._sock = s
        self.port = s.getsockname()[1]
        t = threading.Thread(target=self._accept_loop,
                             name="rt-transfer-accept", daemon=True)
        t.start()
        return (self._host, self.port)

    @property
    def address(self) -> Tuple[str, int]:
        return (self._host, self.port)

    def stop(self) -> None:
        self._stopped = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        with self._store_lock:
            store, self._store = self._store, None
        if store is not None:
            try:
                store.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass

    # --------------------------------------------------------------- store
    def _get_store(self) -> Optional[ShmObjectStore]:
        with self._store_lock:
            if self._store is None and not self._stopped:
                try:
                    self._store = ShmObjectStore(
                        node_shm_name(self._node_id),
                        capacity=GLOBAL_CONFIG.get("shm_store_bytes"))
                except OSError:
                    return None
            return self._store

    # --------------------------------------------------------------- serve
    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed by stop()
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="rt-transfer-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._stopped:
                hdr = _recv_exact(conn, len(_MAGIC) + 1)
                if hdr is None or len(hdr) < len(_MAGIC) + 1 \
                        or hdr[:len(_MAGIC)] != _MAGIC:
                    return
                oid = _recv_exact(conn, hdr[len(_MAGIC)])
                if oid is None:
                    return
                self.stats["requests"] += 1
                self._serve_one(conn, oid)
        except OSError:
            pass  # reader went away mid-stream; nothing to unwind
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _serve_one(self, conn: socket.socket, oid: bytes) -> None:
        # Injected OSError propagates to _serve_conn's handler, which
        # drops the connection — the puller sees a dead holder (EOF
        # before reply), the exact signature of a mid-request crash.
        faults.fault_point("transfer.server.send")
        chunk = GLOBAL_CONFIG.get("transfer_chunk_bytes")
        store = self._get_store()
        view = store.get_pinned(oid) if store is not None else None
        if view is not None:
            try:
                conn.sendall(_RESP.pack(1, len(view)))
                for off in range(0, len(view), chunk):
                    conn.sendall(view[off:off + chunk])
            finally:
                del view  # finalizer drops the pin
            self.stats["hits"] += 1
            return
        if store is not None and store.contains_spilled(oid):
            if self._stream_spill_file(conn, store, oid, chunk):
                self.stats["spill_streams"] += 1
                return
            # compressed on disk or still in the writer queue:
            # read_spilled decompresses / serves the pending bytes —
            # still no arena re-admission on this node
            blob = store.read_spilled(oid)
            if blob is not None:
                conn.sendall(_RESP.pack(1, len(blob)))
                conn.sendall(blob)
                self.stats["spill_streams"] += 1
                return
        self.stats["misses"] += 1
        conn.sendall(_RESP.pack(0, 0))

    @staticmethod
    def _stream_spill_file(conn: socket.socket, store: ShmObjectStore,
                           oid: bytes, chunk: int) -> bool:
        """Stream an UNCOMPRESSED spill file straight from disk (the
        no-local-restore path). False when the file is compressed or
        not on disk yet — the caller falls back to read_spilled."""
        try:
            f = open(store._spill_path(oid), "rb")
        except OSError:
            return False
        with f:
            head = f.read(len(_SPILL_MAGIC))
            if head == _SPILL_MAGIC:
                return False  # compressed: needs read_spilled's codec
            size = os.fstat(f.fileno()).st_size
            conn.sendall(_RESP.pack(1, size))
            if head:
                conn.sendall(head)
            sent = len(head)
            while sent < size:
                data = f.read(min(chunk, size - sent))
                if not data:
                    raise TransferError("spill file truncated under us")
                conn.sendall(data)
                sent += len(data)
        return True


# ---------------------------------------------------------------- client

class _Pull:
    __slots__ = ("done", "result", "exc")

    def __init__(self):
        self.done = threading.Event()
        self.result = None
        self.exc: Optional[BaseException] = None


_inflight: Dict[bytes, _Pull] = {}
_inflight_lock = threading.Lock()
stats = {"downloads": 0, "dedup_waits": 0}


def _marker_path(shm: Optional[ShmObjectStore],
                 oid: bytes) -> Optional[str]:
    d = getattr(shm, "_spill_dir", None) if shm is not None else None
    if not d:
        return None
    return os.path.join(d, f"{oid.hex()}.pull.{os.getpid()}")


def pull_object(address, object_id: bytes,
                shm: Optional[ShmObjectStore] = None,
                timeout: float = 30.0,
                deadline: Optional[Deadline] = None):
    """Fetch one object from a holder's transfer server.

    Returns a pinned read-only arena view when the bytes landed in the
    local arena (create/seal two-phase — same-process AND same-node
    readers then alias the shared pages), else an on-heap memoryview.
    Concurrent pulls of the same id in this process dedupe into ONE
    wire download; followers share the leader's landed view.

    ``deadline`` is the caller's REMAINING budget (common/retry.py);
    every wait in here — follower wait on the leader, connect, socket
    reads — is clipped to it, with ``timeout`` as the per-step cap.
    Without one, ``timeout`` alone bounds each step (the old contract).

    Raises :class:`TransferNotFound` (holder no longer has it) or
    :class:`TransferError` (holder died mid-stream / unreachable /
    budget exhausted) — the caller decides whether another location or
    the owner path is next.
    """
    if deadline is None:
        deadline = Deadline(timeout)
    with _inflight_lock:
        ent = _inflight.get(object_id)
        leader = ent is None
        if leader:
            ent = _inflight[object_id] = _Pull()
    if not leader:
        stats["dedup_waits"] += 1
        try:
            faults.fault_point("transfer.pull.dedup_wait")
        except faults.FaultInjected as e:
            raise TransferError(
                f"deduped pull of {object_id.hex()} from "
                f"{tuple(address)} failed: {e}") from e
        # Follower budget = the FOLLOWER's remaining deadline, not a
        # fixed window: a caller with 2 s left must not block 30 s on a
        # leader working someone else's clock.
        wait_s = deadline.remaining(cap=timeout)
        if not ent.done.wait(wait_s):
            raise TransferError(
                f"deduped pull of {object_id.hex()} from "
                f"{tuple(address)} timed out after {wait_s:.1f}s "
                f"(caller's remaining budget)")
        if ent.exc is not None:
            raise ent.exc
        return ent.result
    try:
        ent.result = _pull_once(tuple(address), object_id, shm, timeout,
                                deadline)
        return ent.result
    except BaseException as e:
        ent.exc = e
        raise
    finally:
        with _inflight_lock:
            _inflight.pop(object_id, None)
        ent.done.set()


def _pull_once(address, object_id: bytes, shm: Optional[ShmObjectStore],
               timeout: float, deadline: Deadline):
    stats["downloads"] += 1
    chunk = GLOBAL_CONFIG.get("transfer_chunk_bytes")
    # floor: an almost-spent budget must surface as a (typed) timeout,
    # never as timeout=0 ("blocking forever" to the socket module)
    budget = deadline.remaining(cap=timeout, floor=0.001)
    try:
        faults.fault_point("transfer.pull.connect")
        sock = socket.create_connection(address, timeout=budget)
    except OSError as e:
        raise TransferError(
            f"transfer server {address} unreachable: {e}") from e
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.sendall(_MAGIC + bytes([len(object_id)]) + object_id)
        faults.fault_point("transfer.pull.recv")
        hdr = _recv_exact(sock, _RESP.size)
        if hdr is None or len(hdr) < _RESP.size:
            raise TransferError(f"holder {address} closed before reply")
        status, size = _RESP.unpack(hdr)
        if status != 1:
            raise TransferNotFound(object_id.hex())
        return _land(sock, object_id, size, shm, chunk)
    except socket.timeout as e:
        raise TransferError(
            f"pull of {object_id.hex()} from {address} timed out "
            f"after {budget:.1f}s") from e
    except TransferError:
        raise
    except OSError as e:
        # torn connection / injected fault mid-pull: type it so callers
        # keep one contract (TransferError = try the next location)
        raise TransferError(
            f"pull of {object_id.hex()} from {address} failed: {e}") from e
    finally:
        sock.close()


def _land(sock: socket.socket, object_id: bytes, size: int,
          shm: Optional[ShmObjectStore], chunk: int):
    buf = None
    if shm is not None and size > 0:
        try:
            buf = shm.create(object_id, size)
        except OSError:
            buf = None
        if buf is None:
            # EEXIST: sealed copy already here (raced another process's
            # pull or a local seal) — just alias it
            existing = shm.get_pinned(object_id)
            if existing is not None and len(existing) == size:
                _drain(sock, size, chunk)
                return existing
    if buf is not None:
        marker = _marker_path(shm, object_id)
        if marker:
            try:
                open(marker, "a").close()
            except OSError:
                marker = None
        sealed = False
        try:
            _recv_into_exact(sock, buf, size, chunk)
            del buf  # drop the writable alias before sealing
            shm.seal(object_id)
            sealed = True
        finally:
            if not sealed:
                try:
                    shm.abort(object_id)
                except Exception:  # noqa: BLE001 — abort is best-effort
                    pass
            if marker:
                try:
                    os.unlink(marker)
                except OSError:
                    pass
        return shm.get_pinned(object_id)
    # no arena (disabled / full / unsized): land on heap, no extra copy
    data = bytearray(size)
    _recv_into_exact(sock, memoryview(data), size, chunk)
    return memoryview(data)


def _drain(sock: socket.socket, size: int, chunk: int) -> None:
    """Consume and discard a response body (duplicate-landing race) so
    the connection stays usable / closes cleanly."""
    sink = bytearray(min(chunk, size) or 1)
    left = size
    while left > 0:
        want = min(len(sink), left)
        r = sock.recv_into(memoryview(sink)[:want], want)
        if r == 0:
            return
        left -= r


# ------------------------------------------------------------------- GC

_MARKER_RE = re.compile(r"^([0-9a-f]+)\.pull\.(\d+)$")


def gc_transfer_scratch(base: Optional[str] = None) -> dict:
    """Reclaim partial-download scratch left by dead pullers: the
    ``<oid>.pull.<pid>`` markers written by :func:`pull_object` before
    landing into an unsealed arena span.  For each marker whose pid is
    dead, the span is aborted in the (shared, still-live) arena and the
    marker removed — the ``gc_spill_dirs`` owner-pid pattern applied to
    transfer temp state.  Spill dirs whose whole segment is gone are
    ``gc_spill_dirs``'s job, not ours."""
    import tempfile

    if base is None:
        base = os.environ.get("RT_object_spilling_dir") or \
            tempfile.gettempdir()
    removed = {"markers": 0, "aborted": 0}
    try:
        names = os.listdir(base)
    except OSError:
        return removed
    for name in names:
        if not name.startswith("rttshm_spill_"):
            continue
        path = os.path.join(base, name)
        try:
            entries = os.listdir(path)
        except OSError:
            continue
        dead = []
        for f in entries:
            m = _MARKER_RE.match(f)
            if m and not _pid_alive(int(m.group(2))):
                dead.append((f, m.group(1)))
        if not dead:
            continue
        store = None
        seg = "/" + name[len("rttshm_spill_"):]
        if os.path.exists("/dev/shm" + seg):
            try:
                store = ShmObjectStore(seg, create=False, spill_dir=None)
            except OSError:
                store = None
        try:
            for f, oid_hex in dead:
                if store is not None:
                    try:
                        store.abort(bytes.fromhex(oid_hex))
                        removed["aborted"] += 1
                    except Exception:  # noqa: BLE001 — sealed/raced: fine
                        pass
                try:
                    os.unlink(os.path.join(path, f))
                    removed["markers"] += 1
                except OSError:
                    pass
        finally:
            if store is not None:
                store.close()
    return removed
