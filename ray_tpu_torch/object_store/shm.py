"""ctypes binding for the native shared-memory object store.

Builds ``libshm_store.so`` on first use (g++ is in the image; the build is
cached in ``ray_tpu_torch/_build/``, written to a temporary file that
replaces the target). ``get()`` returns a zero-copy memoryview over
the shared pages — numpy arrays deserialize without a copy, the plasma
property that matters for feeding accelerator hosts.
"""

from __future__ import annotations

import collections
import ctypes
import os
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.common.status import SpillFailedError

_SRC_DIR = os.path.join(os.path.dirname(__file__), "native")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_build_lock = threading.Lock()
_lib = None


def build_native(src_name: str, so_name: str) -> str:
    """``native/<src_name>`` built by g++ into ``_build/<so_name>`` unless
    that is newer than the source; returns the library's path. Also
    builds the compiled graphs' channel (``graph/channels.py``)."""
    src = os.path.join(_SRC_DIR, src_name)
    so_path = os.path.join(_BUILD_DIR, so_name)
    with _build_lock:
        if (not os.path.exists(so_path)
                or os.path.getmtime(so_path) < os.path.getmtime(src)):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = so_path + f".tmp.{os.getpid()}"
            subprocess.run(
                ["g++", "-O2", "-fPIC", "-shared", "-std=c++17",
                 "-o", tmp, src, "-lpthread", "-lrt"],
                check=True, capture_output=True)
            os.replace(tmp, so_path)  # atomic: concurrent builds race ok
    return so_path


def _ensure_built() -> str:
    return build_native("shm_store.cc", "libshm_store.so")


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_ensure_built())
    lib.rts_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.rts_create.restype = ctypes.c_int
    lib.rts_open.argtypes = [ctypes.c_char_p]
    lib.rts_open.restype = ctypes.c_int
    lib.rts_put.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32,
                            ctypes.c_char_p, ctypes.c_uint64]
    lib.rts_put.restype = ctypes.c_int
    lib.rts_get.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32,
                            ctypes.POINTER(ctypes.c_uint64)]
    lib.rts_get.restype = ctypes.POINTER(ctypes.c_ubyte)
    lib.rts_create_unsealed.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                        ctypes.c_uint32, ctypes.c_uint64]
    lib.rts_create_unsealed.restype = ctypes.POINTER(ctypes.c_ubyte)
    for name in ("rts_seal", "rts_abort"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32]
        fn.restype = ctypes.c_int
    for name in ("rts_release", "rts_contains", "rts_delete"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32]
        fn.restype = ctypes.c_int
    lib.rts_release_addr.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_uint32, ctypes.c_void_p]
    lib.rts_release_addr.restype = ctypes.c_int
    lib.rts_stats.argtypes = [ctypes.c_int] + \
        [ctypes.POINTER(ctypes.c_uint64)] * 3
    lib.rts_stats.restype = ctypes.c_int
    lib.rts_set_autoevict.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.rts_set_autoevict.restype = ctypes.c_int
    lib.rts_lru_candidate.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32)]
    lib.rts_lru_candidate.restype = ctypes.c_int
    lib.rts_lru_candidates.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint32, ctypes.c_uint64]
    lib.rts_lru_candidates.restype = ctypes.c_int
    lib.rts_unlink.argtypes = [ctypes.c_char_p]
    lib.rts_unlink.restype = ctypes.c_int
    lib.rts_close.argtypes = [ctypes.c_int]
    lib.rts_close.restype = ctypes.c_int
    _lib = lib
    return lib


# ------------------------------------------------------- spill engine

# Compressed spill file framing: raw (legacy) files carry no header;
# compressed files are  MAGIC | method byte | u64 raw_len | payload.
# The magic cannot collide with real payloads: spilled values are either
# pickle blobs (b"\x80...") or serialization frames (b"RTB5...").
_SPILL_MAGIC = b"RTSPL1"
_SPILL_METHODS: Dict[int, str] = {1: "zlib", 2: "lz4", 3: "zstd"}


def _resolve_codec(name: str):
    """``(method_byte, compress, decompress)`` for a codec name, or
    ``None`` for no compression.  lz4/zstd are optional deps — gated on
    import, with ``auto`` falling back lz4 → zstd → zlib (zlib is
    stdlib and always present)."""
    name = (name or "none").lower()
    if name in ("", "none", "0", "off"):
        return None
    if name in ("lz4", "auto"):
        try:
            import lz4.frame as _l4

            return (2, _l4.compress, _l4.decompress)
        except ImportError:
            if name == "lz4":
                raise ValueError("RT_spill_compression=lz4 but the lz4 "
                                 "package is not installed")
    if name in ("zstd", "auto"):
        try:
            import zstandard as _zs

            cctx, dctx = _zs.ZstdCompressor(level=1), _zs.ZstdDecompressor()
            return (3, cctx.compress,
                    lambda b, _d=dctx: _d.decompress(b))
        except ImportError:
            if name == "zstd":
                raise ValueError("RT_spill_compression=zstd but the "
                                 "zstandard package is not installed")
    if name in ("zlib", "auto"):
        import zlib as _zl

        return (1, lambda b: _zl.compress(b, 1), _zl.decompress)
    raise ValueError(f"unknown RT_spill_compression {name!r}")


def _decompress_spill(blob: bytes) -> bytes:
    """Decode a spill file: framed-compressed or raw legacy bytes."""
    if len(blob) < 15 or blob[:6] != _SPILL_MAGIC:
        return blob
    method = _SPILL_METHODS.get(blob[6])
    import struct as _struct

    raw_len = _struct.unpack_from("<Q", blob, 7)[0]
    payload = blob[15:]
    if method == "zlib":
        import zlib as _zl

        out = _zl.decompress(payload)
    elif method == "lz4":
        import lz4.frame as _l4

        out = _l4.decompress(payload)
    elif method == "zstd":
        import zstandard as _zs

        out = _zs.ZstdDecompressor().decompress(payload,
                                                max_output_size=raw_len)
    else:
        raise SpillFailedError(f"spill file with unknown codec {blob[6]}")
    if len(out) != raw_len:
        raise SpillFailedError(
            f"spill decompress length mismatch: {len(out)} != {raw_len}")
    return out


_spill_metrics = None
_spill_metrics_lock = threading.Lock()


def _metrics():
    """Process-wide spill counters (util/metrics; surfaced through the
    workers' metric push + raylet debug_state)."""
    global _spill_metrics
    if _spill_metrics is None:
        with _spill_metrics_lock:
            if _spill_metrics is None:
                from ray_tpu_torch.util import metrics as M

                _spill_metrics = {
                    "spilled": M.Counter(
                        "rt_spill_bytes_spilled",
                        "bytes demoted to the spill dir (pre-compression)"),
                    "written": M.Counter(
                        "rt_spill_bytes_written",
                        "bytes physically written to spill files"),
                    "restored": M.Counter(
                        "rt_spill_bytes_restored",
                        "bytes read back from spill files (post-decompress)"),
                    "pending_hits": M.Counter(
                        "rt_spill_pending_hits",
                        "reads served from the writer queue before the "
                        "disk write landed"),
                    "prefetch_hits": M.Counter(
                        "rt_spill_prefetch_hits",
                        "restores served from the readahead cache"),
                    "prefetch_misses": M.Counter(
                        "rt_spill_prefetch_misses",
                        "restores that had to touch disk"),
                    "failures": M.Counter(
                        "rt_spill_failures", "failed spill writes"),
                    "dropped": M.Counter(
                        "rt_spill_files_dropped",
                        "spill files unlinked (batched)"),
                    "queue_depth": M.Gauge(
                        "rt_spill_writer_queue_depth",
                        "objects waiting in the spill writer queue"),
                    "queue_bytes": M.Gauge(
                        "rt_spill_writer_queue_bytes",
                        "bytes waiting in the spill writer queue"),
                }
    return _spill_metrics


class _SpillEngine:
    """Async spill I/O for one spill dir: a dedicated writer thread takes
    demotions off the caller's thread (the putting worker used to pay a
    synchronous open+write+rename per victim), a reader thread services
    announced-order readahead into a bounded cache, and unlinks batch.

    Correctness contract: a value handed to :meth:`submit` is readable
    via :meth:`read` from that moment on — first from the in-memory
    pending map, then from the file once the writer lands it.  A failed
    write KEEPS the bytes in the pending map (never lose the primary
    copy) and surfaces as a typed :class:`SpillFailedError` on the next
    spill operation.  All blocking I/O lives on the two engine threads —
    plain daemon threads, so the rt-analyze loop-blocker pass stays
    clean by construction (nothing here runs on an event loop).

    Known trade (measured, accepted): the pending map is PROCESS-LOCAL
    while the spill dir and arena are node-shared — between a demotion
    and its write landing, OTHER processes cannot see the value (arena
    copy deleted, file absent) and fall back to the owner-fetch path.
    The old synchronous write had no such window but serialized every
    demotion onto the putting thread (the round-12 headline cost).  The
    window is bounded by the queue byte cap (RT_spill_queue_mb,
    backpressure above it), close() drains synchronously if the writer
    can't, and only refcount-0 objects — ones no local reader holds —
    are ever demoted."""

    _UNLINK_BATCH = 64

    def __init__(self, spill_dir: str, path_of, on_first_spill=None):
        self._dir = spill_dir
        self._path_of = path_of          # oid -> file path
        self._on_first_spill = on_first_spill
        self._cv = threading.Condition()
        self._write_q: collections.deque = collections.deque()
        self._pending: Dict[bytes, bytes] = {}
        self._pending_bytes = 0
        self._failed_oids: set = set()   # pending writes that errored
        self._drops: List[str] = []
        self._prefetch_q: collections.deque = collections.deque()
        self._cache: "collections.OrderedDict[bytes, bytes]" = \
            collections.OrderedDict()
        self._cache_bytes = 0
        self._failed: Optional[BaseException] = None
        self._stop = False
        self._writer: Optional[threading.Thread] = None
        self._reader: Optional[threading.Thread] = None
        self._max_pending = int(os.environ.get(
            "RT_spill_queue_mb", "256")) << 20
        self._cache_cap = int(os.environ.get(
            "RT_spill_prefetch_mb", "64")) << 20
        self._codec = _resolve_codec(os.environ.get(
            "RT_spill_compression", "none"))
        self._stats = collections.Counter()
        self._tmp_seq = 0  # per-attempt tmp-file uniquifier

    # ------------------------------------------------------------ submit
    def _ensure_writer_locked(self) -> None:
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(
                target=self._write_loop, daemon=True, name="rt-spill-writer")
            self._writer.start()

    def _raise_if_failed_locked(self) -> None:
        # STICKY: once a write failed, every later spill op raises.  The
        # failed bytes stay parked in the pending map (readable, never
        # lost) — clearing the flag would let a submit block forever in
        # the backpressure wait against a queue that can no longer drain.
        if self._failed is not None:
            raise SpillFailedError(
                f"spill write to {self._dir} failed: "
                f"{self._failed}") from self._failed

    def submit(self, oid: bytes, data: bytes) -> None:
        """Queue `data` for durable write under `oid`'s spill path.
        Blocks while the queue is over its byte bound (backpressure on
        the demoting putter); raises SpillFailedError if a previous
        write failed (the failed bytes stay readable in-memory)."""
        data = bytes(data)
        with self._cv:
            self._raise_if_failed_locked()
            while (self._pending_bytes > self._max_pending
                   and self._failed is None and not self._stop):
                self._cv.wait(0.5)
            self._raise_if_failed_locked()
            if oid in self._pending:
                return  # already queued (idempotent)
            self._pending[oid] = data
            self._pending_bytes += len(data)
            self._write_q.append(oid)
            self._ensure_writer_locked()
            self._cv.notify_all()
        m = _metrics()
        m["spilled"].inc(len(data))
        m["queue_depth"].set(len(self._write_q))
        m["queue_bytes"].set(self._pending_bytes)

    # ------------------------------------------------------------- write
    def _write_one(self, oid: bytes, data: bytes) -> None:
        # injected OSError rides the write loop's failure handling: the
        # engine goes sticky-failed, the bytes stay readable in pending
        from ray_tpu_torch.common import faults
        faults.fault_point("spill.write")
        payload = data
        if self._codec is not None:
            import struct as _struct

            method, comp, _ = self._codec
            body = comp(data)
            if len(body) < len(data):  # only keep wins
                payload = (_SPILL_MAGIC + bytes([method])
                           + _struct.pack("<Q", len(data)) + body)
        path = self._path_of(oid)
        # unique per ATTEMPT, pid kept last for the GC's stale-fragment
        # regex: the writer thread and a close()-time drain_sync may both
        # write (different oids normally, but never share a tmp path —
        # two threads truncating one tmp under each other interleaves
        # bytes into the durable file)
        with self._cv:
            self._tmp_seq += 1
            seq = self._tmp_seq
        tmp = f"{path}.{seq}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
        self._stats["bytes_written"] += len(payload)
        self._stats["bytes_spilled"] += len(data)
        _metrics()["written"].inc(len(payload))

    def _write_loop(self) -> None:
        first = True
        while True:
            with self._cv:
                while (not self._write_q and not self._drops
                       and not self._stop):
                    self._cv.wait(0.2)
                    if not self._write_q and self._drops:
                        break  # idle: flush the unlink batch
                if self._stop and not self._write_q and not self._drops:
                    return
                oid = self._write_q.popleft() if self._write_q else None
                data = self._pending.get(oid) if oid is not None else None
                drops, self._drops = (self._drops, []) \
                    if (len(self._drops) >= self._UNLINK_BATCH
                        or not self._write_q) else (None, self._drops)
            if drops:
                for p in drops:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
                self._stats["files_dropped"] += len(drops)
                _metrics()["dropped"].inc(len(drops))
            if oid is None or data is None:
                continue  # dropped while queued
            try:
                self._write_one(oid, data)
            except OSError as e:
                with self._cv:
                    self._failed = e
                    self._failed_oids.add(oid)  # bytes stay readable
                    self._cv.notify_all()
                self._stats["write_failures"] += 1
                _metrics()["failures"].inc()
                continue
            done = False
            with self._cv:
                if self._pending.pop(oid, None) is not None:
                    self._pending_bytes -= len(data)
                    done = True
                else:
                    # drop() cancelled the pending entry WHILE the write
                    # was in flight: the file just landed for a freed
                    # object — unlink it, or it leaks until session GC
                    # (and contains_spilled keeps answering True).
                    # Object ids are never reused after a free, so a
                    # later write under this oid cannot race the unlink.
                    self._drops.append(self._path_of(oid))
                self._cv.notify_all()
            if done and first and self._on_first_spill is not None:
                first = False
                try:
                    self._on_first_spill()
                except Exception:  # noqa: BLE001
                    pass
            m = _metrics()
            m["queue_depth"].set(len(self._write_q))
            m["queue_bytes"].set(self._pending_bytes)

    # -------------------------------------------------------------- read
    def read(self, oid: bytes) -> Optional[bytes]:
        with self._cv:
            data = self._pending.get(oid)
            if data is not None:
                self._stats["pending_hits"] += 1
                _metrics()["pending_hits"].inc()
                return data
            cached = self._cache.pop(oid, None)
            if cached is not None:
                self._cache_bytes -= len(cached)
                self._stats["prefetch_hits"] += 1
                _metrics()["prefetch_hits"].inc()
                return cached
        try:
            with open(self._path_of(oid), "rb") as f:
                blob = f.read()
        except OSError:
            return None
        out = _decompress_spill(blob)
        self._stats["prefetch_misses"] += 1
        self._stats["bytes_restored"] += len(out)
        m = _metrics()
        m["prefetch_misses"].inc()
        m["restored"].inc(len(out))
        return out

    def contains(self, oid: bytes) -> bool:
        with self._cv:
            return oid in self._pending or oid in self._cache

    # -------------------------------------------------------------- drop
    def cancel_pending(self, oid: bytes) -> bool:
        """Remove a queued-but-unwritten value (and any cached restore).
        True when the write was cancelled — no file will exist."""
        with self._cv:
            cached = self._cache.pop(oid, None)
            if cached is not None:
                self._cache_bytes -= len(cached)
            data = self._pending.pop(oid, None)
            if data is None:
                return False
            self._pending_bytes -= len(data)
            self._failed_oids.discard(oid)
            self._cv.notify_all()
            return True

    def drop(self, oid: bytes) -> None:
        """Batched unlink of `oid`'s spill file (the per-free unlink(2)
        was the hottest syscall of the small-task loop; the writer
        thread now takes them in batches)."""
        if self.cancel_pending(oid):
            return
        with self._cv:
            self._drops.append(self._path_of(oid))
            self._ensure_writer_locked()
            self._cv.notify_all()

    # ---------------------------------------------------------- prefetch
    def prefetch(self, oids) -> None:
        """Announced restore order: read the named spill files ahead of
        demand into a bounded cache (reads on the engine reader thread,
        never the caller's)."""
        with self._cv:
            for oid in oids:
                oid = bytes(oid)
                if oid in self._pending or oid in self._cache:
                    continue
                self._prefetch_q.append(oid)
            if self._prefetch_q and (self._reader is None
                                     or not self._reader.is_alive()):
                self._reader = threading.Thread(
                    target=self._read_loop, daemon=True,
                    name="rt-spill-reader")
                self._reader.start()
            self._cv.notify_all()

    def _read_loop(self) -> None:
        while True:
            with self._cv:
                while not self._prefetch_q and not self._stop:
                    self._cv.wait(0.2)
                if self._stop:
                    return
                oid = self._prefetch_q.popleft()
                if oid in self._pending or oid in self._cache:
                    continue
            try:
                with open(self._path_of(oid), "rb") as f:
                    blob = f.read()
            except OSError:
                continue  # not spilled (still resident) — nothing to do
            out = _decompress_spill(blob)
            with self._cv:
                if oid not in self._cache:
                    self._cache[oid] = out
                    self._cache_bytes += len(out)
                    while self._cache_bytes > self._cache_cap and \
                            len(self._cache) > 1:
                        _, old = self._cache.popitem(last=False)
                        self._cache_bytes -= len(old)

    # ------------------------------------------------------------- admin
    def flush(self, timeout: Optional[float] = 10.0) -> bool:
        """Wait until every queued write is durable (failed writes keep
        their bytes pending and do NOT block the flush — they are
        surfaced via SpillFailedError instead)."""
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._cv:
            while True:
                live = [o for o in self._pending
                        if o not in self._failed_oids]
                if not self._write_q and not live and not self._drops:
                    return True  # nothing queued: no thread ever starts
                if deadline is not None and _time.monotonic() >= deadline:
                    return False
                self._ensure_writer_locked()
                self._cv.notify_all()
                self._cv.wait(0.2)

    def drain_sync(self) -> None:
        """Last-resort durability on close: write every still-pending
        value INLINE on the calling thread (the writer thread may be
        wedged or too slow for the flush window — losing the bytes is
        worse than one synchronous exit-path write)."""
        while True:
            with self._cv:
                left = [(o, d) for o, d in self._pending.items()
                        if o not in self._failed_oids]
                if not left:
                    return
                oid, data = left[0]
            try:
                self._write_one(oid, data)
            except OSError as e:
                with self._cv:
                    self._failed = self._failed or e
                    self._failed_oids.add(oid)
                continue
            with self._cv:
                if self._pending.pop(oid, None) is not None:
                    self._pending_bytes -= len(data)
                self._cv.notify_all()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()

    def stats(self) -> dict:
        with self._cv:
            out = {"bytes_spilled": 0, "bytes_written": 0,
                   "bytes_restored": 0, "pending_hits": 0,
                   "prefetch_hits": 0, "prefetch_misses": 0,
                   "write_failures": 0, "files_dropped": 0}
            out.update(self._stats)
            out.update(
                queue_depth=len(self._write_q),
                queue_bytes=self._pending_bytes,
                prefetch_cache_bytes=self._cache_bytes,
                prefetch_queue=len(self._prefetch_q),
                drop_backlog=len(self._drops),
                failed=repr(self._failed) if self._failed else None,
                compression=(None if self._codec is None
                             else _SPILL_METHODS[self._codec[0]]),
            )
            written = out.get("bytes_written", 0)
            spilled = out.get("bytes_spilled", 0)
            out["compression_ratio"] = (
                round(written / spilled, 4) if spilled else None)
            return out


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True
    return True


def gc_spill_dirs(base: Optional[str] = None) -> dict:
    """Session-shutdown GC: remove spill state orphaned by dead
    processes — whole ``rtt_spill_*`` dirs whose recorded owner pid is
    gone, ``rttshm_spill_*`` dirs whose arena segment no longer exists,
    and stale ``*.tmp.<pid>`` write fragments from crashed writers in
    any surviving dir.  Live sessions are never touched (owner-pid and
    segment-existence checks), so concurrent sessions sharing the same
    base dir are safe."""
    import re
    import shutil
    import tempfile

    if base is None:
        # the configured spilling dir may come from GLOBAL_CONFIG
        # (set_system_config_value) without the RT_ env var being set —
        # scanning only the env fallback would miss every orphan under
        # the configured location
        try:
            from ray_tpu_torch.common.config import GLOBAL_CONFIG

            base = GLOBAL_CONFIG.get("object_spilling_dir") or None
        except Exception:  # noqa: BLE001 — standalone use of this module
            base = None
    base = base or os.environ.get("RT_object_spilling_dir") or \
        tempfile.gettempdir()
    removed = {"dirs": 0, "tmp_fragments": 0}
    try:
        names = os.listdir(base)
    except OSError:
        return removed
    for name in names:
        if not (name.startswith("rtt_spill_")
                or name.startswith("rttshm_spill_")):
            continue
        path = os.path.join(base, name)
        if not os.path.isdir(path):
            continue
        if name.startswith("rttshm_spill_"):
            seg = "/dev/shm/" + name[len("rttshm_spill_"):]
            if os.path.isdir("/dev/shm") and not os.path.exists(seg):
                shutil.rmtree(path, ignore_errors=True)
                removed["dirs"] += 1
                continue
        else:
            owner = os.path.join(path, ".owner")
            try:
                with open(owner) as f:
                    pid = int(f.read().strip())
            except (OSError, ValueError):
                pid = None
            if pid is not None and not _pid_alive(pid):
                shutil.rmtree(path, ignore_errors=True)
                removed["dirs"] += 1
                continue
        # surviving dir: sweep write fragments left by dead processes
        try:
            entries = os.listdir(path)
        except OSError:
            continue
        for f in entries:
            m = re.search(r"\.tmp\.(\d+)$", f)
            if m and not _pid_alive(int(m.group(1))):
                try:
                    os.unlink(os.path.join(path, f))
                    removed["tmp_fragments"] += 1
                except OSError:
                    pass
    return removed


class ShmObjectStore:
    """One node-local store; any process opening the same name shares it."""

    # sentinel: derive the spill dir from the segment name (the default —
    # spill-before-evict is a SHARED-ARENA invariant, so every handle to
    # a segment must agree on it; pass spill_dir=None explicitly for a
    # pure-LRU store, e.g. unit tests of eviction itself)
    DERIVE = object()

    def __init__(self, name: str, capacity: int = 256 * 1024 * 1024,
                 create: bool = True, spill_dir=DERIVE):
        import tempfile

        self._lib = _load()
        self.name = name.encode() if isinstance(name, str) else name
        if spill_dir is ShmObjectStore.DERIVE:
            spill_dir = self._derived_spill_dir(self.name)
        if create:
            h = self._lib.rts_create(self.name, capacity)
        else:
            h = self._lib.rts_open(self.name)
        if h < 0:
            raise OSError(-h, f"shm store {name!r}: {os.strerror(-h)}")
        self._h = h
        # liveness cell shared with get_pinned finalizers: once close()
        # flips it, stale finalizers become no-ops instead of releasing
        # by address against whatever NEW arena reused this handle slot
        self._alive = [True]
        # pins taken via get(): id -> mapped addresses, so release() can
        # name the exact span even after a delete + re-put of the id
        self._pins: dict = {}
        self._pins_lock = threading.Lock()
        # spill-before-evict (plasma's SpillObjects contract): with a
        # spill dir, a full arena demotes LRU victims to node-local disk
        # instead of silently dropping primary copies — the round-5 fix
        # for GB-scale shuffles losing blocks once the working set passed
        # the arena size.  All processes on the node share the dir (it is
        # derived from the segment name), so any process can spill and
        # any process can read back.
        self._spill_dir = spill_dir
        # drop_spilled() runs on EVERY owned-ref free — an unconditional
        # unlink(2) there costs ~60 µs per freed object (measured: the
        # single hottest syscall of the small-task hot loop). The dir-level
        # sentinel below makes the no-spills-ever case free: it is created
        # on the first spill by ANY process sharing the dir, and each
        # handle re-checks it at most once a second until seen.
        self._spill_seen = False
        self._spill_seen_t = 0.0
        # async spill engine: demotions hand their bytes to a dedicated
        # writer thread (with optional compression and batched unlinks)
        # instead of paying a synchronous open+write+rename on the
        # putting thread; restores ride a readahead cache fed by the
        # consumer's announced order (prefetch_spilled)
        self._engine: Optional[_SpillEngine] = None
        self._spill_batch = max(1, int(os.environ.get("RT_spill_batch",
                                                      "8")))
        # demotion observer (object location directory: an arena copy
        # just became a spill-file copy) — must never fail a demotion
        self._demote_cb = None
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
            self._lib.rts_set_autoevict(self._h, 0)
            self._engine = _SpillEngine(spill_dir, self._spill_path,
                                        on_first_spill=self._mark_spilled)

    # ------------------------------------------------------ spill-on-evict
    @staticmethod
    def _derived_spill_dir(name: bytes) -> str:
        """ONE rule for segment-name → spill-dir, shared by every handle
        AND by unlink() — a mismatch silently splits the arena's durable
        copies across directories."""
        import tempfile

        base = os.environ.get("RT_object_spilling_dir") or \
            tempfile.gettempdir()
        return os.path.join(base,
                            "rttshm_spill_" + name.decode().lstrip("/"))

    def _can_ever_fit(self, size: int) -> bool:
        """Guard the demotion loop: an object bigger than the whole arena
        would otherwise flush every resident object to disk and STILL
        fail."""
        cap, _, _ = self.stats()
        return size <= cap

    def _spill_path(self, object_id: bytes) -> str:
        return os.path.join(self._spill_dir, object_id.hex())

    def _sentinel_path(self) -> str:
        return os.path.join(self._spill_dir, ".has_spills")

    def _mark_spilled(self) -> None:
        if not self._spill_seen:
            self._spill_seen = True
            try:
                open(self._sentinel_path(), "a").close()
            except OSError:
                pass

    def _maybe_has_spills(self) -> bool:
        """Cheap gate for per-free spill-file cleanup: False until any
        process sharing this spill dir has spilled (re-stat ≤ 1/s). The
        ≤1 s race can only leak a stray spill file until session teardown
        removes the dir — never lose data (read paths are unguarded)."""
        if self._spill_seen:
            return True
        import time as _time

        now = _time.monotonic()
        if now - self._spill_seen_t < 1.0:
            return False
        self._spill_seen_t = now
        self._spill_seen = os.path.exists(self._sentinel_path())
        return self._spill_seen

    def set_demote_callback(self, cb) -> None:
        """``cb(object_id: bytes)`` fires after a value this handle
        demoted becomes spill-backed (LRU demotion or direct
        put_or_spill overflow).  Used by the hosting worker to move the
        object's directory entry from arena-location to spill-location
        so remote pullers take the spill-streaming path."""
        self._demote_cb = cb

    def _notify_demoted(self, object_id: bytes) -> None:
        cb = self._demote_cb
        if cb is not None:
            try:
                cb(bytes(object_id))
            except Exception:  # noqa: BLE001 — observer must not fail spill
                pass

    def _spill_some(self, need_bytes: int = 0) -> bool:
        """Demote a BATCH of LRU victims to the async spill engine.
        ``need_bytes`` bounds the batch (0 = one batch of up to
        RT_spill_batch victims).  False when nothing was evictable.

        Per victim: copy the bytes out of the arena (one memcpy), hand
        them to the writer queue (readable from that instant), then free
        the span.  The demoting putter pays memcpy + enqueue instead of
        a synchronous disk write; victim selection is ONE native call
        and one lock acquisition for the whole batch."""
        n = self._spill_batch
        out_ids = ctypes.create_string_buffer(32 * n)
        out_lens = (ctypes.c_uint32 * n)()
        got = self._lib.rts_lru_candidates(self._h, out_ids, out_lens, n,
                                           max(0, need_bytes))
        if got <= 0:
            return False
        demoted_any = False
        for i in range(got):
            oid = out_ids.raw[i * 32:i * 32 + out_lens[i]]
            view = self.get(oid)
            if view is None:
                demoted_any = True  # raced with a delete: space freed
                continue
            try:
                data = bytes(view)
            finally:
                del view
                self.release(oid)
            # enqueue BEFORE deleting the arena copy: reads find the
            # bytes in the pending map the moment the span is gone
            self._engine.submit(oid, data)
            self._lib.rts_delete(self._h, oid, len(oid))
            self._notify_demoted(oid)
            demoted_any = True
        return demoted_any

    def _spill_one(self) -> bool:
        """Back-compat shim: demote (at least) the LRU victim."""
        return self._spill_some(1)

    def put_or_spill(self, object_id: bytes, data) -> bool:
        """Node-durable put: into the arena if it fits (after demoting LRU
        victims), else straight to the node spill dir.  Either way the
        bytes survive this PROCESS — the property primary copies of task
        returns need (the holding worker may be idle-reaped long before
        the owner fetches; reference: plasma holds primary copies in the
        store daemon, not in workers).  A refused spill write raises a
        typed :class:`SpillFailedError` — never a silent loss."""
        if self._spill_dir is None:
            return self.put(object_id, data)
        try:
            return self.put(object_id, data)
        except SpillFailedError:
            raise
        except OSError:
            pass  # nothing evictable (all pinned): demote THIS value
        if not isinstance(data, (bytes, bytearray, memoryview)):
            data = bytes(data)
        self._engine.submit(object_id, bytes(data))
        self._notify_demoted(object_id)
        return True

    def read_spilled(self, object_id: bytes) -> Optional[bytes]:
        """Bytes of a demoted object, or None.  Served from the writer
        queue while the write is in flight, from the readahead cache
        when the consumer announced its order, else one disk read (with
        transparent decompression).  The copy is NOT re-admitted
        (re-admission would immediately re-trigger pressure — the
        reference restores lazily too)."""
        if self._spill_dir is None:
            return None
        return self._engine.read(object_id)

    def drop_spilled(self, object_id: bytes) -> None:
        if self._spill_dir is None:
            return
        # a queued-but-unwritten value cancels for free (dict pop) —
        # checked before the dir-level sentinel gate, which only guards
        # the on-disk case
        if self._engine.cancel_pending(object_id):
            return
        if not self._maybe_has_spills():
            return
        self._engine.drop(object_id)

    def contains_spilled(self, object_id: bytes) -> bool:
        if self._spill_dir is None:
            return False
        return (self._engine.contains(object_id)
                or os.path.exists(self._spill_path(object_id)))

    def prefetch_spilled(self, object_ids) -> None:
        """Announce upcoming restore order: the engine's reader thread
        loads those spill files into its cache ahead of the reads."""
        if self._spill_dir is not None:
            self._engine.prefetch(object_ids)

    def flush_spills(self, timeout: Optional[float] = 10.0) -> bool:
        """Block until queued spill writes are durable (process-exit
        path: put_or_spill's survive-this-process contract)."""
        return self._engine.flush(timeout) if self._engine else True

    def spill_stats(self) -> dict:
        return self._engine.stats() if self._engine else {}

    def put(self, object_id: bytes, data) -> bool:
        """False if it already exists; raises on out-of-space."""
        if not isinstance(data, bytes):
            data = bytes(data)
        rc = self._lib.rts_put(self._h, object_id, len(object_id), data,
                               len(data))
        while rc == -28 and self._spill_dir is not None \
                and self._can_ever_fit(len(data)):  # ENOSPC
            if not self._spill_some(len(data)):
                break
            rc = self._lib.rts_put(self._h, object_id, len(object_id),
                                   data, len(data))
        if rc == 0:
            return True
        if rc == -17:      # EEXIST
            return False
        raise OSError(-rc, f"shm put failed: {os.strerror(-rc)}")

    def create(self, object_id: bytes, size: int) -> Optional[memoryview]:
        """Two-phase write (plasma CreateObject): a WRITABLE view over a
        freshly allocated arena span — serialize directly into it, then
        :meth:`seal`. None if the id exists or space can't be found.
        Unsealed entries are invisible to readers and to eviction."""
        while True:
            ptr = self._lib.rts_create_unsealed(self._h, object_id,
                                                len(object_id), size)
            if ptr:
                break
            # nullptr is EEXIST *or* ENOSPC: distinguish, then spill
            if self._spill_dir is None or self.contains(object_id) \
                    or not self._can_ever_fit(size):
                return None
            if not self._spill_some(size):
                return None
        addr = ctypes.addressof(ptr.contents)
        return memoryview((ctypes.c_ubyte * size).from_address(addr)) \
            .cast("B")

    def seal(self, object_id: bytes) -> None:
        rc = self._lib.rts_seal(self._h, object_id, len(object_id))
        if rc != 0:
            raise OSError(-rc, f"shm seal failed: {os.strerror(-rc)}")

    def abort(self, object_id: bytes) -> None:
        """Free the span of a failed two-phase write."""
        self._lib.rts_abort(self._h, object_id, len(object_id))

    def get(self, object_id: bytes) -> Optional[memoryview]:
        """Zero-copy view, pinned until :meth:`release`."""
        size = ctypes.c_uint64()
        ptr = self._lib.rts_get(self._h, object_id, len(object_id),
                                ctypes.byref(size))
        if not ptr:
            return None
        addr = ctypes.addressof(ptr.contents)
        with self._pins_lock:
            self._pins.setdefault(bytes(object_id), []).append(addr)
        return memoryview(
            (ctypes.c_ubyte * size.value).from_address(addr)).cast("B")

    def get_pinned(self, object_id: bytes) -> Optional[memoryview]:
        """Read-only zero-copy view whose pin releases ITSELF when the
        last alias dies (numpy arrays deserialized over the view keep
        the exporting ctypes object alive; a finalizer on it runs the
        release). This is the plasma property: objects stay pinned
        exactly while some Python buffer references them, and shared
        pages are immutable to readers. The release is by ADDRESS, so it
        stays correct even if the id is deleted and re-put while the
        view is alive."""
        import weakref

        size = ctypes.c_uint64()
        ptr = self._lib.rts_get(self._h, object_id, len(object_id),
                                ctypes.byref(size))
        if not ptr:
            return None
        addr = ctypes.addressof(ptr.contents)
        owner = (ctypes.c_ubyte * size.value).from_address(addr)

        def _release(lib=self._lib, h=self._h, oid=bytes(object_id),
                     a=addr, alive=self._alive):
            # guard against handle-slot reuse: after close() this handle
            # may name a DIFFERENT arena, and a by-address release there
            # would decrement an unrelated live object's pin
            if alive[0]:
                lib.rts_release_addr(h, oid, len(oid), a)

        weakref.finalize(owner, _release)
        return memoryview(owner).cast("B").toreadonly()

    def release(self, object_id: bytes) -> None:
        key = bytes(object_id)
        with self._pins_lock:
            addrs = self._pins.get(key)
            addr = addrs.pop() if addrs else None
            if addrs is not None and not addrs:
                del self._pins[key]
        if addr is not None:
            self._lib.rts_release_addr(self._h, object_id, len(object_id),
                                       addr)
        else:  # pin not taken through this wrapper: id-based best effort
            self._lib.rts_release(self._h, object_id, len(object_id))

    def contains(self, object_id: bytes) -> bool:
        return bool(self._lib.rts_contains(self._h, object_id,
                                           len(object_id)))

    def delete(self, object_id: bytes) -> bool:
        return self._lib.rts_delete(self._h, object_id, len(object_id)) == 0

    def stats(self) -> Tuple[int, int, int]:
        cap = ctypes.c_uint64()
        used = ctypes.c_uint64()
        num = ctypes.c_uint64()
        self._lib.rts_stats(self._h, ctypes.byref(cap), ctypes.byref(used),
                            ctypes.byref(num))
        return cap.value, used.value, num.value

    def close(self) -> None:
        """Unmap this process's view and free the handle slot for reuse.
        The shared segment (and other processes) are untouched. The
        per-process handle table is FIXED SIZE (64): a long-lived process
        that repeatedly opens arenas without closing them — e.g. a test
        harness init/shutdown-cycling the runtime — exhausts it and every
        later session silently loses its object plane. Pins still held by
        surviving views are abandoned (their finalizers are disarmed via
        the liveness cell, so slot reuse can never misroute a by-address
        release into a different arena)."""
        if self._engine is not None:
            # drain queued demotions first: their arena spans are gone,
            # so the pending bytes are the only copy until the writer
            # lands them (put_or_spill's survive-this-process contract).
            # A flush that can't finish in its window falls back to
            # synchronous inline writes — close() must not abandon the
            # only copy because the writer thread was slow or wedged.
            # stop() first lets the writer drain-and-exit (its loop only
            # returns on an empty queue); drain_sync then takes whatever
            # a wedged writer left (per-attempt tmp names make even a
            # still-running writer harmless).
            if not self._engine.flush(5.0):
                self._engine.stop()
                w = self._engine._writer
                if w is not None:
                    w.join(5.0)
                self._engine.drain_sync()
            self._engine.stop()
        self._alive[0] = False
        h, self._h = self._h, -1
        if h >= 0:
            self._lib.rts_close(h)

    def unlink(self):
        self._lib.rts_unlink(self.name)


def node_shm_name(node_id) -> str:
    """Canonical name of a node's arena segment — the ONE place the
    naming scheme lives (creator: the hosting raylet; openers: workers,
    stats, teardown in both deployment shapes)."""
    hexid = node_id if isinstance(node_id, str) else node_id.hex()
    return f"/rttshm_{hexid[:12]}"


def unlink(name) -> bool:
    """Unlink a segment by name WITHOUT opening it (no handle-slot cost).
    Also removes the segment's derived spill dir — demoted objects die
    with their arena (repeated sessions must not accumulate spilled GBs
    in /tmp)."""
    import shutil

    if isinstance(name, str):
        name = name.encode()
    shutil.rmtree(ShmObjectStore._derived_spill_dir(name),
                  ignore_errors=True)
    try:
        return _load().rts_unlink(name) == 0
    except Exception:  # noqa: BLE001 — lib unbuildable → nothing to unlink
        return False
