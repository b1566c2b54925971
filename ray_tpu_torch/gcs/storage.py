"""GCS table storage — persistence behind the control plane.

Reference: ``src/ray/gcs/gcs_server/gcs_table_storage.h`` (typed tables over
a store client) + ``store_client/redis_store_client.h`` (the Redis-backed
implementation used for GCS fault tolerance). Redis is not part of this
image, so the store is a local append-only pickle log with write-time
flushing and open-time compaction — the recovery contract is the same: every
committed table mutation survives a GCS process crash and is replayed on
restart.

Layout: one log file holds all tables; records are ``(op, table, key,
value)`` pickle frames. Keys are bytes; values are plain dicts (pickled), so
replay needs no class imports.
"""

from __future__ import annotations

import logging
import os
import pickle
import shutil
import threading
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class GcsTableStorage:
    """Append-log-backed map of table -> key -> record dict."""

    # rewrite the log once garbage (overwrites+deletes) passes this many frames
    _COMPACT_MIN_OPS = 10_000

    def __init__(self, path: str):
        self._path = path
        self._lock = threading.Lock()
        self._tables: Dict[str, Dict[bytes, dict]] = {}
        self._ops = 0
        # bumped on every compaction: a replica streaming the log by byte
        # offset must restart from 0 when the file is rewritten under it
        self._generation = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.exists(path):
            self._replay()
            self._compact_locked()
        self._log = open(path, "ab")

    def _replay(self):
        size = os.path.getsize(self._path)
        stopped_at = size
        with open(self._path, "rb") as f:
            while True:
                try:
                    op, table, key, value = pickle.load(f)
                except EOFError:
                    break  # clean end of log
                except Exception:  # noqa: BLE001
                    # Torn tail write: everything before it is valid. A
                    # truncated frame's surviving opcodes can raise far more
                    # than UnpicklingError (ValueError, IndexError,
                    # AttributeError, ...), and any of them crashing startup
                    # would break recovery exactly when it is needed.
                    stopped_at = f.tell()
                    break
                t = self._tables.setdefault(table, {})
                if op == "put":
                    t[key] = value
                else:
                    t.pop(key, None)
                self._ops += 1
        if stopped_at < size:
            # Distinguish the expected torn TAIL (crash mid-append: only the
            # final frame is lost) from mid-log corruption, where everything
            # after the bad frame is dropped. Either way compaction will
            # rewrite the log from the replayed state, so preserve the
            # original for forensics before that happens.
            backup = self._path + ".corrupt"
            try:
                shutil.copyfile(self._path, backup)
            except OSError:
                backup = "<copy failed>"
            lost = size - stopped_at
            level = logger.error if lost > 256 else logger.warning
            level(
                "gcs table log %s: replay stopped at byte %d of %d "
                "(%d bytes unread, %d ops replayed); original preserved "
                "at %s", self._path, stopped_at, size, lost, self._ops,
                backup)

    def _compact_locked(self):
        tmp = self._path + ".compact"
        with open(tmp, "wb") as f:
            for table, records in self._tables.items():
                for key, value in records.items():
                    pickle.dump(("put", table, key, value), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path)
        self._ops = sum(len(t) for t in self._tables.values())
        self._generation += 1

    def put(self, table: str, key: bytes, value: dict) -> None:
        with self._lock:
            self._tables.setdefault(table, {})[key] = value
            if self._log is None:
                return  # closed mid-shutdown: background tasks may still land
            pickle.dump(("put", table, key, value), self._log)
            self._log.flush()
            self._ops += 1
            self._maybe_compact()

    def delete(self, table: str, key: bytes) -> None:
        with self._lock:
            existed = self._tables.get(table, {}).pop(key, None) is not None
            if existed and self._log is not None:
                pickle.dump(("del", table, key, None), self._log)
                self._log.flush()
                self._ops += 1
                self._maybe_compact()

    def _maybe_compact(self):
        live = sum(len(t) for t in self._tables.values())
        if self._ops - live >= self._COMPACT_MIN_OPS:
            self._log.close()
            self._compact_locked()
            self._log = open(self._path, "ab")

    def get(self, table: str, key: bytes) -> Optional[dict]:
        with self._lock:
            return self._tables.get(table, {}).get(key)

    def all(self, table: str) -> Dict[bytes, dict]:
        with self._lock:
            return dict(self._tables.get(table, {}))

    def close(self):
        with self._lock:
            if self._log is not None:
                self._log.close()
                self._log = None
