"""Internal key-value store (reference: gcs/gcs_server/gcs_kv_manager.h).

Namespaced binary KV used for: collective group rendezvous, named actors,
function table, cluster metadata.  In-memory, with optional durability
delegated to :class:`~ray_tpu_torch.gcs.storage.GcsTableStorage` (one "kv" table
in the shared GCS table log machinery) — the reference's Redis-backed fault
tolerance (store_client/redis_store_client.h) modeled as replay-on-restart,
with torn-tail tolerance and compaction inherited from the table store.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class InternalKV:
    def __init__(self, storage=None, *, owns_storage: bool = False):
        """``storage`` is a :class:`GcsTableStorage` (usually the GCS
        server's own, shared) whose "kv" table backs this store; None keeps
        the KV purely in-memory. The storage is only closed here when this
        KV created it (``owns_storage``)."""
        self._data: Dict[bytes, bytes] = {}
        self._lock = threading.Lock()
        self._storage = storage
        self._owns_storage = owns_storage
        if storage is not None:
            for key, rec in storage.all("kv").items():
                self._data[key] = rec["v"]

    @staticmethod
    def _k(namespace: str, key: bytes | str) -> bytes:
        if isinstance(key, str):
            key = key.encode()
        return namespace.encode() + b"\x00" + key

    def put(self, namespace: str, key, value: bytes, overwrite: bool = True) -> bool:
        k = self._k(namespace, key)
        with self._lock:
            if not overwrite and k in self._data:
                return False
            self._data[k] = value
            if self._storage is not None:
                self._storage.put("kv", k, {"v": value})
            return True

    def get(self, namespace: str, key) -> Optional[bytes]:
        with self._lock:
            return self._data.get(self._k(namespace, key))

    def exists(self, namespace: str, key) -> bool:
        with self._lock:
            return self._k(namespace, key) in self._data

    def delete(self, namespace: str, key) -> bool:
        k = self._k(namespace, key)
        with self._lock:
            existed = self._data.pop(k, None) is not None
            if existed and self._storage is not None:
                self._storage.delete("kv", k)
            return existed

    def keys(self, namespace: str, prefix: bytes | str = b"") -> List[bytes]:
        p = self._k(namespace, prefix)
        ns_len = len(namespace.encode()) + 1
        with self._lock:
            return [k[ns_len:] for k in self._data if k.startswith(p)]

    def close(self):
        if self._storage is not None and self._owns_storage:
            self._storage.close()
        self._storage = None
