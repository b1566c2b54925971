"""Cluster resource view shared by the GCS and every raylet.

Equivalent of the reference's ClusterResourceScheduler's node map
(src/ray/raylet/scheduling/cluster_resource_scheduler.h:45 +
cluster_resource_data.h): a versioned {node_id: NodeResources} snapshot fed by
resource gossip.  The GCS holds the authoritative copy; raylets hold replicas
updated via the resource pubsub channel (the RaySyncer role,
src/ray/common/ray_syncer/ray_syncer.h:87).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Tuple

from ray_tpu_torch.common.ids import NodeID
from ray_tpu_torch.common.resources import NodeResources


@dataclass
class NodeEntry:
    node_id: NodeID
    address: Tuple[str, int]  # raylet RPC address
    resources: NodeResources
    seq: int = 0  # gossip version; stale updates are dropped
    alive: bool = True
    last_seen: float = field(default_factory=time.monotonic)
    object_store_address: Optional[str] = None  # shm store socket path (same-host)
    # node transfer-service endpoint (object_store/transfer.py): where
    # other nodes pull this node's sealed/spilled objects from
    transfer_address: Optional[Tuple[str, int]] = None


class ClusterView:
    """Thread-safe node table with versioned updates."""

    def __init__(self):
        self._nodes: Dict[NodeID, NodeEntry] = {}
        self._lock = threading.Lock()

    def upsert(self, entry: NodeEntry) -> bool:
        """Insert/refresh a node. Returns False if dropped as stale."""
        with self._lock:
            cur = self._nodes.get(entry.node_id)
            if cur is not None and cur.seq > entry.seq:
                return False
            self._nodes[entry.node_id] = entry
            return True

    def update_resources(self, node_id: NodeID, snapshot: dict, seq: int) -> bool:
        with self._lock:
            cur = self._nodes.get(node_id)
            if cur is None or seq <= cur.seq:
                return False
            cur.resources = NodeResources.from_snapshot(snapshot)
            cur.seq = seq
            cur.last_seen = time.monotonic()
            return True

    def mark_dead(self, node_id: NodeID) -> Optional[NodeEntry]:
        with self._lock:
            cur = self._nodes.get(node_id)
            if cur is not None and cur.alive:
                cur.alive = False
                return cur
            return None

    def remove(self, node_id: NodeID) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    def get(self, node_id: NodeID) -> Optional[NodeEntry]:
        with self._lock:
            return self._nodes.get(node_id)

    def alive_nodes(self) -> Iterator[NodeEntry]:
        with self._lock:
            return iter([e for e in self._nodes.values() if e.alive])

    def all_nodes(self) -> Iterator[NodeEntry]:
        with self._lock:
            return iter(list(self._nodes.values()))

    def total_resources(self) -> dict:
        out: Dict[str, float] = {}
        for e in self.alive_nodes():
            for k, v in e.resources.total.to_dict().items():
                out[k] = out.get(k, 0) + v
        return out

    def available_resources(self) -> dict:
        out: Dict[str, float] = {}
        for e in self.alive_nodes():
            for k, v in e.resources.available.to_dict().items():
                out[k] = out.get(k, 0) + v
        return out
