"""GCS client — typed accessors (reference: gcs/gcs_client/gcs_client.h, accessor.h).

One address: GCS failover (``standby_addresses`` or
``RT_GCS_STANDBY_ADDRS``) is not ported yet, and a client given standby
addresses refuses (``common/status.py::WAITING``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.common import faults
from ray_tpu_torch.common.ids import ActorID, JobID, NodeID, PlacementGroupID
from ray_tpu_torch.common.status import not_ported
from ray_tpu_torch.rpc.pubsub import Subscriber
from ray_tpu_torch.rpc.rpc import RetryableRpcClient, RpcRetriesExhausted


class GcsClient:
    def __init__(self, address: Tuple[str, int],
                 client_id: Optional[str] = None,
                 standby_addresses: Sequence[Tuple[str, int]] = ()):
        if list(standby_addresses) or os.environ.get(
                "RT_GCS_STANDBY_ADDRS", "").strip():
            raise not_ported("gcs_failover")
        self.address = tuple(address)
        self._rpc = RetryableRpcClient(self.address)
        self._subscriber: Optional[Subscriber] = None
        self._client_id = client_id or f"client-{id(self):x}"

    # -- async passthrough for in-loop callers --
    async def call_async(self, method: str, **kwargs):
        try:
            faults.fault_point("gcs.rpc.send")
        except faults.FaultInjected as e:
            # injected control-plane unreachability takes the exit a
            # burned reconnect window does: the typed transport-dead error
            raise RpcRetriesExhausted(f"gcs rpc {method} failed: {e}") from e
        return await self._rpc.call_async(method, **kwargs)

    def call(self, method: str, **kwargs):
        try:
            faults.fault_point("gcs.rpc.send")
        except faults.FaultInjected as e:
            raise RpcRetriesExhausted(f"gcs rpc {method} failed: {e}") from e
        return self._rpc.call(method, **kwargs)

    @property
    def subscriber(self) -> Subscriber:
        if self._subscriber is None:
            self._subscriber = Subscriber(self._client_id, self.address)
        return self._subscriber

    # -- nodes --
    def register_node(self, node_id: NodeID, address, resources: Dict[str, float],
                      labels: Dict[str, str], object_store_address: Optional[str] = None) -> dict:
        return self.call(
            "register_node", node_id=node_id.binary(), address=address,
            resources=resources, labels=labels, object_store_address=object_store_address,
        )

    def get_all_nodes(self) -> List[dict]:
        return self.call("get_all_nodes")

    # -- object location directory --
    def object_locations_update(self, updates: List[dict]) -> dict:
        """Push one owner-coalesced batch of location transitions
        (``{"op": "add"|"remove"|"spill", "object_id", "node_id",
        "address"?, "size"?}``)."""
        return self.call("object_locations_update", updates=updates)

    def get_object_locations(self, object_ids: List[bytes]) -> dict:
        """oid-hex -> [{node_id, address, spilled, size}] for every live
        copy the directory knows about."""
        return self.call("get_object_locations", object_ids=list(object_ids))

    def cluster_resources(self) -> dict:
        return self.call("get_cluster_resources")

    # -- jobs --
    def get_next_job_id(self) -> JobID:
        return JobID(self.call("get_next_job_id"))

    def register_job(self, job_id: JobID, driver_address=None, entrypoint: str = "") -> bool:
        return self.call("register_job", job_id=job_id.binary(),
                         driver_address=driver_address, entrypoint=entrypoint)

    def finish_job(self, job_id: JobID) -> bool:
        return self.call("finish_job", job_id=job_id.binary())

    # -- actors --
    def register_actor(self, creation_spec: bytes, actor_id: ActorID, job_id: JobID,
                       name: Optional[str] = None, namespace: str = "default",
                       max_restarts: int = 0) -> dict:
        return self.call(
            "register_actor", creation_spec=creation_spec, actor_id=actor_id.binary(),
            job_id=job_id.binary(), name=name, namespace=namespace, max_restarts=max_restarts,
        )

    def get_actor(self, actor_id: ActorID) -> Optional[dict]:
        return self.call("get_actor", actor_id=actor_id.binary())

    def get_actor_by_name(self, name: str, namespace: str = "default") -> Optional[dict]:
        return self.call("get_actor_by_name", name=name, namespace=namespace)

    def list_actors(self) -> List[dict]:
        return self.call("list_actors")

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> bool:
        return self.call("kill_actor", actor_id=actor_id.binary(), no_restart=no_restart)

    # -- placement groups --
    def create_placement_group(self, pg_id: PlacementGroupID, bundles: List[dict],
                               strategy: str, name: Optional[str] = None,
                               job_id: Optional[JobID] = None) -> dict:
        return self.call(
            "create_placement_group", pg_id=pg_id.binary(), bundles=bundles,
            strategy=strategy, name=name, job_id=job_id and job_id.binary(),
        )

    def remove_placement_group(self, pg_id: PlacementGroupID) -> bool:
        return self.call("remove_placement_group", pg_id=pg_id.binary())

    def get_placement_group(self, pg_id: PlacementGroupID) -> Optional[dict]:
        return self.call("get_placement_group", pg_id=pg_id.binary())

    def wait_placement_group_ready(self, pg_id: PlacementGroupID, timeout: float = 30.0) -> dict:
        return self.call("wait_placement_group_ready", pg_id=pg_id.binary(),
                         timeout_s=timeout, timeout=timeout + 5.0)

    def list_placement_groups(self) -> List[dict]:
        return self.call("list_placement_groups")

    # -- KV --
    def kv_put(self, namespace: str, key, value: bytes, overwrite: bool = True) -> bool:
        return self.call("kv_put", namespace=namespace, key=key, value=value, overwrite=overwrite)

    def kv_get(self, namespace: str, key) -> Optional[bytes]:
        return self.call("kv_get", namespace=namespace, key=key)

    def kv_del(self, namespace: str, key) -> bool:
        return self.call("kv_del", namespace=namespace, key=key)

    def kv_keys(self, namespace: str, prefix=b"") -> List[bytes]:
        return self.call("kv_keys", namespace=namespace, prefix=prefix)

    def close(self):
        if self._subscriber is not None:
            self._subscriber.close()
        self._rpc.close()
