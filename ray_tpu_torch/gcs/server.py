"""GCS — the cluster control plane.

Equivalent of the reference's GCS server (src/ray/gcs/gcs_server/gcs_server.cc
and its managers): node registry + health checking, aggregated resource view,
job table, actor lifecycle management with restart-on-failure, placement
groups with two-phase commit across raylets, internal KV, and a task-event
store.  Data-plane state (object VALUES) is deliberately NOT here — ownership
lives with workers, as in the reference.  The GCS does keep the object
LOCATION directory (which nodes hold a copy, arena or spilled — reference:
the owner-reported object directory): owners push coalesced add/remove/spill
batches and cold ``get`` paths resolve holders here before riding the
node-to-node transfer service.

State changes are published on pubsub channels: "node", "actor", "pg", "job",
"resources", "object_loc".
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.common.config import GLOBAL_CONFIG
from ray_tpu_torch.common.ids import ActorID, JobID, NodeID, PlacementGroupID, WorkerID
from ray_tpu_torch.common.resources import NodeResources, ResourceRequest
from ray_tpu_torch.rpc.pubsub import Publisher
from ray_tpu_torch.rpc.rpc import (IoContext, RetryableRpcClient, RpcClient,
                             RpcServer)
from ray_tpu_torch.scheduling import ClusterView, NodeEntry, policies

logger = logging.getLogger(__name__)

# Actor lifecycle states (reference protocol: gcs_actor_manager.h:300-332)
ACTOR_PENDING = "PENDING_CREATION"
ACTOR_ALIVE = "ALIVE"
ACTOR_RESTARTING = "RESTARTING"
ACTOR_DEAD = "DEAD"

PG_PENDING = "PENDING"
PG_CREATED = "CREATED"
PG_REMOVED = "REMOVED"
PG_RESCHEDULING = "RESCHEDULING"


@dataclass
class ActorRecord:
    actor_id: ActorID
    job_id: JobID
    name: Optional[str]
    creation_spec: bytes  # pickled TaskSpec for the creation task
    max_restarts: int
    namespace: str = "default"
    state: str = ACTOR_PENDING
    node_id: Optional[NodeID] = None
    worker_id: Optional[WorkerID] = None
    address: Optional[Tuple[str, int]] = None
    # C fastloop dispatch port of the hosting worker (rpc/native/fastloop.c);
    # None when the worker runs without the native loop
    fast_port: Optional[int] = None
    num_restarts: int = 0
    death_cause: str = ""
    handled_deaths: set = field(default_factory=set)

    def to_store(self) -> dict:
        return {
            "actor_id": self.actor_id.binary(),
            "job_id": self.job_id.binary(),
            "name": self.name,
            "namespace": self.namespace,
            "creation_spec": self.creation_spec,
            "max_restarts": self.max_restarts,
            "state": self.state,
            "node_id": self.node_id and self.node_id.binary(),
            "worker_id": self.worker_id and self.worker_id.binary(),
            "address": self.address,
            "fast_port": self.fast_port,
            "num_restarts": self.num_restarts,
            "death_cause": self.death_cause,
            "handled_deaths": [w.binary() for w in self.handled_deaths],
        }

    @classmethod
    def from_store(cls, d: dict) -> "ActorRecord":
        return cls(
            actor_id=ActorID(d["actor_id"]),
            job_id=JobID(d["job_id"]),
            name=d["name"],
            namespace=d.get("namespace", "default"),
            creation_spec=d["creation_spec"],
            max_restarts=d["max_restarts"],
            state=d["state"],
            node_id=d["node_id"] and NodeID(d["node_id"]),
            worker_id=d["worker_id"] and WorkerID(d["worker_id"]),
            address=d["address"] and tuple(d["address"]),
            fast_port=d.get("fast_port"),
            num_restarts=d["num_restarts"],
            death_cause=d["death_cause"],
            handled_deaths={WorkerID(w) for w in d["handled_deaths"]},
        )

    def public_view(self) -> dict:
        return {
            "actor_id": self.actor_id.hex(),
            "job_id": self.job_id.hex(),
            "name": self.name,
            "state": self.state,
            "address": self.address,
            "fast_port": self.fast_port,
            "node_id": self.node_id.hex() if self.node_id else None,
            "num_restarts": self.num_restarts,
            "max_restarts": self.max_restarts,
            "death_cause": self.death_cause,
        }


@dataclass
class PgRecord:
    pg_id: PlacementGroupID
    name: Optional[str]
    bundles: List[ResourceRequest]
    strategy: str
    state: str = PG_PENDING
    bundle_nodes: List[Optional[NodeID]] = field(default_factory=list)
    creator_job: Optional[JobID] = None

    def public_view(self) -> dict:
        return {
            "pg_id": self.pg_id.hex(),
            "name": self.name,
            "strategy": self.strategy,
            "state": self.state,
            "bundles": [b.to_dict() for b in self.bundles],
            "bundle_nodes": [n.hex() if n else None for n in self.bundle_nodes],
        }

    def to_store(self) -> dict:
        return {
            "pg_id": self.pg_id.binary(),
            "name": self.name,
            "bundles": [b.to_dict() for b in self.bundles],
            "strategy": self.strategy,
            "state": self.state,
            "bundle_nodes": [n and n.binary() for n in self.bundle_nodes],
            "creator_job": self.creator_job and self.creator_job.binary(),
        }

    @classmethod
    def from_store(cls, d: dict) -> "PgRecord":
        return cls(
            pg_id=PlacementGroupID(d["pg_id"]),
            name=d["name"],
            bundles=[ResourceRequest.from_dict(b) for b in d["bundles"]],
            strategy=d["strategy"],
            state=d["state"],
            bundle_nodes=[n and NodeID(n) for n in d["bundle_nodes"]],
            creator_job=d["creator_job"] and JobID(d["creator_job"]),
        )


@dataclass
class JobRecord:
    job_id: JobID
    driver_address: Optional[Tuple[str, int]]
    start_time: float
    state: str = "RUNNING"
    entrypoint: str = ""


class RayletHandle:
    """GCS-side client to one raylet."""

    def __init__(self, address: Tuple[str, int]):
        self.address = address
        self.client = RetryableRpcClient(address, deadline_s=10.0)

    def close(self):
        self.client.close()


class GcsServer:
    """All managers in one process, handlers on one event loop."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 persist_dir: Optional[str] = None):
        from .kv import InternalKV
        from .storage import GcsTableStorage

        self.server = RpcServer(host, port)
        self.publisher = Publisher()
        self.publisher.attach(self.server)
        self.view = ClusterView()
        self.storage: Optional[GcsTableStorage] = (
            GcsTableStorage(f"{persist_dir}/gcs_tables.log") if persist_dir else None)
        self.kv = InternalKV(self.storage)
        self._raylets: Dict[NodeID, RayletHandle] = {}
        self._actors: Dict[ActorID, ActorRecord] = {}
        self._named_actors: Dict[Tuple[str, str], ActorID] = {}  # (namespace,name)
        self._pgs: Dict[PlacementGroupID, PgRecord] = {}
        self._jobs: Dict[JobID, JobRecord] = {}
        self._job_counter = 0
        self._task_events: List[dict] = []  # ring buffer
        self._stopped = False
        self._pending_actor_queue: List[ActorID] = []
        self._pending_pg_queue: List[PlacementGroupID] = []
        self._node_stats: Dict[NodeID, dict] = {}  # per-node system stats
        # object location directory (reference: GcsObjectManager / the
        # owner-reported object directory): oid -> node_id_hex ->
        # {"address": transfer endpoint, "spilled": bool, "size": int}.
        # Owners report coalesced batches (object_locations_update), cold
        # fetches resolve here, node death drops the node's column.
        self._object_locations: Dict[bytes, Dict[str, dict]] = {}
        # export API (util/export_events.py): attached post-boot by the
        # session owner when enable_export_api is set
        self._export_logger = None
        # Actors persisted ALIVE whose hosting raylet hasn't re-registered yet
        # after a GCS restart (reference: gcs_actor_manager.cc restart path —
        # wait for raylet reports, then fail over the unclaimed).
        self._unconfirmed_actors: set = set()
        self._recovered = False
        self._io = IoContext.current()
        if self.storage is not None:
            self._replay_tables()
        self._register_handlers()

    # ------------------------------------------------------------ persistence
    def _replay_tables(self):
        """Rebuild control-plane state from the table log (GCS restart).

        Nodes are NOT replayed — raylets outlive the GCS and re-register
        themselves (their report_resources gets ``unknown`` and triggers a
        fresh register_node carrying live actors + held bundles), which is
        how the reference handles GCS failover (NotifyGCSRestart,
        node_manager.proto:397).
        """
        for raw in self.storage.all("jobs").values():
            rec = JobRecord(JobID(raw["job_id"]),
                            raw["driver_address"] and tuple(raw["driver_address"]),
                            raw["start_time"], raw["state"], raw["entrypoint"])
            self._jobs[rec.job_id] = rec
        meta = self.storage.get("meta", b"job_counter")
        if meta:
            self._job_counter = meta["value"]
        for raw in self.storage.all("actors").values():
            rec = ActorRecord.from_store(raw)
            self._actors[rec.actor_id] = rec
            if rec.name is not None and rec.state != ACTOR_DEAD:
                self._named_actors[(rec.namespace, rec.name)] = rec.actor_id
            if rec.state == ACTOR_ALIVE:
                self._unconfirmed_actors.add(rec.actor_id)
            elif rec.state in (ACTOR_PENDING, ACTOR_RESTARTING):
                self._pending_actor_queue.append(rec.actor_id)
        for raw in self.storage.all("pgs").values():
            rec = PgRecord.from_store(raw)
            self._pgs[rec.pg_id] = rec
            if rec.state == PG_CREATED:
                # bundle placements must be re-claimed by re-registering
                # raylets; unclaimed ones are rescheduled by the reconciler
                rec.bundle_nodes = [None] * len(rec.bundles)
            elif rec.state in (PG_PENDING, PG_RESCHEDULING):
                self._pending_pg_queue.append(rec.pg_id)
        if self._actors or self._pgs or self._jobs:
            self._recovered = True

    def _persist_actor(self, rec: ActorRecord):
        if self.storage is not None:
            self.storage.put("actors", rec.actor_id.binary(), rec.to_store())

    def _persist_pg(self, rec: PgRecord):
        if self.storage is not None:
            self.storage.put("pgs", rec.pg_id.binary(), rec.to_store())

    def _persist_job(self, rec: JobRecord):
        if self.storage is not None:
            self.storage.put("jobs", rec.job_id.binary(), {
                "job_id": rec.job_id.binary(),
                "driver_address": rec.driver_address,
                "start_time": rec.start_time,
                "state": rec.state,
                "entrypoint": rec.entrypoint,
            })

    # ------------------------------------------------------------------ setup
    def _register_handlers(self):
        s = self.server
        for name in (
            "register_node", "unregister_node", "report_resources", "get_all_nodes",
            "get_cluster_resources", "check_alive",
            "register_job", "finish_job", "get_all_jobs", "get_next_job_id",
            "register_actor", "register_actors", "report_actor_state",
            "get_actor", "get_actor_by_name",
            "list_actors", "kill_actor",
            "create_placement_group", "remove_placement_group", "get_placement_group",
            "wait_placement_group_ready", "list_placement_groups",
            "kv_put", "kv_get", "kv_del", "kv_keys", "kv_exists",
            "add_task_events", "get_task_events",
            "get_system_config", "health_check", "debug_state",
            "publish_worker_log",
            "object_locations_update", "get_object_locations",
        ):
            s.register(name, getattr(self, f"h_{name}"))

    def attach_export_logger(self, session_dir: str) -> None:
        """Start writing structured export events (actor/node/job/PG
        state transitions) under ``session_dir`` when the
        ``enable_export_api`` flag is set (reference: export API,
        src/ray/util/event.cc)."""
        if GLOBAL_CONFIG.get("enable_export_api"):
            from ray_tpu_torch.util.export_events import ExportEventLogger

            self._export_logger = ExportEventLogger(session_dir)

    def _export(self, source_type: str, **event_data) -> None:
        if self._export_logger is not None:
            self._export_logger.emit(source_type, event_data)

    def _publish_actor(self, rec: ActorRecord) -> None:
        """Chokepoint for actor state changes: pubsub + export event."""
        self.publisher.publish("actor", rec.actor_id.hex(),
                               rec.public_view())
        self._export("EXPORT_ACTOR", **rec.public_view())

    def _publish_pg(self, rec: PgRecord) -> None:
        self.publisher.publish("pg", rec.pg_id.hex(), rec.public_view())
        self._export("EXPORT_PLACEMENT_GROUP", **rec.public_view())

    def start(self):
        self.server.start()
        self._io.spawn_threadsafe(self._health_loop())
        self._io.spawn_threadsafe(self._driver_health_loop())
        if self._recovered:
            self._io.spawn_threadsafe(self._reconcile_after_restart())

    def stop(self):
        self._stopped = True
        if self._export_logger is not None:
            self._export_logger.close()
        for h in self._raylets.values():
            h.close()
        self.server.stop()
        self.kv.close()
        if self.storage is not None:
            self.storage.close()

    @property
    def address(self) -> Tuple[str, int]:
        return self.server.address

    # ------------------------------------------------------------- node mgmt
    async def h_register_node(self, node_id: bytes, address, resources: dict, labels: dict,
                              object_store_address: Optional[str] = None,
                              transfer_address=None,
                              live_actors: Optional[List[dict]] = None,
                              held_bundles: Optional[List[dict]] = None):
        nid = NodeID(node_id)
        entry = NodeEntry(
            node_id=nid,
            address=tuple(address),
            resources=NodeResources(resources, labels),
            object_store_address=object_store_address,
            transfer_address=tuple(transfer_address) if transfer_address
            else None,
        )
        self.view.upsert(entry)
        self._raylets[nid] = RayletHandle(tuple(address))
        self.publisher.publish("node", nid.hex(), {"state": "ALIVE", "address": tuple(address)})
        self._export("EXPORT_NODE", node_id=nid.hex(), state="ALIVE",
                     address=list(address), resources=dict(resources))
        logger.info("node %s registered at %s", nid.hex()[:8], address)
        # Re-registration after a GCS restart: the raylet reports what it
        # still hosts so replayed records can be re-confirmed instead of
        # restarted (reference: raylet re-report on NotifyGCSRestart).
        stale_workers: List[bytes] = []
        for info in live_actors or []:
            rec = self._actors.get(ActorID(info["actor_id"]))
            # Only actors still awaiting reconfirmation may be reclaimed: a
            # raylet that re-registers AFTER the reconcile window must not
            # re-point a record the reconciler already failed over (that
            # incarnation may be restarting elsewhere — reclaiming it would
            # leave two live copies with clients routed to the stale one).
            # The stale copy can't just be skipped either: left alone it
            # would run forever holding its lease, so it is killed here.
            if rec is None or rec.actor_id not in self._unconfirmed_actors:
                stale_workers.append(info["worker_id"])
                continue
            rec.state = ACTOR_ALIVE
            rec.node_id = nid
            rec.worker_id = WorkerID(info["worker_id"])
            rec.address = info["address"] and tuple(info["address"])
            self._unconfirmed_actors.discard(rec.actor_id)
            self._persist_actor(rec)
            self._publish_actor(rec)
        stale_pgs = []
        for info in held_bundles or []:
            rec = self._pgs.get(PlacementGroupID(info["pg_id"]))
            if rec is None or rec.state != PG_CREATED:
                # the PG was removed, or is being rescheduled from scratch:
                # the raylet's surviving allocations must be freed, not kept
                stale_pgs.append(info["pg_id"])
                continue
            for idx in info["indices"]:
                # only fill unclaimed slots — never steal a slot the
                # reconciler already rescheduled onto another node
                if 0 <= idx < len(rec.bundle_nodes) and rec.bundle_nodes[idx] is None:
                    rec.bundle_nodes[idx] = nid
            self._persist_pg(rec)
        if stale_pgs or stale_workers:
            handle = self._raylets.get(nid)

            async def drop_stale(handle=handle, pgs=stale_pgs,
                                 workers=stale_workers):
                for pg_raw in pgs:
                    try:
                        await handle.client.call_async(
                            "return_bundles", pg_id=pg_raw, timeout=10.0)
                    except Exception:  # noqa: BLE001
                        pass
                for wid_raw in workers:
                    try:
                        await handle.client.call_async(
                            "kill_worker", worker_id=wid_raw, timeout=10.0)
                    except Exception:  # noqa: BLE001
                        pass

            if handle is not None:
                self._io.spawn_threadsafe(drop_stale())
        self._kick_pending()
        return {"ok": True, "system_config": GLOBAL_CONFIG.system_config_json()}

    async def _reconcile_after_restart(self):
        """After a restart, give surviving raylets one reconnect window, then
        fail over whatever nobody re-claimed: ALIVE actors on missing nodes
        restart through the normal budgeted path; CREATED PGs with unclaimed
        bundles go back through 2PC scheduling."""
        await asyncio.sleep(GLOBAL_CONFIG.get("gcs_restart_reconcile_delay_s"))
        if self._stopped:
            return
        for aid in list(self._unconfirmed_actors):
            # Re-check membership at each step: _schedule_actor below awaits
            # RPCs, and a raylet's h_register_node may reclaim a later entry
            # of this snapshot meanwhile — failing that one over too would
            # fork the actor into two live copies.
            if aid not in self._unconfirmed_actors:
                continue
            self._unconfirmed_actors.discard(aid)
            rec = self._actors.get(aid)
            if rec is not None and rec.state == ACTOR_ALIVE:
                await self._on_actor_failure(
                    rec, "hosting node lost across GCS restart")
        for rec in list(self._pgs.values()):
            if rec.state == PG_CREATED and any(n is None for n in rec.bundle_nodes):
                # tear down surviving partial placements, then reschedule
                for nid in {n for n in rec.bundle_nodes if n is not None}:
                    handle = self._raylets.get(nid)
                    if handle:
                        try:
                            await handle.client.call_async(
                                "return_bundles", pg_id=rec.pg_id.binary(),
                                timeout=10.0)
                        except Exception:  # noqa: BLE001
                            pass
                rec.state = PG_RESCHEDULING
                rec.bundle_nodes = [None] * len(rec.bundles)
                self._persist_pg(rec)
                self._pending_pg_queue.append(rec.pg_id)
        self._kick_pending()

    async def h_unregister_node(self, node_id: bytes):
        nid = NodeID(node_id)
        await self._on_node_dead(nid, "unregistered")
        return True

    async def h_report_resources(self, node_id: bytes, snapshot: dict, seq: int,
                                 stats: Optional[dict] = None):
        nid = NodeID(node_id)
        entry = self.view.get(nid)
        if entry is None:
            return {"ok": False, "unknown": True}  # raylet should re-register
        if stats is not None:
            # per-node system stats (mem/load/workers) for the dashboard's
            # node view + per-node Prometheus gauges (reference: per-node
            # metrics agents, dashboard/modules/reporter)
            self._node_stats[nid] = stats
        self.view.update_resources(nid, snapshot, seq)
        self.publisher.publish("resources", nid.hex(), {"snapshot": snapshot, "seq": seq})
        self._kick_pending()
        return {"ok": True}

    async def h_get_all_nodes(self):
        return [
            {
                "node_id": e.node_id.binary(),
                "address": e.address,
                "alive": e.alive,
                "resources": e.resources.snapshot(),
                "object_store_address": e.object_store_address,
                "transfer_address": e.transfer_address,
                "stats": self._node_stats.get(e.node_id, {}),
            }
            for e in self.view.all_nodes()
        ]

    async def h_get_cluster_resources(self):
        return {
            "total": self.view.total_resources(),
            "available": self.view.available_resources(),
        }

    async def h_check_alive(self, node_ids: List[bytes]):
        out = []
        for raw in node_ids:
            e = self.view.get(NodeID(raw))
            out.append(bool(e and e.alive))
        return out

    # -------------------------------------------------- object locations
    async def h_object_locations_update(self, updates: List[dict]):
        """Owner-coalesced location churn (one RPC per flush window, not
        per object — the PR-7 coalesced-pubsub discipline).  Each update:
        ``{"op": "add"|"remove"|"spill", "object_id", "node_id",
        "address"?, "size"?}``; node_id/address describe the COPY, not
        the owner."""
        events = []
        for u in updates:
            oid = u["object_id"]
            op = u.get("op", "add")
            if op == "remove" and "node_id" not in u:
                # owner freed the object: every copy's entry dies with it
                if self._object_locations.pop(oid, None) is not None:
                    events.append({"op": "remove", "object_id": oid})
                continue
            nid_hex = u["node_id"].hex() if isinstance(u["node_id"], bytes) \
                else str(u["node_id"])
            locs = self._object_locations.setdefault(oid, {})
            if op == "remove":
                locs.pop(nid_hex, None)
                if not locs:
                    self._object_locations.pop(oid, None)
            else:
                loc = locs.setdefault(nid_hex, {})
                if u.get("address") is not None:
                    loc["address"] = tuple(u["address"])
                if u.get("size") is not None:
                    loc["size"] = int(u["size"])
                loc["spilled"] = bool(op == "spill" or loc.get("spilled"))
                if op == "add":
                    loc["spilled"] = False  # re-sealed after a demotion
            events.append({"op": op, "object_id": oid, "node_id": nid_hex})
        # one batched publication per flush (Publisher coalesces wakeups)
        for ev in events:
            self.publisher.publish("object_loc", ev["object_id"].hex()
                                   if isinstance(ev["object_id"], bytes)
                                   else str(ev["object_id"]), ev)
        return {"ok": True, "applied": len(events)}

    async def h_get_object_locations(self, object_ids: List[bytes]):
        """Bulk cold-path resolution: oid-hex -> [{node_id, address,
        spilled, size}] for every known copy, live nodes only."""
        out = {}
        for oid in object_ids:
            locs = self._object_locations.get(oid)
            if not locs:
                continue
            rows = []
            for nid_hex, loc in locs.items():
                e = self.view.get(NodeID.from_hex(nid_hex))
                if e is None or not e.alive:
                    continue
                rows.append({"node_id": nid_hex,
                             "address": loc.get("address")
                             or (e.transfer_address and
                                 tuple(e.transfer_address)),
                             "spilled": bool(loc.get("spilled")),
                             "size": loc.get("size")})
            if rows:
                out[oid.hex()] = rows
        return out

    def _drop_node_locations(self, nid: NodeID) -> None:
        nid_hex = nid.hex()
        for oid in list(self._object_locations):
            locs = self._object_locations[oid]
            if locs.pop(nid_hex, None) is not None and not locs:
                del self._object_locations[oid]

    async def _health_loop(self):
        period = GLOBAL_CONFIG.get("health_check_period_ms") / 1000.0
        threshold = GLOBAL_CONFIG.get("health_check_failure_threshold")
        await asyncio.sleep(GLOBAL_CONFIG.get("health_check_initial_delay_ms") / 1000.0)
        misses: Dict[NodeID, int] = {}
        while not self._stopped:
            for entry in list(self.view.alive_nodes()):
                handle = self._raylets.get(entry.node_id)
                if handle is None:
                    continue
                try:
                    await handle.client._client.call_async(
                        "health_check", timeout=GLOBAL_CONFIG.get("health_check_timeout_ms") / 1000.0
                    )
                    misses[entry.node_id] = 0
                except Exception:  # noqa: BLE001
                    misses[entry.node_id] = misses.get(entry.node_id, 0) + 1
                    if misses[entry.node_id] >= threshold:
                        await self._on_node_dead(entry.node_id, "health check failed")
            await asyncio.sleep(period)

    async def _on_node_dead(self, nid: NodeID, reason: str):
        entry = self.view.mark_dead(nid)
        if entry is None:
            return
        logger.warning("node %s dead: %s", nid.hex()[:8], reason)
        handle = self._raylets.pop(nid, None)
        if handle:
            handle.close()
        self.publisher.publish("node", nid.hex(), {"state": "DEAD", "reason": reason})
        self._export("EXPORT_NODE", node_id=nid.hex(), state="DEAD",
                     reason=reason)
        # its object copies died with it: pullers must not be routed there
        self._drop_node_locations(nid)
        # fail over actors that lived there
        for rec in list(self._actors.values()):
            if rec.node_id == nid and rec.state in (ACTOR_ALIVE, ACTOR_PENDING, ACTOR_RESTARTING):
                await self._on_actor_failure(rec, f"node died: {reason}")
        # reschedule PG bundles that lived there
        for pg in list(self._pgs.values()):
            if pg.state in (PG_CREATED, PG_PENDING) and any(b == nid for b in pg.bundle_nodes):
                pg.state = PG_RESCHEDULING
                pg.bundle_nodes = [None if b == nid else b for b in pg.bundle_nodes]
                self._persist_pg(pg)
                self._publish_pg(pg)
                self._pending_pg_queue.append(pg.pg_id)
        self._kick_pending()

    # ------------------------------------------------------------------ jobs
    async def h_get_next_job_id(self):
        self._job_counter += 1
        if self.storage is not None:
            self.storage.put("meta", b"job_counter", {"value": self._job_counter})
        return JobID.from_int(self._job_counter).binary()

    async def h_register_job(self, job_id: bytes, driver_address=None, entrypoint: str = ""):
        jid = JobID(job_id)
        self._jobs[jid] = JobRecord(jid, driver_address and tuple(driver_address), time.time(), entrypoint=entrypoint)
        self._persist_job(self._jobs[jid])
        self.publisher.publish("job", jid.hex(), {"state": "RUNNING"})
        self._export("EXPORT_JOB", job_id=jid.hex(), state="RUNNING",
                     entrypoint=entrypoint)
        return True

    async def h_finish_job(self, job_id: bytes):
        jid = JobID(job_id)
        rec = self._jobs.get(jid)
        if rec:
            rec.state = "FINISHED"
            self._persist_job(rec)
            self.publisher.publish("job", jid.hex(), {"state": "FINISHED"})
            self._export("EXPORT_JOB", job_id=jid.hex(), state="FINISHED")
        # tear down the job's detached=False actors
        for actor in list(self._actors.values()):
            if actor.job_id == jid and actor.state not in (ACTOR_DEAD,):
                await self._kill_actor_internal(actor, "job finished")
        return True

    async def _driver_health_loop(self):
        """Finish jobs whose driver died without calling finish_job (SIGKILL,
        SIGTERM mid-sleep, crashed client session driver): otherwise the
        job's actors hold their resources forever and starve the cluster.
        Reference: the GCS job manager observes driver disconnects
        (gcs/gcs_server/gcs_job_manager.cc) and runs the same teardown as a
        graceful exit."""
        period = GLOBAL_CONFIG.get("health_check_period_ms") / 1000.0
        threshold = GLOBAL_CONFIG.get("health_check_failure_threshold")
        timeout = GLOBAL_CONFIG.get("health_check_timeout_ms") / 1000.0
        misses: Dict[JobID, int] = {}
        clients: Dict[JobID, RpcClient] = {}
        while not self._stopped:
            await asyncio.sleep(period)
            for jid, rec in list(self._jobs.items()):
                if rec.state != "RUNNING" or not rec.driver_address:
                    c = clients.pop(jid, None)
                    if c is not None:
                        c.close()
                    misses.pop(jid, None)
                    continue
                client = clients.get(jid)
                if client is None:
                    # plain RpcClient: each miss must count toward the
                    # threshold, so no retry layer (it reconnects per call)
                    client = RpcClient(tuple(rec.driver_address))
                    clients[jid] = client
                try:
                    await client.call_async("ping", timeout=timeout)
                    misses[jid] = 0
                    continue
                except Exception:  # noqa: BLE001 — count toward threshold
                    misses[jid] = misses.get(jid, 0) + 1
                    if misses[jid] < threshold:
                        continue
                logger.warning(
                    "driver of job %s unreachable x%d; finishing job",
                    jid.hex()[:8], misses[jid])
                try:
                    await self.h_finish_job(jid.binary())
                except Exception:  # noqa: BLE001 — teardown failure must
                    # not kill this loop; the job stays RUNNING and the
                    # finish is retried at the next threshold crossing
                    logger.exception("finishing job %s failed", jid.hex()[:8])
                c = clients.pop(jid, None)
                if c is not None:
                    c.close()
                misses.pop(jid, None)

    async def h_get_all_jobs(self):
        return [
            {"job_id": j.job_id.hex(), "state": j.state, "start_time": j.start_time,
             "entrypoint": j.entrypoint}
            for j in self._jobs.values()
        ]

    # ---------------------------------------------------------------- actors
    async def h_register_actor(self, creation_spec: bytes, actor_id: bytes, job_id: bytes,
                               name: Optional[str] = None, namespace: str = "default",
                               max_restarts: int = 0):
        aid = ActorID(actor_id)
        if name is not None:
            key = (namespace, name)
            if key in self._named_actors:
                existing = self._actors.get(self._named_actors[key])
                if existing is not None and existing.state != ACTOR_DEAD:
                    return {"ok": False, "error": f"actor name {name!r} taken"}
            self._named_actors[key] = aid
        rec = ActorRecord(
            actor_id=aid, job_id=JobID(job_id), name=name,
            namespace=namespace,
            creation_spec=creation_spec, max_restarts=max_restarts,
        )
        self._actors[aid] = rec
        self._persist_actor(rec)
        # Registration returns immediately (reference semantics: actor
        # creation is ASYNC — ActorClass.remote() must not block the driver
        # for the whole spawn chain); scheduling proceeds concurrently, so
        # a burst of creations parallelizes across the worker pool's
        # startup concurrency instead of serializing end-to-end.
        self._io.spawn(self._schedule_actor(rec))
        return {"ok": True}

    async def h_register_actors(self, specs: List[dict], job_id: bytes):
        """Coalesced unnamed-actor registration: one RPC registers a whole
        burst of creations (the driver batches per loop tick).  Named
        actors keep the per-actor RPC — their callers need the synchronous
        name-collision ack."""
        jid = JobID(job_id)
        errors: List[str] = []
        for e in specs:
            try:
                rec = ActorRecord(
                    actor_id=ActorID(e["actor_id"]), job_id=jid, name=None,
                    namespace=e.get("namespace", "default"),
                    creation_spec=e["creation_spec"],
                    max_restarts=e.get("max_restarts", 0),
                )
                self._actors[rec.actor_id] = rec
                self._persist_actor(rec)
                self._io.spawn(self._schedule_actor(rec))
            except Exception as ex:  # noqa: BLE001 — one bad spec must not
                # poison the rest of the batch
                errors.append(f"{e.get('actor_id', b'').hex()}: {ex!r}")
        return {"ok": not errors, "errors": errors}

    def _bundle_node(self, strategy) -> Optional[NodeEntry]:
        """The node holding the placement-group bundle an actor asks for.
        The bundle reserved its resources there, so the node's free
        resources, which ``pick_node`` weighs, may no longer show them: on
        a node of one GPU, a GPU bundle leaves 0 free, and an actor of that
        bundle waited for ever once the node's report of the reservation
        reached the GCS before the actor did. The raylet checks the
        bundle's own availability."""
        from ray_tpu_torch.common.task_spec import PlacementGroupStrategy

        if not isinstance(strategy, PlacementGroupStrategy) \
                or strategy.bundle_index < 0:
            return None
        pg = self._pgs.get(strategy.placement_group_id)
        if pg is None or pg.state != PG_CREATED \
                or strategy.bundle_index >= len(pg.bundle_nodes):
            return None
        nid = pg.bundle_nodes[strategy.bundle_index]
        entry = self.view.get(nid) if nid is not None else None
        return entry if entry is not None and entry.alive else None

    async def _schedule_actor(self, rec: ActorRecord):
        """GcsActorScheduler equivalent: pick node, ask its raylet to start the
        actor (raylet owns worker pool + resource accounting)."""
        import pickle

        spec = pickle.loads(rec.creation_spec)
        node = self._bundle_node(spec.scheduling_strategy)
        if node is None:
            node = policies.pick_node(self.view, spec.required_resources,
                                      spec.scheduling_strategy)
        if node is None:
            if rec.actor_id not in self._pending_actor_queue:
                self._pending_actor_queue.append(rec.actor_id)
            return
        handle = self._raylets.get(node.node_id)
        if handle is None:
            return
        rec.node_id = node.node_id
        self._persist_actor(rec)
        try:
            reply = await handle.client.call_async(
                "start_actor", creation_spec=rec.creation_spec, timeout=60.0
            )
        except Exception as e:  # noqa: BLE001
            logger.warning("start_actor on %s failed: %s", node.node_id.hex()[:8], e)
            self._pending_actor_queue.append(rec.actor_id)
            return
        if not reply.get("ok"):
            if reply.get("fatal"):
                # e.g. runtime-env setup failure: retrying placement can
                # never succeed — fail the actor with the cause
                rec.max_restarts = rec.num_restarts
                await self._on_actor_failure(rec, reply.get("reason", "fatal"))
                return
            if rec.actor_id not in self._pending_actor_queue:
                self._pending_actor_queue.append(rec.actor_id)

    async def h_report_actor_state(self, actor_id: bytes, state: str,
                                   worker_id: Optional[bytes] = None,
                                   address=None, node_id: Optional[bytes] = None,
                                   death_cause: str = "",
                                   fast_port: Optional[int] = None):
        rec = self._actors.get(ActorID(actor_id))
        if rec is None:
            return False
        if state == ACTOR_ALIVE:
            rec.state = ACTOR_ALIVE
            rec.worker_id = worker_id and WorkerID(worker_id)
            rec.address = address and tuple(address)
            rec.fast_port = fast_port
            if node_id:
                rec.node_id = NodeID(node_id)
            self._unconfirmed_actors.discard(rec.actor_id)
            self._persist_actor(rec)
        elif state == ACTOR_DEAD:
            # Idempotency: a death report is only valid once per worker
            # incarnation — RPC retries deliver duplicates, which must not
            # burn the restart budget twice.
            wid = worker_id and WorkerID(worker_id)
            if wid is not None and wid in rec.handled_deaths:
                return True
            if rec.state == ACTOR_ALIVE:
                if wid is not None and rec.worker_id is not None and wid != rec.worker_id:
                    return True  # stale report about an older incarnation
            elif rec.state != ACTOR_PENDING:  # RESTARTING/DEAD: stale
                return True
            if wid is not None:
                rec.handled_deaths.add(wid)
            await self._on_actor_failure(rec, death_cause or "worker died")
            return True
        self._publish_actor(rec)
        return True

    async def _on_actor_failure(self, rec: ActorRecord, cause: str):
        if rec.state == ACTOR_DEAD:
            return
        if rec.num_restarts < rec.max_restarts or rec.max_restarts < 0:
            rec.num_restarts += 1
            rec.state = ACTOR_RESTARTING
            rec.address = None
            rec.worker_id = None
            self._persist_actor(rec)
            self._publish_actor(rec)
            await self._schedule_actor(rec)
        else:
            rec.state = ACTOR_DEAD
            rec.death_cause = cause
            self._persist_actor(rec)
            self._publish_actor(rec)

    async def h_get_actor(self, actor_id: bytes):
        rec = self._actors.get(ActorID(actor_id))
        return rec and rec.public_view()

    async def h_get_actor_by_name(self, name: str, namespace: str = "default"):
        aid = self._named_actors.get((namespace, name))
        if aid is None:
            return None
        rec = self._actors.get(aid)
        return rec and rec.public_view()

    async def h_list_actors(self):
        return [r.public_view() for r in self._actors.values()]

    async def h_kill_actor(self, actor_id: bytes, no_restart: bool = True):
        rec = self._actors.get(ActorID(actor_id))
        if rec is None:
            return False
        await self._kill_actor_internal(rec, "killed via kill_actor", no_restart=no_restart)
        return True

    async def _kill_actor_internal(self, rec: ActorRecord, cause: str, no_restart: bool = True):
        if no_restart:
            rec.max_restarts = rec.num_restarts  # exhaust restart budget
        node = rec.node_id and self._raylets.get(rec.node_id)
        if node is not None and rec.worker_id is not None:
            try:
                await node.client.call_async(
                    "kill_worker", worker_id=rec.worker_id.binary(), timeout=5.0
                )
            except Exception:  # noqa: BLE001
                pass
        await self._on_actor_failure(rec, cause)

    # --------------------------------------------------------------- PGs/2PC
    async def h_create_placement_group(self, pg_id: bytes, bundles: List[dict], strategy: str,
                                       name: Optional[str] = None, job_id: Optional[bytes] = None):
        pgid = PlacementGroupID(pg_id)
        rec = PgRecord(
            pg_id=pgid, name=name,
            bundles=[ResourceRequest.from_dict(b) for b in bundles],
            strategy=strategy,
            bundle_nodes=[None] * len(bundles),
            creator_job=job_id and JobID(job_id),
        )
        self._pgs[pgid] = rec
        self._persist_pg(rec)
        await self._schedule_pg(rec)
        return {"ok": True, "state": rec.state}

    async def _schedule_pg(self, rec: PgRecord):
        placement = policies.place_bundles(self.view, rec.bundles, rec.strategy)
        if placement is None:
            if rec.pg_id not in self._pending_pg_queue:
                self._pending_pg_queue.append(rec.pg_id)
            return
        # 2PC (reference: gcs_placement_group_scheduler.h:122-124): prepare all,
        # then commit all; any prepare failure returns the prepared ones.
        by_node: Dict[NodeID, List[int]] = {}
        for idx, nid in enumerate(placement):
            by_node.setdefault(nid, []).append(idx)
        prepared: List[NodeID] = []
        ok = True
        for nid, idxs in by_node.items():
            handle = self._raylets.get(nid)
            if handle is None:
                ok = False
                break
            try:
                res = await handle.client.call_async(
                    "prepare_bundles",
                    pg_id=rec.pg_id.binary(),
                    bundles={i: rec.bundles[i].to_dict() for i in idxs},
                    timeout=30.0,
                )
                if not res:
                    ok = False
                    break
                prepared.append(nid)
            except Exception:  # noqa: BLE001
                ok = False
                break
        if not ok:
            for nid in prepared:
                handle = self._raylets.get(nid)
                if handle:
                    try:
                        await handle.client.call_async(
                            "return_bundles", pg_id=rec.pg_id.binary(), timeout=10.0
                        )
                    except Exception:  # noqa: BLE001
                        pass
            if rec.pg_id not in self._pending_pg_queue:
                self._pending_pg_queue.append(rec.pg_id)
            return
        commit_failed = False
        for nid in by_node:
            handle = self._raylets.get(nid)
            if handle is None:
                commit_failed = True
                continue
            try:
                await handle.client.call_async(
                    "commit_bundles", pg_id=rec.pg_id.binary(), timeout=30.0
                )
            except Exception:  # noqa: BLE001 - unreachable raylet
                commit_failed = True
        if commit_failed:
            # Partial commit must not report CREATED — leases against the
            # uncommitted bundle would queue forever.  Tear down and retry.
            for nid in by_node:
                handle = self._raylets.get(nid)
                if handle:
                    try:
                        await handle.client.call_async(
                            "return_bundles", pg_id=rec.pg_id.binary(), timeout=10.0)
                    except Exception:  # noqa: BLE001
                        pass
            rec.state = PG_RESCHEDULING
            self._persist_pg(rec)
            if rec.pg_id not in self._pending_pg_queue:
                self._pending_pg_queue.append(rec.pg_id)
            return
        rec.bundle_nodes = list(placement)
        rec.state = PG_CREATED
        self._persist_pg(rec)
        self._publish_pg(rec)

    async def h_remove_placement_group(self, pg_id: bytes):
        rec = self._pgs.get(PlacementGroupID(pg_id))
        if rec is None:
            return False
        for nid in set(n for n in rec.bundle_nodes if n is not None):
            handle = self._raylets.get(nid)
            if handle:
                try:
                    await handle.client.call_async(
                        "return_bundles", pg_id=rec.pg_id.binary(), timeout=10.0
                    )
                except Exception:  # noqa: BLE001
                    pass
        rec.state = PG_REMOVED
        self._persist_pg(rec)
        self._publish_pg(rec)
        return True

    async def h_get_placement_group(self, pg_id: bytes):
        rec = self._pgs.get(PlacementGroupID(pg_id))
        return rec and rec.public_view()

    async def h_wait_placement_group_ready(self, pg_id: bytes, timeout_s: float = 30.0):
        pgid = PlacementGroupID(pg_id)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            rec = self._pgs.get(pgid)
            if rec is None:
                return {"ok": False, "error": "no such placement group"}
            if rec.state == PG_CREATED:
                return {"ok": True}
            if rec.state == PG_REMOVED:
                return {"ok": False, "error": "placement group removed"}
            await asyncio.sleep(0.05)
        return {"ok": False, "error": "timeout"}

    async def h_list_placement_groups(self):
        return [r.public_view() for r in self._pgs.values()]

    # ------------------------------------------------------------------- KV
    async def h_kv_put(self, namespace: str, key, value: bytes, overwrite: bool = True):
        return self.kv.put(namespace, key, value, overwrite)

    async def h_kv_get(self, namespace: str, key):
        return self.kv.get(namespace, key)

    async def h_kv_del(self, namespace: str, key):
        return self.kv.delete(namespace, key)

    async def h_kv_keys(self, namespace: str, prefix=b""):
        return self.kv.keys(namespace, prefix)

    async def h_kv_exists(self, namespace: str, key):
        return self.kv.exists(namespace, key)

    async def h_debug_state(self):
        """Control-plane introspection (reference: GCS debug_state dump +
        instrumented_io_context event stats): table sizes plus per-RPC-
        handler loop time, the `ray stack`-style view of where the GCS
        event loop goes."""
        return {
            "num_nodes": sum(1 for _ in self.view.all_nodes()),
            "num_actors": len(self._actors),
            "num_placement_groups": len(self._pgs),
            "num_jobs": len(self._jobs),
            "io_stats": dict(self._io.stats),
        }

    # ----------------------------------------------------------- task events
    async def h_add_task_events(self, events: List[dict]):
        self._task_events.extend(events)
        if len(self._task_events) > 100_000:
            self._task_events = self._task_events[-50_000:]
        return True

    async def h_get_task_events(self, job_id: Optional[bytes] = None, limit: int = 10_000):
        evs = self._task_events
        if job_id is not None:
            jid = JobID(job_id).hex()
            evs = [e for e in evs if e.get("job_id") == jid]
        return evs[-limit:]

    # ---------------------------------------------------------- worker logs
    async def h_publish_worker_log(self, job_id: str, pid: int,
                                   worker_id: str, stream: str,
                                   lines: List[str], actor_name: str = ""):
        """Relay a batch of worker stdout/stderr lines to subscribed
        drivers (reference: log_monitor.py tail → GCS pubsub → driver)."""
        self.publisher.publish("worker_log", job_id or "", {
            "job_id": job_id, "pid": pid, "worker_id": worker_id,
            "stream": stream, "lines": lines, "actor_name": actor_name,
        })
        return True

    # ------------------------------------------------------------------ misc
    async def h_get_system_config(self):
        return GLOBAL_CONFIG.system_config_json()

    async def h_health_check(self):
        return True

    def _kick_pending(self):
        """Retry pending actors/PGs (resources may have freed up)."""
        if not self._pending_actor_queue and not self._pending_pg_queue:
            return

        async def kick():
            actors, self._pending_actor_queue = self._pending_actor_queue, []
            for aid in actors:
                rec = self._actors.get(aid)
                if rec is not None and rec.state in (ACTOR_PENDING, ACTOR_RESTARTING):
                    await self._schedule_actor(rec)
            pgs, self._pending_pg_queue = self._pending_pg_queue, []
            for pgid in pgs:
                rec = self._pgs.get(pgid)
                if rec is not None and rec.state in (PG_PENDING, PG_RESCHEDULING):
                    await self._schedule_pg(rec)

        self._io.spawn_threadsafe(kick())
