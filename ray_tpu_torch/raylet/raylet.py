"""Raylet — the per-node data-plane daemon.

Equivalent of the reference's raylet/NodeManager (src/ray/raylet/node_manager.cc,
raylet/main.cc): owns the worker pool, runs the local half of the two-level
lease scheduler (grant locally / spill to another node / queue), participates
in placement-group 2PC (prepare/commit/return of bundle resources,
raylet/placement_group_resource_manager.cc), reports resources to the GCS, and
detects worker death.

GPU specifics: leased GPUs are exported to the worker as
``CUDA_VISIBLE_DEVICES`` (the reference's accelerator plugin behavior,
python/ray/_private/accelerators/nvidia_gpu.py), and every worker starts with
no GPU visible until a lease grants one. A worker that held GPUs is never
pooled for another lease: CUDA fixes a process's visibility when it first
initialises, so task workers die with their GPU lease as actor workers die
with their actor. Node labels still carry slice topology for gang policies.
"""

from __future__ import annotations

import asyncio
import logging
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.common.config import GLOBAL_CONFIG
from ray_tpu_torch.common.gpu_detect import device_ids_for, visible_device_ids
from ray_tpu_torch.common.ids import NodeID, PlacementGroupID, WorkerID
from ray_tpu_torch.common.resources import (
    CPU,
    LABEL_NODE_ID,
    LABEL_SLICE_NAME,
    LABEL_SLICE_TOPOLOGY,
    NodeResources,
    GPU,
    ResourceRequest,
)
from ray_tpu_torch.gcs.client import GcsClient
from ray_tpu_torch.rpc.rpc import IoContext, RetryableRpcClient, RpcServer
from ray_tpu_torch.scheduling import ClusterView, NodeEntry, policies

logger = logging.getLogger(__name__)


@dataclass
class WorkerHandle:
    worker_id: WorkerID
    proc: Optional[subprocess.Popen]
    address: Optional[Tuple[str, int]] = None  # worker's RPC server
    fast_port: Optional[int] = None  # worker's fastloop dispatch port
    state: str = "STARTING"  # STARTING | IDLE | LEASED | ACTOR | DEAD
    env_key: Optional[str] = None  # runtime-env pool key (None = default env)
    lease_id: Optional[bytes] = None
    assignment: Optional[dict] = None  # unit-resource chip indices
    request: Optional[ResourceRequest] = None
    pg: Optional[Tuple[PlacementGroupID, int]] = None
    actor_id: Optional[bytes] = None
    job_id: Optional[bytes] = None  # job owning the current lease
    idle_since: float = field(default_factory=time.monotonic)
    registered: "asyncio.Event" = field(default_factory=asyncio.Event)
    # factory-forked workers have a bare pid instead of a Popen handle
    factory_pid: Optional[int] = None
    # cached raylet→worker RPC client (connect+HELLO once per worker, not
    # once per actor creation / device grant)
    rpc: Optional[RetryableRpcClient] = None
    # set when the worker is handed out: it may have run user code since
    # (torch.cuda.is_available() fixes CUDA's device list for good), so a
    # GPU lease never gets it
    used: bool = False

    def client(self) -> RetryableRpcClient:
        if self.rpc is None:
            self.rpc = RetryableRpcClient(self.address, deadline_s=30.0)
        return self.rpc

    def close_client(self) -> None:
        if self.rpc is not None:
            try:
                self.rpc.close()
            except Exception:  # noqa: BLE001
                pass
            self.rpc = None

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else self.factory_pid

    def alive(self) -> bool:
        if self.proc is not None:
            return self.proc.poll() is None
        if self.factory_pid is None:
            return False
        try:
            os.kill(self.factory_pid, 0)  # zombies are reaped by the factory
            return True
        except OSError:
            return False

    def exit_reason(self) -> str:
        if self.proc is not None:
            return f"exit code {self.proc.returncode}"
        return "process gone"

    def _signal(self, sig) -> None:
        if self.proc is not None:
            (self.proc.terminate if sig == signal.SIGTERM
             else self.proc.kill)()
        elif self.factory_pid is not None:
            try:
                os.kill(self.factory_pid, sig)
            except OSError:
                pass

    def terminate(self) -> None:
        self._signal(signal.SIGTERM)

    def force_kill(self) -> None:
        self._signal(signal.SIGKILL)

    def wait_dead(self, timeout: float) -> None:
        if self.proc is not None:
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                pass
            return
        deadline = time.monotonic() + timeout
        while self.alive() and time.monotonic() < deadline:
            time.sleep(0.02)


@dataclass
class Bundle:
    request: ResourceRequest
    assignment: Optional[dict]  # chip indices reserved for the bundle
    committed: bool = False
    # lease accounting *within* the bundle
    available: ResourceRequest = None  # type: ignore[assignment]


class Raylet:
    def __init__(
        self,
        gcs_address: Tuple[str, int],
        host: str = "127.0.0.1",
        port: int = 0,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        session_dir: Optional[str] = None,
        fake_worker_env: Optional[Dict[str, str]] = None,
    ):
        self.node_id = NodeID.from_random()
        self.gcs_address = tuple(gcs_address)
        self.server = RpcServer(host, port)
        self._io = IoContext.current()
        # the port's own root (the JAX package's is /tmp/rt): the two
        # packages' sessions and sweeps never meet
        self.session_dir = session_dir or os.path.join(
            tempfile.gettempdir(), "rtt", f"session_{os.getpid()}")
        os.makedirs(self.session_dir, exist_ok=True)

        resources = dict(resources or {})
        resources.setdefault(CPU, float(os.cpu_count() or 1))
        labels = dict(labels or {})
        labels[LABEL_NODE_ID] = self.node_id.hex()
        if GLOBAL_CONFIG.get("tpu_topology") and LABEL_SLICE_TOPOLOGY not in labels:
            labels[LABEL_SLICE_TOPOLOGY] = GLOBAL_CONFIG.get("tpu_topology")
        self.resources = NodeResources(resources, labels)
        self._node_visible_gpus = visible_device_ids()

        self.view = ClusterView()  # replica of the cluster view
        self.gcs = GcsClient(self.gcs_address, client_id=f"raylet-{self.node_id.hex()[:8]}")
        self._workers: Dict[WorkerID, WorkerHandle] = {}
        # Worker IDs this raylet has seen die, kept (bounded) so the
        # liveness probe can distinguish "confirmed dead" from "never
        # hosted here" — owner-fetch fail-fast depends on that answer
        self._dead_workers: Dict[WorkerID, None] = {}
        self._leases: Dict[bytes, WorkerID] = {}
        self._bundles: Dict[PlacementGroupID, Dict[int, Bundle]] = {}
        self._pending_leases: List[dict] = []  # queued lease requests (waiters)
        self._drain_running = False  # single-flight pending-lease drain
        self._drain_again = False
        self._seq = 0
        self._stopped = False
        self._bg_tasks: List = []
        self._fake_worker_env = fake_worker_env or {}
        self._factory = None        # forkserver client (worker_factory.py)
        self._factory_procs: List[subprocess.Popen] = []
        self._refills_inflight = 0  # scheduled pool refills not yet STARTING
        from ray_tpu_torch.runtime_env.agent import RuntimeEnvAgent

        self.runtime_env_agent = RuntimeEnvAgent(self.session_dir)
        from ray_tpu_torch.raylet.memory_monitor import MemoryMonitor

        self.memory_monitor = MemoryMonitor(
            GLOBAL_CONFIG.get("memory_usage_threshold"),
            min_interval_s=GLOBAL_CONFIG.get(
                "memory_monitor_refresh_ms") / 1000.0)
        self._oom_kills = 0
        # warm-pool observability (util/metrics.py): pool depth + hit/miss
        # make actors_per_second regressions attributable — a collapsing
        # pool shows up as a miss streak, not just a slower bench row
        from ray_tpu_torch.util import metrics as _metrics

        self._m_pool_size = _metrics.Gauge(
            "rt_worker_pool_size",
            "warm default-env workers (IDLE registered or STARTING)")
        self._m_pool_hits = _metrics.Counter(
            "rt_worker_pool_hits",
            "worker pops served by a warm pool worker (incl. adoptions)")
        self._m_pool_misses = _metrics.Counter(
            "rt_worker_pool_misses",
            "worker pops that had to fork (or wait for a fork)")
        self._m_pool_adoptions = _metrics.Counter(
            "rt_worker_pool_adoptions",
            "default-env pool workers reassigned to an env_vars/cwd-only "
            "runtime env via the configure_worker handshake")
        # node object transfer service (object_store/transfer.py): started
        # in start() so its port can ride the registration payload
        self._transfer = None
        self.cgroups = None
        if GLOBAL_CONFIG.get("cgroup_isolation_enabled"):
            from ray_tpu_torch.raylet.cgroups import CgroupManager

            mgr = CgroupManager(self.node_id.hex())
            self.cgroups = mgr if mgr.enabled else None
        self._register_handlers()

    # ------------------------------------------------------------------ wiring
    def _register_handlers(self):
        s = self.server
        for name in (
            "health_check", "request_worker_lease",
            "return_worker", "start_actor",
            "kill_worker", "worker_alive", "register_worker",
            "prepare_bundles", "commit_bundles",
            "return_bundles", "get_node_info", "debug_state", "notify_actor_dead",
        ):
            s.register(name, getattr(self, f"h_{name}"))

    def _registration_payload(self) -> dict:
        """What this node tells the GCS at (re-)registration: its shape plus
        everything it still hosts, so a restarted GCS can re-confirm replayed
        actor/PG records instead of failing them over (reference: raylet
        re-report on NotifyGCSRestart, node_manager.proto:397)."""
        live_actors = [
            {"actor_id": w.actor_id, "worker_id": w.worker_id.binary(),
             "address": w.address}
            for w in self._workers.values()
            if w.state == "ACTOR" and w.actor_id is not None
            and w.alive()
        ]
        held_bundles = [
            {"pg_id": pgid.binary(),
             "indices": [i for i, b in bundles.items() if b.committed]}
            for pgid, bundles in self._bundles.items()
        ]
        payload = dict(
            node_id=self.node_id.binary(),
            address=self.server.address,
            resources=self.resources.total.to_dict(),
            labels=self.resources.labels,
            live_actors=live_actors,
            held_bundles=held_bundles,
        )
        if self._transfer is not None:
            payload["transfer_address"] = list(self._transfer.address)
        return payload

    def start(self):
        self.server.start()
        if GLOBAL_CONFIG.get("transfer_service") and \
                GLOBAL_CONFIG.get("shm_store_enabled"):
            from ray_tpu_torch.object_store.transfer import TransferServer

            self._transfer = TransferServer(self.node_id,
                                            host=self.server.address[0])
            self._transfer.start()
        reply = self.gcs.call("register_node", **self._registration_payload())
        GLOBAL_CONFIG.initialize(reply.get("system_config") or "{}")
        GLOBAL_CONFIG.reset_cache()
        # seed the local cluster view, then keep it fresh via pubsub
        for info in self.gcs.get_all_nodes():
            if info["alive"]:
                snap = info["resources"]
                entry = NodeEntry(
                    node_id=NodeID(info["node_id"]),
                    address=tuple(info["address"]),
                    resources=NodeResources.from_snapshot(snap),
                )
                self.view.upsert(entry)
        self.gcs.subscriber.subscribe("resources", self._on_resources_update)
        self.gcs.subscriber.subscribe("node", self._on_node_update)
        self.gcs.subscriber.subscribe("job", self._on_job_update)
        self._io.spawn_threadsafe(self._report_loop())
        self._io.spawn_threadsafe(self._reap_loop())
        if GLOBAL_CONFIG.get("worker_factory_enabled"):
            self._start_factory()
        n_prestart = GLOBAL_CONFIG.get("num_prestart_workers")
        if n_prestart > 0:
            # warm pool: actor/task creation becomes a registration
            # handshake instead of an interpreter boot (reference:
            # worker_pool prestart)
            async def prestart():
                for _ in range(n_prestart):
                    try:
                        await self._start_worker()
                    except Exception:  # noqa: BLE001 — warm pool is optional
                        logger.debug("prestart failed", exc_info=True)
                        return

            self._io.spawn_threadsafe(prestart())
        logger.info("raylet %s serving at %s", self.node_id.hex()[:8], self.server.address)

    def _replenish_pool(self):
        """Keep ``num_prestart_workers`` warm default-env workers forked in
        the BACKGROUND: sustained actor churn then pipelines interpreter
        forks behind control-plane work instead of paying them on every
        creation's critical path (reference: worker_pool.cc
        PrestartWorkers on demand-prediction).

        Replenishment is CONCURRENT up to the node-wide fork cap: a burst
        of creations larger than the pool used to serialize behind one
        fork per consumed worker (the round-5 cold-start hole) — now the
        whole deficit forks at once and the pool refills in one fork
        latency instead of ``deficit`` of them."""
        target = GLOBAL_CONFIG.get("num_prestart_workers")
        if target <= 0 or self._stopped:
            return
        if self._factory is None:
            # no warm forkserver attached (yet): a proactive refill would
            # exec-spawn a full interpreter (~1.5 s CPU) per consumed
            # worker — short-lived clusters (tests) must not pay that;
            # demand-driven pops still spawn as before
            return
        warm = sum(1 for w in self._workers.values()
                   if w.env_key is None
                   and (w.state == "STARTING"  # pid may not be known yet
                        or (w.state == "IDLE" and w.alive())))
        self._m_pool_size.set(warm)
        # refills already scheduled but not yet visible as STARTING
        # handles (the factory spawn hasn't returned a pid yet) count
        # toward the deficit, or a pop burst schedules the whole deficit
        # once per pop and overshoots the watermark
        inflight = getattr(self, "_refills_inflight", 0)
        deficit = target - warm - inflight
        if deficit <= 0:
            return
        starting = sum(1 for w in self._workers.values()
                       if w.state == "STARTING")
        slots = max(0, GLOBAL_CONFIG.get("maximum_startup_concurrency")
                    - starting - inflight)
        n = min(deficit, slots)
        if n <= 0:
            return
        self._refills_inflight = inflight + n

        async def refill():
            try:
                await self._start_worker()
            except Exception:  # noqa: BLE001 — warm pool is best-effort
                logger.debug("pool replenish failed", exc_info=True)
            finally:
                self._refills_inflight -= 1

        for _ in range(n):
            self._io.spawn_threadsafe(refill())

    def _start_factory(self):
        """Boot the forkserver worker factories (worker_factory.py): warm
        interpreters whose forks cut worker creation from interpreter-boot
        cost to ~fork cost. ``worker_factory_procs`` of them run side by
        side — fork(2) serializes inside one address space (~12 ms per
        fork of a warm interpreter here), so parallel factories are what
        raise the sustained worker-supply ceiling that actor churn rides."""
        from ray_tpu_torch.raylet.worker_factory import (FactoryClient,
                                                         MultiFactoryClient)

        n = max(1, GLOBAL_CONFIG.get("worker_factory_procs"))
        # the factory forks every worker: it must never see (or create a
        # context on) a GPU, and its children start with none visible
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        if pkg_root not in env.get("PYTHONPATH", "").split(os.pathsep):
            env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                                 if env.get("PYTHONPATH") else pkg_root)
        log_path = os.path.join(self.session_dir, "worker_factory.log")
        socks = []
        self._factory_procs = []
        for i in range(n):
            sock = os.path.join(
                self.session_dir,
                f"factory_{self.node_id.hex()[:8]}_{i}.sock")
            socks.append(sock)
            self._factory_procs.append(subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.raylet.worker_factory",
                 sock],
                env=env, stdout=open(log_path, "ab"),
                stderr=subprocess.STDOUT))

        def wait_ready(procs=list(self._factory_procs)):
            # Non-blocking adoption: raylet startup (and anything timing
            # it, e.g. the autoscaler's launch bookkeeping) must not stall
            # on interpreter boot; workers exec-spawn until the factory
            # sockets are up, then forks take over. Factories that come
            # up are adopted incrementally.
            deadline = time.monotonic() + 30.0
            ready: list = []
            waiting = list(zip(procs, socks))
            while waiting and time.monotonic() < deadline \
                    and not self._stopped:
                still = []
                for proc, sock in waiting:
                    if os.path.exists(sock):
                        ready.append(FactoryClient(sock))
                        if self._factory_procs and not self._stopped:
                            self._factory = MultiFactoryClient(ready)
                    elif proc.poll() is None:
                        still.append((proc, sock))
                waiting = still
                if waiting:
                    time.sleep(0.05)
            if not ready:
                logger.warning("worker factory failed to start; "
                               "exec spawning stays in effect")
            else:
                logger.debug("%d worker factories up", len(ready))

        import threading as _threading

        _threading.Thread(target=wait_ready, daemon=True,
                          name="factory-wait").start()

    def stop(self):
        self._stopped = True
        if self._transfer is not None:
            self._transfer.stop()
            self._transfer = None
        store = getattr(self, "_shm_stats_store", None)
        if store is not None:
            self._shm_stats_store = None
            try:
                store.close()  # free the fixed-size per-process handle slot
            except Exception:  # noqa: BLE001
                pass
        for t in self._bg_tasks:
            t.cancel()
        for w in list(self._workers.values()):
            if w.alive():
                w.terminate()
        for w in list(self._workers.values()):
            w.wait_dead(3.0)
            if w.alive():
                w.force_kill()
        if getattr(self, "_factory", None) is not None:
            self._factory.shutdown()
            self._factory = None
        for proc in getattr(self, "_factory_procs", []):
            proc.terminate()
            try:
                proc.wait(timeout=3)
            except subprocess.TimeoutExpired:
                proc.kill()
        self._factory_procs = []
        self.gcs.close()
        self.server.stop()
        if self.cgroups is not None:
            self.cgroups.cleanup()
        # reclaim this node's shm object-store segment (every raylet owns
        # its node's segment — not just the head; tmpfs leaks are RAM leaks)
        try:
            from ray_tpu_torch.object_store.shm import node_shm_name
            from ray_tpu_torch.object_store.shm import unlink as shm_unlink

            shm_unlink(node_shm_name(self.node_id))
        except Exception:  # noqa: BLE001
            pass

    # ------------------------------------------------------- cluster view sync
    def _on_resources_update(self, node_hex: str, msg: dict):
        nid = NodeID.from_hex(node_hex)
        if nid == self.node_id:
            return
        entry = self.view.get(nid)
        if entry is None:
            return
        self.view.update_resources(nid, msg["snapshot"], msg["seq"])
        self._io.loop.call_soon_threadsafe(self._try_grant_pending)

    def _on_job_update(self, job_hex: str, msg: dict):
        """A finished job's leased workers must be reclaimed: the driver
        died or exited, nobody will return those leases, and the held CPUs
        would starve the cluster (reference: the raylet kills a dead job's
        workers — worker_pool.cc HandleJobFinished)."""
        if (msg or {}).get("state") != "FINISHED":
            return

        async def reclaim():
            try:
                job_raw = bytes.fromhex(job_hex)
            except ValueError:
                return
            for w in list(self._workers.values()):
                if (w.job_id == job_raw and w.lease_id is not None
                        and w.state != "DEAD"):
                    logger.info("reclaiming worker %s leased by finished "
                                "job %s", w.worker_id.hex()[:8], job_hex[:8])
                    # account first (frees lease, reports actor death),
                    # then terminate the process
                    await self._on_worker_dead(w, "job finished")
                    self._kill_worker_proc(w)
            # queued lease requests from the dead job will never be
            # collected either — fail them out of the queue
            for item in self._pending_leases:
                if item.get("job_id") == job_raw and not item["future"].done():
                    item["future"].set_result({"status": "job_finished"})

        self._io.spawn_threadsafe(reclaim())

    def _on_node_update(self, node_hex: str, msg: dict):
        nid = NodeID.from_hex(node_hex)
        if msg.get("state") == "DEAD":
            self.view.mark_dead(nid)
        elif msg.get("state") == "ALIVE" and nid != self.node_id:
            entry = self.view.get(nid)
            if entry is None:
                # fetch details lazily on next report; register placeholder
                self.view.upsert(
                    NodeEntry(node_id=nid, address=tuple(msg["address"]),
                              resources=NodeResources({}))
                )

    def _system_stats(self) -> dict:
        """Per-node system stats shipped with every resource report —
        the dashboard's node view + per-node Prometheus gauges come from
        here (reference: per-node reporter agents,
        ``dashboard/modules/reporter/reporter_agent.py``)."""
        import os as _os

        from ray_tpu_torch.raylet.memory_monitor import system_memory

        used, total = system_memory()
        try:
            load1 = _os.getloadavg()[0]
        except OSError:
            load1 = 0.0
        out = {
            "mem_used_bytes": used,
            "mem_total_bytes": total,
            "cpu_load_1m": load1,
            "num_workers": len(self._workers),
            "num_pending_leases": len(self._pending_leases),
        }
        # native shm object-store occupancy (rts_stats) — the node-local
        # plasma equivalent's capacity/used/object-count. Handle opened
        # once and cached (the report loop runs every 100ms).
        try:
            store = getattr(self, "_shm_stats_store", None)
            if store is None:
                from ray_tpu_torch.object_store.shm import (ShmObjectStore,
                                                      node_shm_name)

                store = ShmObjectStore(
                    node_shm_name(self.node_id), create=False)
                self._shm_stats_store = store
            cap, used_b, n_obj = store.stats()
            out["object_store_capacity_bytes"] = cap
            out["object_store_used_bytes"] = used_b
            out["object_store_num_objects"] = n_obj
        except Exception:  # noqa: BLE001 — store may be disabled
            pass
        return out

    async def _report_loop(self):
        period = GLOBAL_CONFIG.get("raylet_report_resources_period_ms") / 1000.0
        while not self._stopped:
            self._seq += 1
            try:
                # stats come from /proc + shm reads — OFF the loop: under
                # fork churn those reads take tens of ms in the kernel,
                # and on the loop they were ~45% of sampled loop time
                # (stalling every lease grant and worker registration)
                stats = await asyncio.to_thread(self._system_stats)
                reply = await self.gcs.call_async(
                    "report_resources",
                    node_id=self.node_id.binary(),
                    snapshot=self.resources.snapshot(),
                    seq=self._seq,
                    stats=stats,
                )
                if isinstance(reply, dict) and reply.get("unknown"):
                    # GCS restarted and lost us: re-register with live state
                    await self.gcs.call_async(
                        "register_node", **self._registration_payload())
            except Exception:  # noqa: BLE001 - GCS may be restarting
                pass
            # keep our own entry in the local view fresh for spillback scoring
            self.view.upsert(
                NodeEntry(
                    node_id=self.node_id,
                    address=self.server.address,
                    resources=self.resources,
                    seq=self._seq,
                )
            )
            await asyncio.sleep(period)

    async def _reap_loop(self):
        """Detect dead worker processes; free leases; reap idle workers;
        relieve memory pressure (reference memory_monitor.h loop)."""
        idle_ttl = GLOBAL_CONFIG.get("idle_worker_killing_time_threshold_ms") / 1000.0
        while not self._stopped:
            for w in list(self._workers.values()):
                if w.state != "DEAD" and (w.pid is not None) \
                        and not w.alive():
                    await self._on_worker_dead(w, w.exit_reason())
            if GLOBAL_CONFIG.get("memory_monitor_enabled"):
                # /proc reads off-loop (same reason as _report_loop)
                pressured, frac = await asyncio.to_thread(
                    self.memory_monitor.is_pressured)
                if pressured:
                    await self._relieve_memory_pressure(frac)
            # reap long-idle workers beyond a small cache
            idle = [w for w in self._workers.values() if w.state == "IDLE"]
            keep = max(2, GLOBAL_CONFIG.get("num_prestart_workers"))
            if len(idle) > keep:
                idle.sort(key=lambda w: w.idle_since)
                now = time.monotonic()
                for w in idle[: len(idle) - keep]:
                    if now - w.idle_since > idle_ttl:
                        self._kill_worker_proc(w)
            await asyncio.sleep(0.2)

    async def _relieve_memory_pressure(self, frac: float):
        """Kill one policy-chosen worker per check (reference
        worker_killing_policy): retriable leased tasks first, newest
        first — converting an imminent kernel OOM into one attributable,
        retriable failure."""
        from ray_tpu_torch.raylet.memory_monitor import pick_victim

        victim = pick_victim(list(self._workers.values()))
        if victim is None:
            return
        self._oom_kills += 1
        logger.warning(
            "memory pressure %.1f%% >= %.1f%%: killing worker %s (%s) "
            "per OOM policy", frac * 100,
            self.memory_monitor.threshold * 100,
            victim.worker_id.hex()[:8], victim.state)
        # kill FIRST, account after: freeing the lease before the hog is
        # dead would re-grant pending work while pressure is still rising,
        # and the cgroup can only be removed once its member is gone
        if victim.alive():
            victim.force_kill()
            import asyncio as _asyncio

            await _asyncio.to_thread(victim.wait_dead, 5.0)
        await self._on_worker_dead(
            victim,
            f"killed by the memory monitor: node memory usage "
            f"{frac:.0%} >= threshold "
            f"{self.memory_monitor.threshold:.0%}")

    @staticmethod
    def _wait_proc(proc, timeout: float):
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass

    def _record_worker_dead(self, worker_id: WorkerID):
        self._dead_workers[worker_id] = None
        while len(self._dead_workers) > 4096:
            self._dead_workers.pop(next(iter(self._dead_workers)))

    async def _on_worker_dead(self, w: WorkerHandle, reason: str):
        if w.state == "DEAD":
            return
        self._record_worker_dead(w.worker_id)
        prev_state = w.state
        w.state = "DEAD"
        w.close_client()
        logger.warning("worker %s dead (%s): %s", w.worker_id.hex()[:8], prev_state, reason)
        if w.lease_id is not None:
            self._free_lease(w)
        if prev_state == "ACTOR":
            self._free_worker_resources(w)
            if w.actor_id is not None:
                try:
                    await self.gcs.call_async(
                        "report_actor_state", actor_id=w.actor_id, state="DEAD",
                        worker_id=w.worker_id.binary(),
                        death_cause=f"worker died: {reason}",
                    )
                except Exception:  # noqa: BLE001
                    pass
        self._workers.pop(w.worker_id, None)
        self.runtime_env_agent.release(w.env_key)
        if self.cgroups is not None:
            self.cgroups.remove_worker_cgroup(w.worker_id.hex())
        self._try_grant_pending()
        # a dead worker may have been the pool's warm capacity (actor
        # churn kills one worker per actor): refill in the background
        self._replenish_pool()

    def _kill_worker_proc(self, w: WorkerHandle):
        self._record_worker_dead(w.worker_id)
        if w.state != "DEAD":
            self.runtime_env_agent.release(w.env_key)
            # killing a live worker MUST return its held resources: this
            # pops the worker from the table, so the reap loop will never
            # run _on_worker_dead for it — without this, every kill of a
            # leased/actor worker (job reclaim, kill_worker RPC, OOM
            # killer) permanently leaks its CPUs/chips
            if w.lease_id is not None:
                self._free_lease(w)
            else:
                self._free_worker_resources(w)
        w.state = "DEAD"
        w.close_client()
        self._workers.pop(w.worker_id, None)
        if w.alive():
            w.terminate()
        self._try_grant_pending()

    # ------------------------------------------------------------ worker pool
    async def _start_worker(self, ctx=None) -> WorkerHandle:
        from ray_tpu_torch.runtime_env.agent import WorkerEnvContext

        ctx = ctx or WorkerEnvContext()
        worker_id = WorkerID.from_random()
        # No GPU is visible until a lease grants one: h_set_visible_devices
        # (or the actor creation push) sets CUDA_VISIBLE_DEVICES before
        # anything in the worker initialises CUDA.
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        env.update(self._fake_worker_env)
        env = ctx.apply(env)
        # the framework itself must stay importable when a runtime env
        # changes cwd (it may only be reachable via the driver's cwd today)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        if pkg_root not in env.get("PYTHONPATH", "").split(os.pathsep):
            env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                                 if env.get("PYTHONPATH") else pkg_root)
        env["RT_WORKER_ID"] = worker_id.hex()
        # spawn timestamp (CLOCK_MONOTONIC is machine-wide): worker_main
        # logs fork→entry latency against it — the part of the supply
        # path that lives outside the worker's own boot trace
        env["RT_SPAWN_T"] = repr(time.monotonic())
        env["RT_RAYLET_ADDR"] = f"{self.server.address[0]}:{self.server.address[1]}"
        env["RT_GCS_ADDR"] = f"{self.gcs_address[0]}:{self.gcs_address[1]}"
        env["RT_NODE_ID"] = self.node_id.hex()
        env["RT_SESSION_DIR"] = self.session_dir
        log_path = os.path.join(self.session_dir, f"worker-{worker_id.hex()[:8]}.log")
        # Default-env workers fork off the warm factory (~10 ms); runtime
        # envs that may swap the interpreter (pip/conda) keep the exec path.
        if self._factory is not None and ctx.env_key is None:
            try:
                pid = await asyncio.to_thread(
                    self._factory.spawn, env, log_path,
                    ctx.cwd or os.getcwd())
                w = WorkerHandle(worker_id=worker_id, proc=None,
                                 factory_pid=pid, env_key=ctx.env_key)
                self.runtime_env_agent.acquire(ctx.env_key)
                if self.cgroups is not None:
                    cg = self.cgroups.create_worker_cgroup(worker_id.hex())
                    if cg is not None:
                        self.cgroups.attach(cg, pid)
                self._workers[worker_id] = w
                logger.debug("factory-forked worker %s (pid %s)",
                             worker_id.hex()[:8], pid)
                return w
            except Exception:  # noqa: BLE001 — fall back to exec spawn
                logger.warning("factory spawn failed; exec fallback",
                               exc_info=True)
        def _exec_spawn():
            # open+fork+exec off-loop: the exec fallback runs whenever no
            # factory is attached (pip/conda envs, early boot) and a fork
            # stalls the IO loop ~10ms (PERF_PLAN round-8 boot trace)
            logfile = open(log_path, "ab")
            try:
                return subprocess.Popen(
                    [sys.executable, "-m",
                     "ray_tpu_torch.core_worker.worker_main"],
                    env=env, stdout=logfile, stderr=subprocess.STDOUT,
                    cwd=ctx.cwd or os.getcwd(),
                )
            finally:
                # the child inherited the fd; the parent copy only leaks
                logfile.close()

        proc = await asyncio.to_thread(_exec_spawn)
        w = WorkerHandle(worker_id=worker_id, proc=proc, env_key=ctx.env_key)
        self.runtime_env_agent.acquire(ctx.env_key)
        if self.cgroups is not None:
            cg = self.cgroups.create_worker_cgroup(worker_id.hex())
            if cg is not None:
                self.cgroups.attach(cg, proc.pid)
        self._workers[worker_id] = w
        logger.debug("forked worker %s (pid %s)", worker_id.hex()[:8], proc.pid)
        return w

    async def h_register_worker(self, worker_id: bytes, address,
                                fast_port: Optional[int] = None):
        w = self._workers.get(WorkerID(worker_id))
        if w is None:
            # worker from a previous life / unknown: tell it to exit
            return {"ok": False}
        w.address = tuple(address)
        w.fast_port = fast_port
        if w.state == "STARTING":
            w.state = "IDLE"
            w.idle_since = time.monotonic()
        w.registered.set()
        logger.debug("worker %s registered at %s", WorkerID(worker_id).hex()[:8], address)
        self._try_grant_pending()
        return {"ok": True}

    async def _pop_worker(self, timeout: float = None, ctx=None,
                          fresh: bool = False) -> Optional[WorkerHandle]:
        """Get an idle registered worker IN THE SAME runtime env (pools are
        keyed by env hash, reference: worker_pool.h), forking if needed.
        ``maximum_startup_concurrency`` caps forks NODE-WIDE, across envs.
        ``fresh`` (GPU leases) takes only a worker that has run nothing:
        CUDA reads CUDA_VISIBLE_DEVICES once, at its first use, and a
        pooled worker may have used it under another visibility.

        Envs that differ from the default only by env_vars/cwd ADOPT a
        warm default-env worker via the configure_worker handshake
        instead of forking; envs needing fork-time state (staged
        PYTHONPATH trees: pip/py_modules/working_dir) are ineligible and
        keep the fork path."""
        timeout = timeout or GLOBAL_CONFIG.get("worker_register_timeout_s")
        env_key = ctx.env_key if ctx is not None else None
        deadline = time.monotonic() + timeout
        missed = False
        while True:
            for w in self._workers.values():
                if (w.state == "IDLE" and w.env_key == env_key
                        and w.alive() and not (fresh and w.used)):
                    w.state = "LEASED"
                    w.used = True
                    if not missed:
                        self._m_pool_hits.inc()
                    if env_key is None:
                        # consumed a warm default-env worker: refill in
                        # the background so the next pop finds one too
                        self._replenish_pool()
                    return w
            if env_key is not None and ctx is not None \
                    and self._adoptable(ctx):
                w = await self._adopt_pool_worker(ctx, fresh)
                if w is not None:
                    if not missed:
                        self._m_pool_hits.inc()
                    return w
            if not missed:
                missed = True
                self._m_pool_misses.inc()
            starting_all = [w for w in self._workers.values()
                            if w.state == "STARTING"]
            if len(starting_all) < GLOBAL_CONFIG.get("maximum_startup_concurrency"):
                w = await self._start_worker(ctx)
            else:
                starting_same = [w for w in starting_all if w.env_key == env_key]
                # at the fork cap: wait for ANY starting worker to register
                # (freeing a fork slot), then re-check
                w = (starting_same or starting_all)[0]
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                logger.warning("pop_worker: registration timeout")
                return None
            logger.debug("pop_worker: waiting registration of %s",
                         w.worker_id.hex()[:8])
            try:
                await asyncio.wait_for(w.registered.wait(),
                                       min(remaining, 5.0))
            except asyncio.TimeoutError:
                if time.monotonic() >= deadline:
                    logger.warning("pop_worker: registration timeout for %s",
                                   w.worker_id.hex()[:8])
                    return None
                continue
            if (w.env_key == env_key and w.state == "IDLE"
                    and not (fresh and w.used)):
                w.state = "LEASED"
                w.used = True
                return w
            # someone else took it, it's a different env, or it died — retry

    # env_vars that only take effect at interpreter boot/import time:
    # applying them post-adoption would silently do nothing (fork applies
    # them pre-exec), so envs carrying any of these must really fork.
    _BOOT_ENV_KEYS = frozenset({
        "PYTHONPATH", "PYTHONHOME", "PYTHONSTARTUP", "LD_PRELOAD",
        "LD_LIBRARY_PATH", "CUDA_VISIBLE_DEVICES",
    })

    def _adoptable(self, ctx) -> bool:
        """True when a warm default-env worker can be reassigned to this
        env with post-boot fixups only: no staged PYTHONPATH trees and no
        boot-time env_vars (RT_* flags may be read once at worker boot,
        so they need a fork too)."""
        if ctx.pythonpath_prepend:
            return False
        return not any(k in self._BOOT_ENV_KEYS or k.startswith("RT_")
                       for k in ctx.env_vars)

    async def _adopt_pool_worker(self, ctx,
                                 fresh: bool = False) -> Optional[WorkerHandle]:
        """Reassign a warm default-env worker to an env_vars/cwd-only
        runtime env: one configure_worker RPC instead of a fork. The
        worker keeps its new env_key for the rest of its life (its
        process env HAS been mutated), so later pops pool it under that
        env. A half-configured worker (RPC failed) is killed, never
        reused."""
        for w in list(self._workers.values()):
            if not (w.state == "IDLE" and w.env_key is None
                    and w.address is not None and w.alive()
                    and not (fresh and w.used)):
                continue
            w.state = "LEASED"  # claim before awaiting
            w.used = True
            try:
                await w.client().call_async("configure_worker",
                                            env_vars=ctx.env_vars,
                                            cwd=ctx.cwd, timeout=10.0)
            except Exception:  # noqa: BLE001 — env state unknown: discard
                logger.warning("pool-worker adoption failed; forking",
                               exc_info=True)
                self._kill_worker_proc(w)
                return None
            w.env_key = ctx.env_key
            self.runtime_env_agent.acquire(ctx.env_key)
            self._m_pool_adoptions.inc()
            self._replenish_pool()  # consumed a default-env warm worker
            logger.debug("adopted pool worker %s into env %s",
                         w.worker_id.hex()[:8], ctx.env_key[:8])
            return w
        return None

    # ------------------------------------------------------------- scheduling
    def _local_available(self, request: ResourceRequest,
                         pg: Optional[Tuple[PlacementGroupID, int]]) -> bool:
        if pg is not None:
            pg_id, idx = pg
            bundle = self._bundles.get(pg_id, {}).get(idx)
            return bundle is not None and bundle.committed and \
                request.resources.is_subset_of(bundle.available.resources)
        return self.resources.is_available(request)

    def _allocate_local(self, request: ResourceRequest,
                        pg: Optional[Tuple[PlacementGroupID, int]]):
        """Returns an assignment or None. Availability is RE-CHECKED here:
        callers may have awaited (env staging) since their _local_available
        check, and a competing grant can win the resources meanwhile."""
        if pg is not None:
            pg_id, idx = pg
            bundle = self._bundles.get(pg_id, {}).get(idx)
            if bundle is None or not bundle.committed or \
                    not request.resources.is_subset_of(
                        bundle.available.resources):
                return None
            bundle.available = ResourceRequest(
                (bundle.available.resources - request.resources).to_dict()
            )
            # chips come from the bundle's reservation
            return {k: list(v) for k, v in (bundle.assignment or {}).items()}
        return self.resources.allocate(request)

    async def h_request_worker_lease(self, lease_id: bytes, resources: dict,
                                     strategy=None, pg: Optional[tuple] = None,
                                     grant_only_local: bool = False,
                                     runtime_env: Optional[dict] = None,
                                     job_id: Optional[bytes] = None,
                                     locality: Optional[dict] = None):
        """Two-level scheduling (reference: node_manager.proto:413 +
        cluster_task_manager.h): grant locally, spill, or queue."""
        request = ResourceRequest.from_dict(resources) if isinstance(resources, dict) and "resources" in resources else ResourceRequest(resources)
        pg_key = (PlacementGroupID(pg[0]), pg[1]) if pg else None
        logger.debug("lease request %s res=%s", lease_id[:4].hex(), request.resources.to_dict())

        # Argument-locality: when the hinted best node is NOT this one and
        # could run the task, route there before burning a local grant —
        # a local grant means the args pay the wire (submitter.py sends
        # the owner-built {node_hex: arg_bytes} hint).
        if locality and GLOBAL_CONFIG.get("locality_scheduling") \
                and pg_key is None and not grant_only_local:
            strategy_obj = (pickle.loads(strategy)
                            if isinstance(strategy, bytes) else None)
            node = policies.pick_node(self.view, request, strategy_obj,
                                      local_node=self.node_id,
                                      arg_bytes_by_node=locality)
            if node is not None and node.node_id != self.node_id:
                return {"status": "spill", "node_id": node.node_id.binary(),
                        "address": node.address}
        if self._local_available(request, pg_key):
            granted = await self._grant_lease(lease_id, request, pg_key,
                                              runtime_env, job_id=job_id)
            if granted is not None:
                return granted
        if pg_key is not None or grant_only_local:
            # PG leases are node-pinned; queue locally until bundle frees
            # up.  "pin" marks explicitly local-only requests (e.g. the
            # submitter's final spill hop) so the drain never re-spills
            # them — bouncing a hop-budget-exhausted lease defeats the pin.
            fut = asyncio.get_running_loop().create_future()
            self._pending_leases.append(
                {"lease_id": lease_id, "request": request, "pg": pg_key,
                 "runtime_env": runtime_env, "future": fut, "job_id": job_id,
                 "pin": grant_only_local}
            )
            return await fut
        # consider spilling to another node
        strategy_obj = pickle.loads(strategy) if isinstance(strategy, bytes) else None
        node = policies.pick_node(self.view, request, strategy_obj,
                                  local_node=self.node_id,
                                  arg_bytes_by_node=locality)
        if node is not None and node.node_id != self.node_id:
            return {"status": "spill", "node_id": node.node_id.binary(),
                    "address": node.address}
        feasible_somewhere = any(
            e.resources.is_feasible(request) for e in self.view.alive_nodes()
        )
        if not feasible_somewhere:
            return {"status": "infeasible"}
        fut = asyncio.get_running_loop().create_future()
        self._pending_leases.append(
            {"lease_id": lease_id, "request": request, "pg": None,
             "runtime_env": runtime_env, "future": fut, "job_id": job_id,
             "locality": locality}
        )
        return await fut


    async def _materialize_env(self, runtime_env: Optional[dict]):
        """Stage the env off-loop (file copies must not stall the raylet)."""
        if not runtime_env:
            from ray_tpu_torch.runtime_env.agent import WorkerEnvContext

            return WorkerEnvContext()
        return await asyncio.to_thread(
            self.runtime_env_agent.get_or_create, runtime_env)

    async def _grant_lease(self, lease_id: bytes, request: ResourceRequest,
                           pg_key, runtime_env=None,
                           job_id: Optional[bytes] = None) -> Optional[dict]:
        # Materialize the env only on the node that will actually grant —
        # a request that spills elsewhere must not stage files here.
        try:
            ctx = await self._materialize_env(runtime_env)
        except Exception as e:  # noqa: BLE001 - RuntimeEnvError + staging IO
            return {"status": "env_error", "error": str(e)}
        assignment = self._allocate_local(request, pg_key)
        if assignment is None:
            return None
        gpu_ids = self._gpu_ids(request, assignment)
        w = await self._pop_worker(ctx=ctx, fresh=gpu_ids is not None)
        if w is None:
            # couldn't start a worker: roll back
            if pg_key is None:
                self.resources.free(request, assignment)
            else:
                self._return_to_bundle(pg_key, request)
            return None
        w.lease_id = lease_id
        w.request = request
        w.assignment = assignment
        w.pg = pg_key
        w.job_id = job_id
        self._leases[lease_id] = w.worker_id
        # tell the worker its GPU visibility before it runs anything
        if gpu_ids is not None:
            try:
                # bounded: a wedged worker must not stall the lease grant
                # for the cached client's full 30s retry window
                await w.client().call_async("set_visible_devices",
                                            gpu_ids=gpu_ids,
                                            timeout=5.0)
            except Exception as e:  # noqa: BLE001
                # a worker that cannot see its GPUs must not run the task:
                # the kill returns the lease's resources, and the request
                # is queued again for another worker
                logger.warning("set_visible_devices failed: %s", e)
                self._kill_worker_proc(w)
                return None
        return {
            "status": "granted",
            "worker_id": w.worker_id.binary(),
            "worker_address": w.address,
            # the worker's native dispatch port: the lease holder opens
            # its fast task channel against it (submitter.py)
            "worker_fast_port": w.fast_port,
            "node_id": self.node_id.binary(),
        }

    def _gpu_ids(self, request: Optional[ResourceRequest],
                 assignment: Optional[dict]) -> Optional[list]:
        """The device ids of the GPU instances a lease asked for, or None
        (a lease inside a GPU bundle that asks for none sees none)."""
        instances = (assignment or {}).get(GPU)
        if not instances or request is None \
                or not request.resources.get(GPU):
            return None
        return device_ids_for(instances, self._node_visible_gpus)

    def _free_worker_resources(self, w: WorkerHandle):
        """Return a worker's held resources to the right pool: its PG bundle
        if it was leased inside one, the node pool otherwise."""
        if w.request is None:
            w.pg = None
            return
        if w.pg is not None:
            self._return_to_bundle(w.pg, w.request)
        else:
            self.resources.free(w.request, w.assignment)
        w.request = None
        w.assignment = None
        w.pg = None

    def _return_to_bundle(self, pg_key, request: ResourceRequest):
        pg_id, idx = pg_key
        bundles = self._bundles.get(pg_id)
        if bundles and idx in bundles:
            b = bundles[idx]
            b.available = ResourceRequest(
                (b.available.resources + request.resources).to_dict()
            )

    def _free_lease(self, w: WorkerHandle):
        if w.lease_id is None:
            return
        self._leases.pop(w.lease_id, None)
        w.lease_id = None
        w.job_id = None
        self._free_worker_resources(w)

    async def h_return_worker(self, lease_id: bytes, disconnect: bool = False):
        wid = self._leases.get(lease_id)
        if wid is None:
            return False
        w = self._workers.get(wid)
        if w is None:
            return False
        held_gpu = self._gpu_ids(w.request, w.assignment) is not None
        self._free_lease(w)
        if disconnect or held_gpu or not w.alive():
            self._kill_worker_proc(w)
        else:
            w.state = "IDLE"
            w.idle_since = time.monotonic()
        self._try_grant_pending()
        return True

    def _try_grant_pending(self):
        if not self._pending_leases:
            return
        # Single-flight: concurrent drain() tasks interleaving at the
        # grant await both leaked leases and dropped queue items when each
        # rebuilt _pending_leases (round-5 review findings).  One drain
        # runs at a time; triggers during a run coalesce into one rerun.
        if self._drain_running:
            self._drain_again = True
            return
        self._drain_running = True

        async def drain():
            try:
                while True:
                    self._drain_again = False
                    await self._drain_pending_leases_once()
                    if not self._drain_again:
                        return
            finally:
                self._drain_running = False

        self._io.spawn_threadsafe(drain())

    async def _drain_pending_leases_once(self):
        still: List[dict] = []
        for item in self._pending_leases:
            if item["future"].done():
                continue
            if self._local_available(item["request"], item["pg"]):
                granted = await self._grant_lease(
                    item["lease_id"], item["request"], item["pg"],
                    item.get("runtime_env"), job_id=item.get("job_id"))
                if granted is not None:
                    if not item["future"].done():
                        item["future"].set_result(granted)
                    else:
                        # the job-finished reclaim resolved the future
                        # while we granted: give the lease back or it
                        # (and its worker) leaks forever
                        await self.h_return_worker(item["lease_id"])
                    continue
            if item["pg"] is None and not item.get("pin"):
                # re-evaluate spilling: a REMOTE node may have freed up
                # while we were queued (its gossip triggers this drain)
                node = policies.pick_node(
                    self.view, item["request"], None, local_node=self.node_id,
                    arg_bytes_by_node=item.get("locality"))
                if node is not None and node.node_id != self.node_id \
                        and not item["future"].done():
                    item["future"].set_result(
                        {"status": "spill", "node_id": node.node_id.binary(),
                         "address": node.address})
                    continue
            still.append(item)
        self._pending_leases[:] = still

    # ---------------------------------------------------------------- actors
    async def h_start_actor(self, creation_spec: bytes):
        spec = pickle.loads(creation_spec)
        request = spec.required_resources
        pg_key = None
        from ray_tpu_torch.common.task_spec import PlacementGroupStrategy

        if isinstance(spec.scheduling_strategy, PlacementGroupStrategy):
            pg_key = (spec.scheduling_strategy.placement_group_id,
                      spec.scheduling_strategy.bundle_index)
        if not self._local_available(request, pg_key):
            return {"ok": False, "reason": "resources unavailable"}
        try:
            ctx = await self._materialize_env(spec.runtime_env)
        except Exception as e:  # noqa: BLE001
            # env failures are fatal for the actor, not retryable placement
            return {"ok": False, "fatal": True,
                    "reason": f"runtime env setup failed: {e}"}
        assignment = self._allocate_local(request, pg_key)
        if assignment is None:
            # a competing grant won the resources during env staging
            return {"ok": False, "reason": "resources unavailable"}
        gpu_ids = self._gpu_ids(request, assignment)
        w = await self._pop_worker(ctx=ctx, fresh=gpu_ids is not None)
        if w is None:
            if pg_key is None:
                self.resources.free(request, assignment)
            else:
                self._return_to_bundle(pg_key, request)
            return {"ok": False, "reason": "no worker"}
        w.state = "ACTOR"
        w.pg = pg_key
        w.request = request
        w.assignment = assignment
        w.actor_id = spec.actor_id.binary()
        # the actor consumed a warm worker for good (actor workers die with
        # their actor — state isolation, as in the reference); refill the
        # pool off the critical path so the NEXT creation finds one warm
        self._replenish_pool()
        try:
            c = w.client()
            # device grant rides the creation push: ONE worker RPC on the
            # creation critical path instead of set_visible_devices +
            # create_actor round-tripping serially
            await c.call_async("create_actor", creation_spec=creation_spec,
                               node_id=self.node_id.binary(),
                               gpu_ids=gpu_ids, timeout=120.0)
        except Exception as e:  # noqa: BLE001
            logger.warning("create_actor push failed: %s", e)
            await self._on_worker_dead(w, f"create_actor failed: {e}")
            return {"ok": False, "reason": str(e)}
        return {"ok": True, "worker_id": w.worker_id.binary(), "worker_address": w.address}

    async def h_kill_worker(self, worker_id: bytes):
        w = self._workers.get(WorkerID(worker_id))
        if w is None:
            return False
        self._kill_worker_proc(w)
        return True

    async def h_worker_alive(self, worker_id: bytes):
        """Three-valued liveness probe for object-owner fail-fast
        (core_worker fetch): ``known`` is False for a worker this raylet
        never hosted (foreign node, driver) — the caller must keep its
        patient retry path for those."""
        wid = WorkerID(worker_id)
        w = self._workers.get(wid)
        if w is not None:
            return {"known": True, "alive": w.state != "DEAD"}
        return {"known": wid in self._dead_workers, "alive": False}

    async def h_notify_actor_dead(self, worker_id: bytes):
        """Worker-side graceful actor exit (e.g. __rt_terminate__)."""
        w = self._workers.get(WorkerID(worker_id))
        if w is not None:
            await self._on_worker_dead(w, "actor exited")
        return True

    # --------------------------------------------------------------- PG (2PC)
    async def h_prepare_bundles(self, pg_id: bytes, bundles: Dict[int, dict]):
        pgid = PlacementGroupID(pg_id)
        # Idempotent re-prepare (GCS may 2PC the same pg_id again after a
        # restart/reschedule): free any allocation this node still holds for
        # an index being re-prepared, or it leaks when overwritten below.
        existing = self._bundles.get(pgid, {})
        for idx in list(bundles):
            old = existing.pop(int(idx), None) or existing.pop(idx, None)
            if old is not None:
                self.resources.free(old.request, old.assignment)
        prepared: Dict[int, Bundle] = {}
        for idx, bdict in bundles.items():
            request = ResourceRequest.from_dict(bdict)
            assignment = self.resources.allocate(request)
            if assignment is None:
                # roll back everything prepared in this call
                for b in prepared.values():
                    self.resources.free(b.request, b.assignment)
                return False
            prepared[idx] = Bundle(request=request, assignment=assignment,
                                   available=ResourceRequest(request.resources.to_dict()))
        self._bundles.setdefault(pgid, {}).update(prepared)
        return True

    async def h_commit_bundles(self, pg_id: bytes):
        for b in self._bundles.get(PlacementGroupID(pg_id), {}).values():
            b.committed = True
        self._try_grant_pending()
        return True

    async def h_return_bundles(self, pg_id: bytes):
        bundles = self._bundles.pop(PlacementGroupID(pg_id), {})
        for b in bundles.values():
            self.resources.free(b.request, b.assignment)
        # kill workers still leased inside the PG
        for w in list(self._workers.values()):
            if w.pg is not None and w.pg[0] == PlacementGroupID(pg_id):
                self._kill_worker_proc(w)
        self._try_grant_pending()
        return True

    # ------------------------------------------------------------------ misc
    async def h_health_check(self):
        return True

    async def h_get_node_info(self):
        return {
            "node_id": self.node_id.binary(),
            "address": self.server.address,
            "resources": self.resources.snapshot(),
            "num_workers": len(self._workers),
            "session_dir": self.session_dir,
        }

    def _spill_state(self) -> dict:
        """Node spill-subsystem snapshot: this handle's engine counters
        plus the shared spill dir's on-disk footprint.  Disk scan —
        callers must run it OFF the loop (h_debug_state to_threads it)."""
        out: dict = {}
        try:
            store = getattr(self, "_shm_stats_store", None)
            if store is None:
                return out
            out["engine"] = store.spill_stats()
            spill_dir = store._spill_dir
            if spill_dir and os.path.isdir(spill_dir):
                files = bytes_on_disk = 0
                with os.scandir(spill_dir) as it:
                    for e in it:
                        if e.name.startswith("."):
                            continue
                        try:
                            bytes_on_disk += e.stat().st_size
                            files += 1
                        except OSError:
                            continue
                out["dir"] = {"path": spill_dir, "files": files,
                              "bytes": bytes_on_disk}
        except Exception:  # noqa: BLE001 — diagnostics are best-effort
            pass
        return out

    async def h_debug_state(self):
        def _spill():
            return self._spill_state()

        spill = await asyncio.to_thread(_spill)
        return {
            "spill": spill,
            "workers": {
                w.worker_id.hex()[:8]: {"state": w.state, "addr": w.address}
                for w in self._workers.values()
            },
            "pending_leases": len(self._pending_leases),
            "bundles": {
                pid.hex()[:8]: {i: b.committed for i, b in bs.items()}
                for pid, bs in self._bundles.items()
            },
            "resources": self.resources.snapshot(),
            "oom_kills": self._oom_kills,
            "io_stats": dict(self._io.stats),
            "worker_pool": {
                "warm": sum(1 for w in self._workers.values()
                            if w.env_key is None and w.state in
                            ("IDLE", "STARTING")),
                "hits": sum(self._m_pool_hits.snapshot()
                            ["values"].values()),
                "misses": sum(self._m_pool_misses.snapshot()
                              ["values"].values()),
                "adoptions": sum(self._m_pool_adoptions.snapshot()
                                 ["values"].values()),
            },
        }
