"""Central config/flag registry.

Mirrors the reference's ``RAY_CONFIG(type, name, default)`` system
(src/ray/common/ray_config_def.h:18): every flag is declared once with a type
and default, can be overridden by the ``RT_<name>`` environment variable, and a
cluster-wide ``system_config`` dict (propagated through the GCS at startup)
takes precedence over defaults but not env vars.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict

_ENV_PREFIX = "RT_"


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: int,
    float: float,
    str: str,
}


@dataclass
class _Flag:
    name: str
    type: type
    default: Any
    doc: str = ""


class Config:
    """Flag registry with env > system_config > default precedence."""

    def __init__(self):
        self._flags: Dict[str, _Flag] = {}
        self._system_config: Dict[str, Any] = {}
        self._cache: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def declare(self, name: str, type_: type, default: Any, doc: str = "") -> None:
        if name in self._flags:
            raise ValueError(f"flag {name!r} declared twice")
        self._flags[name] = _Flag(name, type_, default, doc)

    def initialize(self, system_config: Dict[str, Any] | str | None) -> None:
        """Apply a cluster-wide system_config (dict or JSON string)."""
        if system_config is None:
            system_config = {}
        if isinstance(system_config, str):
            system_config = json.loads(system_config) if system_config else {}
        with self._lock:
            for key in system_config:
                if key not in self._flags:
                    raise ValueError(f"unknown system_config key {key!r}")
            self._system_config = dict(system_config)
            self._cache.clear()

    def system_config_json(self) -> str:
        return json.dumps(self._system_config)

    def set_system_config_value(self, name: str, value: Any) -> None:
        """Set one flag at system_config precedence (env still wins)."""
        with self._lock:
            if name not in self._flags:
                raise ValueError(f"unknown system_config key {name!r}")
            self._system_config[name] = value
            self._cache.pop(name, None)

    def get(self, name: str) -> Any:
        with self._lock:
            if name in self._cache:
                return self._cache[name]
            flag = self._flags.get(name)
            if flag is None:
                raise KeyError(f"unknown flag {name!r}")
            env_val = os.environ.get(_ENV_PREFIX + name)
            if env_val is not None:
                value = _PARSERS[flag.type](env_val)
            elif name in self._system_config:
                value = flag.type(self._system_config[name])
            else:
                value = flag.default
            self._cache[name] = value
            return value

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        return self.get(name)

    def reset_cache(self) -> None:
        with self._lock:
            self._cache.clear()

    def all_flags(self) -> Dict[str, _Flag]:
        return dict(self._flags)


GLOBAL_CONFIG = Config()
_D = GLOBAL_CONFIG.declare

# --- core timeouts / intervals (ms unless noted) -----------------------------
_D("health_check_initial_delay_ms", int, 5000, "delay before first node health probe")
_D("health_check_period_ms", int, 1000, "interval between node health probes")
_D("health_check_timeout_ms", int, 5000, "single probe timeout")
_D("health_check_failure_threshold", int, 5, "probes missed before node marked dead")
_D("raylet_report_resources_period_ms", int, 100, "resource gossip interval")
_D("gcs_rpc_server_reconnect_timeout_s", int, 60, "client retry window on GCS restart")
_D("gcs_restart_reconcile_delay_s", float, 2.0,
   "post-restart window for raylets to re-claim actors/bundles before failover")
_D("rpc_schema_validation", bool, True,
   "validate inbound RPCs against the typed wire schemas (rpc/schema.py)")
_D("rpc_retry_base_ms", int, 100, "retryable client initial backoff")
_D("rpc_retry_max_ms", int, 5000, "retryable client max backoff")
_D("rpc_connect_timeout_s", float, 10.0, "client connect timeout")
_D("rpc_require_hello", bool, True,
   "when True (default), a peer that never answers HELLO is treated as a "
   "transport failure (retry/rotate); set False only during a rolling "
   "upgrade from pre-handshake nodes, where the silent peer is assumed "
   "legacy and the connection degrades to protocol 1")
_D("fastloop_enabled", bool, True,
   "C dispatch loop for eligible actor calls and normal tasks "
   "(rpc/native/fastloop.c); falls back to the asyncio path when the "
   "extension can't build")
_D("fast_dispatch_window", int, 4,
   "in-flight pushes per lease on the native task-dispatch channel: >1"
   " overlaps wire/reply latency with execution (small eligible tasks may"
   " then briefly overlap on one leased worker); 1 = strict one-task-per-"
   "lease pacing")

# --- deployment shape --------------------------------------------------------
_D("control_plane_procs", bool, False,
   "multi-process deployment shape: ray_tpu_torch.init() launches the GCS server"
   " and the raylet each in their OWN OS process (own interpreter, own"
   " asyncio loop, own GIL) instead of on the driver's shared IO loop."
   " Removes control-plane/driver loop contention — actor-creation and"
   " lease scheduling no longer time-slice against driver submit/reply"
   " work — at the cost of real RPC hops for every crossing. Off ="
   " the historical in-process head (driver+GCS+raylet share one loop)")


# --- scheduling --------------------------------------------------------------
_D("scheduler_top_k_fraction", float, 0.2, "hybrid policy: top-k fraction of nodes")
_D("scheduler_top_k_absolute", int, 1, "hybrid policy: min top-k")
_D("scheduler_spread_threshold", float, 0.5, "utilization below which packing wins")
_D("lease_request_batch_size", int, 10, "leases requested per shape at once")
_D("lease_idle_grace_ms", int, 100,
   "idle lease retention: how long a drained lease waits for more"
   " same-shape work before returning its worker")

# --- workers -----------------------------------------------------------------
_D("log_to_driver", bool, True,
   "stream worker stdout/stderr to subscribed drivers via GCS pubsub")
_D("worker_log_flush_interval_s", float, 0.2, "worker log relay batch period")
_D("num_prestart_workers", int, 2,
   "warm default-env worker watermark: forked at raylet boot and"
   " replenished concurrently in the background (through the warm"
   " forkserver, once attached) as creations consume the pool")
_D("worker_factory_enabled", bool, True,
   "forkserver worker factory: fork warm interpreters instead of exec")
_D("worker_factory_procs", int, 2,
   "parallel forkserver processes: fork(2) serializes per address space"
   " (~12 ms/fork of a warm interpreter), so K factories raise the"
   " sustained worker-supply — and therefore actor-creation — ceiling")
_D("worker_register_timeout_s", int, 60, "")
_D("worker_raylet_death_check_s", float, 5.0,
   "workers probe their raylet at this interval and exit after 3"
   " consecutive failures — a SIGKILLed raylet (multi-process shape"
   " crash) must not orphan its worker processes forever (0 disables)")
_D("idle_worker_killing_time_threshold_ms", int, 1000, "idle reap threshold")
_D("maximum_startup_concurrency", int, 4, "concurrent worker forks")

# --- object store ------------------------------------------------------------
_D("object_store_chunk_size_bytes", int, 5 * 1024 * 1024, "transfer chunk size")
_D("object_pull_max_inflight", int, 8, "concurrent chunks pulled per object")
_D("device_object_cache_entries", int, 32,
   "consumer-side LRU size for resolved remote device objects")
_D("object_spilling_threshold", float, 0.8, "fullness ratio that triggers spill")
_D("object_spilling_dir", str, "", "external storage dir ('' = session dir)")
_D("max_direct_call_object_size", int, 100 * 1024, "inline-in-RPC threshold bytes")
_D("streaming_generator_backpressure", int, 16,
   "max unconsumed streamed items before the owner delays report replies"
   " (0 = unlimited)")
_D("memory_store_max_bytes", int, 512 * 1024 * 1024, "in-process store cap")
_D("transfer_service", bool, True,
   "per-node object transfer service: sealed/spilled objects stream"
   " node-to-node over a dedicated socket server (zero-copy arena views,"
   " no pickle). 0 keeps the legacy per-chunk owner-RPC path as the only"
   " wire path — the parity oracle every multi-node test must also pass")
_D("transfer_chunk_bytes", int, 4 * 1024 * 1024,
   "transfer-service wire granularity: sendall/recv_into window per"
   " slice of the pinned view (tests shrink it to exercise chunking)")
_D("locality_scheduling", bool, True,
   "pick_node prefers the feasible node already holding the largest"
   " total argument bytes (owner-reported location hints), tie-broken"
   " by the configured pack/spread policy — large-arg tasks skip the"
   " wire instead of pulling their args cross-node")

# --- memory / isolation ------------------------------------------------------
_D("memory_monitor_enabled", bool, True, "kill workers before kernel OOM")
_D("memory_usage_threshold", float, 0.95, "node memory fraction that triggers"
   " the OOM killing policy")
_D("memory_monitor_refresh_ms", int, 250, "memory usage poll interval")
_D("cgroup_isolation_enabled", bool, False,
   "place workers in per-worker cgroups with memory limits")

# --- retries / lineage -------------------------------------------------------
_D("max_task_retries", int, 3, "default retries for normal tasks")
_D("lineage_pinning_enabled", bool, True, "")
_D("max_lineage_bytes", int, 64 * 1024 * 1024, "lineage buffer cap per worker")

# --- autoscaler --------------------------------------------------------------
_D("autoscaling_enabled", bool, False,
   "refused by init(): the autoscaler is not ported yet")

# --- observability -----------------------------------------------------------
_D("task_events_enabled", bool, True,
   "buffer per-task lifecycle events and flush them to the GCS task store"
   " (reference RAY_task_events_report_interval_ms; 0/off skips the"
   " per-task buffering entirely — read once at worker boot)")
_D("enable_export_api", bool, False,
   "write versioned JSONL export events (actor/node/job/PG transitions)"
   " under <session>/export_events/ for external tooling")

# --- compiled graphs ---------------------------------------------------------
_D("pipeline_overlap", bool, True,
   "overlap channel transfer with stage compute in compiled pipelines:"
   " prefetch reads one item ahead and write-behind outputs on a writer"
   " thread (off = strictly sequential read/compute/write per item)")

# --- collectives -------------------------------------------------------------
_D("quantized_collectives", bool, False,
   "block-wise int8 quantized allreduce/reducescatter"
   " (collective/quantization.py, EQuARX-style per-block scale+offset):"
   " float payloads travel as uint8 codes + per-block scale/offset and are"
   " dequantized-reduced-requantized at each hop (~3.9x fewer bytes on the"
   " wire for f32 at the default block). Off by default: the full-precision"
   " path is the parity oracle every quantized result is bounded against,"
   " and stays bit-identical with the flag off")
_D("quantized_collectives_block", int, 256,
   "quantization block size: elements sharing one (scale, offset) pair;"
   " larger blocks cut scale overhead but widen per-block value range"
   " (looser error bound)")

# --- chaos / testing ---------------------------------------------------------
_D("testing_rpc_failure", str, "", "method=prob fault injection spec, comma-sep")
_D("testing_rpc_failure_seed", int, 0, "deterministic chaos seed")
_D("testing_faults", str, "",
   "deterministic fault-point spec (common/faults.py), comma-separated"
   " point=schedule pairs; same syntax as the RT_FAULTS env var")

# --- object store, slice labels ----------------------------------------------
_D("shm_store_enabled", bool, True, "node-local shared-memory object store")
_D("shm_direct_put_threshold", int, 1 << 20,
   "puts >= this many framed bytes serialize directly into the shm arena"
   " (plasma create/seal; single memcpy)")
_D("oob_arg_threshold", int, 256 * 1024,
   "task/actor args whose pickle-5 out-of-band buffers total >= this many"
   " bytes are written straight into the shm arena and passed by"
   " reference: one memcpy end to end, zero-copy views on the executee"
   " (0 disables; buffer-less or sub-threshold args stay inline)")
_D("memory_store_shm_threshold", int, 1 << 20,
   "in-process store hands byte values >= this size to the node shm"
   " arena (pinned view, zero heap charge) instead of holding them"
   " on-heap (0 disables routing)")
_D("shm_store_bytes", int, 512 * 1024 * 1024, "shm object store capacity")
_D("tpu_topology", str, "", "slice topology label, e.g. v5e-32")
