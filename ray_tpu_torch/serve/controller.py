"""Serve controller + replica harness.

Reference: ``python/ray/serve/_private/controller.py:90`` (ServeController
actor), ``deployment_state.py`` (replica FSM reconciliation),
``autoscaling_state.py`` (queue-metric autoscaling). One actor owns target
state; a reconcile thread converges actual replica actors to target and
autoscales between min/max replicas on observed ongoing-request load.
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from ray_tpu_torch.common import faults

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "SERVE_CONTROLLER"


class _ItemError:
    """Per-item failure inside a batched call: the other items' results
    still flow; the proxy re-raises this one for its own request only."""

    def __init__(self, error: BaseException):
        self.error = error


class Replica:
    """Replica harness actor: wraps the user callable, tracks load
    (reference ``python/ray/serve/_private/replica.py``)."""

    def __init__(self, cls_blob: bytes, init_args, init_kwargs,
                 max_ongoing: int = 8, version: int = 0):
        import cloudpickle

        cls = cloudpickle.loads(cls_blob)
        self._user = cls(*init_args, **init_kwargs)
        self._ongoing = 0
        self._total = 0
        self._lock = threading.Lock()
        self._max_ongoing = max(1, int(max_ongoing))
        self._version = int(version)
        self._batch_pool = None  # lazy: only batched callers pay for it

    def ping(self) -> bool:
        # A user-defined check_health() makes the controller's probe see
        # application health, not just process liveness (reference:
        # Serve replica health checks call the user's check_health).
        check = getattr(self._user, "check_health", None)
        if callable(check):
            check()
        return True

    def pid(self) -> int:
        """Worker process pid — chaos tests SIGKILL a replica through this."""
        return os.getpid()

    def version(self) -> int:
        return self._version

    def get_metrics(self) -> Dict[str, Any]:
        from ray_tpu_torch.serve import multiplex

        with self._lock:
            return {"ongoing": float(self._ongoing),
                    "total": float(self._total),
                    "version": self._version,
                    "model_ids": multiplex.loaded_model_ids(self._user)}

    def get_prefix_digest(self) -> List[int]:
        """Compact prefix-cache advertisement for prefix-aware routing.

        Delegates to the user object's ``prefix_digest()`` when it has
        one (the LLM server exposes its radix tree's chunk hashes);
        anything else — no method, or a digest that fails mid-walk —
        degrades to an empty hint, never an error: the digest is purely
        a routing optimization."""
        fn = getattr(self._user, "prefix_digest", None)
        if not callable(fn):
            return []
        try:
            return [int(h) for h in fn()]
        except Exception:  # noqa: BLE001 — hint only
            return []

    def supports_generator_stream(self) -> bool:
        import inspect

        fn = getattr(self._user, "stream", None)
        return fn is not None and inspect.isgeneratorfunction(fn)

    def handle_request_stream(self, args, kwargs):
        """Generator-protocol streaming: the user's ``stream`` generator's
        items push to the caller via ``num_returns="streaming"`` —
        per-item delivery with owner-side backpressure, no poll RPCs
        (reference: Serve response streaming over ObjectRefGenerator)."""
        faults.fault_point("serve.replica.stream")
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            yield from self._user.stream(*args, **kwargs)
        finally:
            with self._lock:
                self._ongoing -= 1

    def handle_request_batch(self, method: str, calls):
        """Coalesced dispatch (round 11): the proxy ships every request
        queued behind an in-flight call as ONE actor call, amortizing the
        per-call submit/reply machinery.  Items run CONCURRENTLY on the
        harness pool (sized to ``max_ongoing_requests``) so a batch of
        blocking handlers keeps the latency profile of independent calls;
        per-item exceptions come back as :class:`_ItemError` so one bad
        request cannot fail its batchmates.  Transport-typed failures
        (``ConnectionError``, which includes injected faults) are the
        exception to per-item isolation: they mean THIS replica's
        transport is suspect, so the whole call raises and the proxy
        re-routes the entire batch to a fresh replica instead of handing
        batchmates a 500."""
        if len(calls) == 1:
            args, kwargs = calls[0]
            try:
                return [self.handle_request(method, args, kwargs)]
            except ConnectionError:
                raise  # whole-call failure: proxy retries on a fresh replica
            except Exception as e:  # noqa: BLE001 — per-item isolation
                return [_ItemError(e)]
        if self._batch_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._batch_pool = ThreadPoolExecutor(
                max_workers=self._max_ongoing,
                thread_name_prefix="replica-batch")

        def run(args, kwargs):
            try:
                return self.handle_request(method, args, kwargs)
            except Exception as e:  # noqa: BLE001 — per-item isolation
                return _ItemError(e)

        futures = [self._batch_pool.submit(run, a, k) for a, k in calls]
        results = [f.result() for f in futures]
        for res in results:
            if isinstance(res, _ItemError) and isinstance(
                    res.error, ConnectionError):
                raise res.error
        return results

    def handle_request(self, method: str, args, kwargs):
        from ray_tpu_torch.serve import multiplex

        faults.fault_point("serve.replica.call")
        with self._lock:
            self._ongoing += 1
            self._total += 1
        token = multiplex.set_request_model_id(
            kwargs.pop("_multiplexed_model_id", ""))
        try:
            target = (self._user if method == "__call__"
                      else getattr(self._user, method))
            if method == "__call__" and not callable(self._user):
                raise TypeError("deployment class is not callable")
            return target(*args, **kwargs)
        finally:
            multiplex.reset_request_model_id(token)
            with self._lock:
                self._ongoing -= 1


class ServeController:
    """Target-state reconciler (runs as a detached-ish named actor)."""

    RECONCILE_INTERVAL_S = 0.25
    PING_FAILURE_THRESHOLD = 3
    PING_TIMEOUT_S = 10.0

    def __init__(self):
        # name -> {"deployment": Deployment, "blob": bytes, "args", "kwargs",
        #          "replicas": [handles], "target": int}
        self._apps: Dict[str, dict] = {}
        self._lock = threading.RLock()
        self._version = 0
        self._route_version = 0
        self._draining: List[dict] = []  # {"replica", "since"}
        self._ping_failures: Dict[str, int] = {}
        from ray_tpu_torch.util.metrics import Gauge

        self._ongoing_gauge = Gauge(
            "rt_serve_ongoing_requests",
            "in-flight requests summed over an app's replicas",
            tag_keys=("app",))
        # declarative mode (schema.py): version of the KV config this
        # incarnation has applied, and the app names it owns.  Starts at
        # None so a freshly (re)started controller re-applies whatever
        # spec is persisted — THAT is what makes the spec survive
        # controller crashes (reference: controller checkpoint recovery).
        self._declarative_version = None
        self._declarative_apps: set = set()
        self._declarative_hashes: Dict[str, str] = {}
        # transiently-failed app deploys are retried (the spec still
        # declares them) — with a floor between attempts so a persistent
        # import error doesn't spam every reconcile tick
        self._declarative_retry_at = 0.0
        # {app name: (monotonic stamp, {replica idx: digest})} — see
        # get_prefix_digests
        self._digest_cache: Dict[str, tuple] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._reconcile_loop,
                                        daemon=True, name="serve-reconcile")
        self._thread.start()

    # ------------------------------------------------------------- deploy
    def deploy(self, name: str, deployment_blob: bytes, cls_blob: bytes,
               init_args, init_kwargs) -> bool:
        import cloudpickle

        dep = cloudpickle.loads(deployment_blob)
        target = (dep.autoscaling_config.min_replicas
                  if dep.autoscaling_config else dep.num_replicas)
        abandoned: List[Any] = []
        with self._lock:
            prev = self._apps.get(name)
            if prev is None:
                self._apps[name] = {
                    "deployment": dep,
                    "cls_blob": cls_blob,
                    "args": init_args,
                    "kwargs": init_kwargs,
                    "replicas": [],
                    "target": target,
                    "version": 1,
                    "next": None,
                }
            else:
                # Rolling upgrade (reference: deployment_state.py rolling
                # update): the OLD replica set keeps serving while the new
                # version's replicas start and warm; the reconcile thread
                # swaps serving sets only once every new replica answers a
                # ping, then drains the old set.  Requests arriving
                # mid-roll therefore always land on a live, warm replica.
                old_next = prev.get("next")
                if old_next:
                    abandoned = list(old_next["replicas"])
                prev["next"] = {
                    "deployment": dep,
                    "cls_blob": cls_blob,
                    "args": init_args,
                    "kwargs": init_kwargs,
                    "replicas": [],
                    "target": target,
                    "version": prev.get("version", 1) + 1,
                }
            self._version += 1
            self._route_version += 1
        self._kill_replicas(abandoned)
        return True

    def _kill_replicas(self, replicas) -> None:
        import ray_tpu_torch

        for r in replicas:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001
                pass

    def delete_app(self, name: str) -> bool:
        with self._lock:
            app = self._apps.pop(name, None)
            self._digest_cache.pop(name, None)
            self._version += 1
            self._route_version += 1
        if app:
            self._kill_replicas(app["replicas"])
            if app.get("next"):
                self._kill_replicas(app["next"]["replicas"])
        return True

    def shutdown(self) -> bool:
        self._stop.set()
        for name in list(self._apps):
            self.delete_app(name)
        return True

    # ------------------------------------------------------------- queries
    def get_replicas(self, name: str):
        """(version, replica handles, max_ongoing, router) for handle
        routing."""
        with self._lock:
            app = self._apps.get(name)
            if app is None:
                raise KeyError(f"no deployment named {name!r}")
            return (self._version, list(app["replicas"]),
                    app["deployment"].max_ongoing_requests,
                    getattr(app["deployment"], "request_router", "pow2"))

    def get_prefix_digests(self, name: str) -> Dict[int, List[int]]:
        """{replica index -> prefix digest} for prefix-aware routing.

        Fanned out to the app's replicas with a short timeout and cached
        briefly: handles refresh on a poll loop, and the digest is a
        routing *hint* — a couple seconds of staleness just means a
        request lands on the second-best replica and warms it instead.
        Indices line up with the replica list ``get_replicas`` returns
        at the same version; dead/slow replicas simply contribute no
        entry."""
        import ray_tpu_torch

        now = time.monotonic()
        with self._lock:
            cached = self._digest_cache.get(name)
            if cached is not None and now - cached[0] < 2.0:
                return cached[1]
            app = self._apps.get(name)
            replicas = list(app["replicas"]) if app else []
        out: Dict[int, List[int]] = {}
        for i, r in enumerate(replicas):
            try:
                d = ray_tpu_torch.get([r.get_prefix_digest.remote()],
                                timeout=3.0)[0]
                if d:
                    out[i] = [int(h) for h in d]
            except Exception:  # noqa: BLE001 — hint only
                continue
        with self._lock:
            self._digest_cache[name] = (now, out)
        return out

    def get_route_table(self):
        """(version, {route_prefix: app_name}) for the ingress proxies."""
        with self._lock:
            table = {}
            for name, app in self._apps.items():
                prefix = app["deployment"].route_prefix or f"/{name}"
                table[prefix] = name
            return self._route_version, table

    async def listen_for_route_table(self, known_version: int,
                                     timeout_s: float = 15.0):
        """Long-poll (reference long_poll.py): returns when the route table
        version moves past ``known_version`` or after ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._route_version != known_version:
                    return self._route_version
            await asyncio.sleep(0.1)
        with self._lock:
            return self._route_version

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                name: {
                    "target_replicas": app["target"],
                    "running_replicas": len(app["replicas"]),
                    "autoscaling": app["deployment"].autoscaling_config
                    is not None,
                    "version": app.get("version", 1),
                    "rolling": app.get("next") is not None,
                }
                for name, app in self._apps.items()
            }

    # ----------------------------------------------------------- reconcile
    def _reconcile_loop(self):
        while not self._stop.is_set():
            try:
                self._check_declarative()
            except Exception:  # noqa: BLE001 — bad spec must not stop
                logger.error("declarative apply error:\n%s",
                             traceback.format_exc())
            try:
                self._reconcile_once()
                self._publish_status()
            except Exception:  # noqa: BLE001 — keep the loop alive
                logger.error("reconcile error:\n%s", traceback.format_exc())
            self._stop.wait(self.RECONCILE_INTERVAL_S)

    # ---------------------------------------------------- declarative mode
    def _check_declarative(self):
        """Converge running apps onto the spec persisted in the GCS KV
        (serve/schema.py).  Runs every reconcile tick; cheap no-op while
        the version is unchanged."""
        import json

        from ray_tpu_torch.core_worker.worker import CoreWorker
        from ray_tpu_torch.serve import schema

        try:
            gcs = CoreWorker.current_or_raise().gcs
            raw = gcs.kv_get(schema.KV_NAMESPACE, schema.KV_CONFIG_KEY)
        except Exception:  # noqa: BLE001 — GCS hiccup: retry next tick
            return
        if not raw:
            return
        doc = json.loads(raw)
        version = doc.get("version")
        if version == self._declarative_version:
            return
        if time.monotonic() < self._declarative_retry_at:
            return  # backing off after a failed apply of this version
        status: dict = {"version": version, "apps": {}}
        config = schema.validate_config(doc.get("config") or {})
        import ray_tpu_torch
        from ray_tpu_torch.serve.api import _deploy_tree

        own_handle = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        wanted = set()
        for entry in config["applications"]:
            name = entry["name"]
            wanted.add(name)
            # unchanged entries keep their running replicas: a config bump
            # that only touches app B must not drain-and-replace app A
            entry_hash = json.dumps(entry, sort_keys=True)
            if (self._declarative_hashes.get(name) == entry_hash
                    and name in self._apps):
                status["apps"][name] = {"state": "UNCHANGED"}
                continue
            try:
                app = schema.resolve_application(entry)
                schema.apply_overrides(app, entry)
                _deploy_tree(app, own_handle, {}, name=name)
                self._declarative_hashes[name] = entry_hash
                status["apps"][name] = {"state": "DEPLOYED"}
            except Exception as e:  # noqa: BLE001 — per-app isolation:
                # one bad import must not block the other apps
                logger.error("declarative deploy of %r failed:\n%s",
                             name, traceback.format_exc())
                status["apps"][name] = {"state": "DEPLOY_FAILED",
                                        "error": repr(e)}
        # apps this controller previously declared but the new spec drops
        for gone in self._declarative_apps - wanted:
            self.delete_app(gone)
            self._declarative_hashes.pop(gone, None)
            status["apps"][gone] = {"state": "DELETED"}
        self._declarative_apps = wanted
        failed = any(s.get("state") == "DEPLOY_FAILED"
                     for s in status["apps"].values())
        if failed:
            # leave the version unlatched: failed apps are re-attempted
            # (succeeded ones skip via their entry hash) every 5s
            self._declarative_retry_at = time.monotonic() + 5.0
        else:
            self._declarative_version = version
        try:
            gcs.kv_put(schema.KV_NAMESPACE, schema.KV_APPLY_STATUS_KEY,
                       json.dumps(status).encode(), overwrite=True)
        except Exception:  # noqa: BLE001 — status is best-effort
            pass

    def _publish_status(self):
        """Drop the app table into GCS KV so the dashboard's Serve view
        reads controller state without a handle to this actor
        (reference: the Serve dashboard module reads controller
        checkpoints from the GCS KV)."""
        import json

        try:
            from ray_tpu_torch.core_worker.worker import CoreWorker

            gcs = CoreWorker.current_or_raise().gcs
            payload = {"apps": self.status(), "updated_at": time.time()}
            gcs.kv_put("serve", b"status",
                       json.dumps(payload).encode(), overwrite=True)
        except Exception:  # noqa: BLE001 — dashboarding must never
            pass           # interfere with reconciliation

    def _enqueue_drain(self, replica, dep) -> None:
        """Must be called with self._lock held.  The drain deadline is the
        deployment's own graceful_shutdown_timeout_s — in-flight work
        (including SSE streams, which hold ``ongoing`` > 0 for their whole
        lifetime) gets that long to finish before the replica is killed."""
        self._draining.append({
            "replica": replica,
            "since": time.monotonic(),
            "timeout": getattr(dep, "graceful_shutdown_timeout_s", 10.0),
        })

    def _drain_old_replicas(self):
        import ray_tpu_torch

        with self._lock:
            draining = list(self._draining)
        still = []
        for d in draining:
            r, since = d["replica"], d["since"]
            done = False
            try:
                m = ray_tpu_torch.get([r.get_metrics.remote()], timeout=3.0)[0]
                done = m["ongoing"] <= 0
            except Exception:  # noqa: BLE001 — dead already
                done = True
            if done or time.monotonic() - since > d.get("timeout", 10.0):
                try:
                    ray_tpu_torch.kill(r)
                except Exception:  # noqa: BLE001
                    pass
            else:
                still.append(d)
        with self._lock:
            self._draining = still

    def _advance_rollouts(self):
        """Drive in-progress rolling upgrades: start the next version's
        replicas, wait for every one to answer a ping (warm), then swap
        the serving set atomically and drain the old one.  A next-version
        replica that fails ``PING_FAILURE_THRESHOLD`` consecutive probes
        is replaced; while a roll cannot complete the OLD set keeps
        serving, so a broken new version degrades to a stalled roll —
        never to 5xx."""
        import ray_tpu_torch

        with self._lock:
            rolling = [(name, app) for name, app in self._apps.items()
                       if app.get("next")]
        for name, app in rolling:
            nxt = app["next"]
            while True:
                with self._lock:
                    if app.get("next") is not nxt:  # restaged mid-start
                        break
                    need = nxt["target"] - len(nxt["replicas"])
                if need <= 0:
                    break
                r = self._start_replica(name, nxt)
                with self._lock:
                    if app.get("next") is nxt:
                        nxt["replicas"].append(r)
                    else:
                        self._kill_replicas([r])
                        break
            ready = 0
            for i, r in enumerate(list(nxt["replicas"])):
                key = r._actor_id.hex()
                try:
                    faults.fault_point("serve.controller.probe")
                    ray_tpu_torch.get([r.ping.remote()],
                                timeout=self.PING_TIMEOUT_S)
                    self._ping_failures.pop(key, None)
                    ready += 1
                except Exception:  # noqa: BLE001 — still warming or dead
                    fails = self._ping_failures.get(key, 0) + 1
                    self._ping_failures[key] = fails
                    if fails >= self.PING_FAILURE_THRESHOLD:
                        logger.warning(
                            "next-version replica of %s failed %d probes "
                            "during rollout; replacing", name, fails)
                        self._ping_failures.pop(key, None)
                        self._kill_replicas([r])
                        nxt["replicas"][i] = self._start_replica(name, nxt)
            if ready < nxt["target"]:
                continue
            with self._lock:
                if self._apps.get(name) is not app or app.get("next") is not nxt:
                    continue  # app deleted or roll restaged meanwhile
                old_replicas = app["replicas"]
                old_dep = app["deployment"]
                app.update(
                    deployment=nxt["deployment"],
                    cls_blob=nxt["cls_blob"],
                    args=nxt["args"],
                    kwargs=nxt["kwargs"],
                    replicas=nxt["replicas"],
                    target=nxt["target"],
                    version=nxt["version"],
                    next=None,
                )
                for r in old_replicas:
                    self._enqueue_drain(r, old_dep)
                self._version += 1
                self._route_version += 1
            logger.info("rolled %s to version %d (%d replicas warm)",
                        name, app["version"], len(app["replicas"]))

    def _reconcile_once(self):
        import ray_tpu_torch

        self._drain_old_replicas()
        self._advance_rollouts()
        with self._lock:
            apps = list(self._apps.items())
        for name, app in apps:
            dep = app["deployment"]
            # Health check with a consecutive-failure threshold (reference
            # gcs_health_check_manager failure_threshold): one slow ping
            # under load must not get a busy replica killed.  Ejection
            # bumps self._version, so every handle's next refresh (≤
            # REFRESH_INTERVAL_S) stops routing to the unhealthy replica.
            alive = []
            for r in app["replicas"]:
                key = r._actor_id.hex()
                try:
                    faults.fault_point("serve.controller.probe")
                    ray_tpu_torch.get([r.ping.remote()],
                                timeout=self.PING_TIMEOUT_S)
                    self._ping_failures.pop(key, None)
                    alive.append(r)
                except Exception:  # noqa: BLE001 — slow or dead
                    fails = self._ping_failures.get(key, 0) + 1
                    self._ping_failures[key] = fails
                    if fails < self.PING_FAILURE_THRESHOLD:
                        alive.append(r)
                    else:
                        logger.warning(
                            "replica of %s failed %d health checks; "
                            "replacing", name, fails)
                        self._ping_failures.pop(key, None)
                        # drain rather than drop: if it is merely wedged
                        # on a long request it finishes then dies; the
                        # drain timeout bounds a truly-hung one
                        with self._lock:
                            self._enqueue_drain(r, dep)
            changed = len(alive) != len(app["replicas"])

            # Mid-roll, the serving target is frozen: autoscale decisions
            # would fight the swap that is about to replace the set.
            if (dep.autoscaling_config is not None and alive
                    and not app.get("next")):
                app["target"] = self._autoscale_target(dep, alive,
                                                       app["target"])

            while len(alive) < app["target"]:
                alive.append(self._start_replica(name, app))
                changed = True
            while len(alive) > app["target"]:
                # Graceful downscale: drain, don't kill mid-request
                # (reference deployment_state graceful_shutdown).
                victim = alive.pop()
                with self._lock:
                    self._enqueue_drain(victim, dep)
                changed = True
            with self._lock:
                if name in self._apps:
                    self._apps[name]["replicas"] = alive
                    if changed:
                        self._version += 1

    def _start_replica(self, name: str, spec: dict):
        """``spec`` is either an app dict or its staged ``next`` dict —
        both carry deployment/cls_blob/args/kwargs/version."""
        import ray_tpu_torch

        dep = spec["deployment"]
        opts = dict(dep.ray_actor_options)
        opts.setdefault("max_concurrency", dep.max_ongoing_requests)
        # Deployment scheduler (reference
        # serve/_private/deployment_scheduler.py): replicas of one
        # deployment SPREAD across nodes by default, so one node's death
        # never takes the whole deployment down and per-node proxies have
        # a local replica to route to. Explicit strategies win.
        opts.setdefault("scheduling_strategy", "SPREAD")
        remote_cls = ray_tpu_torch.remote(Replica)
        logger.info("starting replica of %s (version %d)",
                    name, spec.get("version", 1))
        return remote_cls.options(**opts).remote(
            spec["cls_blob"], spec["args"], spec["kwargs"],
            max_ongoing=dep.max_ongoing_requests,
            version=spec.get("version", 1))

    def _autoscale_target(self, dep, replicas: List[Any],
                          current: int) -> int:
        import ray_tpu_torch

        cfg = dep.autoscaling_config
        try:
            metrics = ray_tpu_torch.get(
                [r.get_metrics.remote() for r in replicas], timeout=5.0)
        except Exception:  # noqa: BLE001 — skip this round
            return current
        ongoing = sum(m["ongoing"] for m in metrics)
        self._ongoing_gauge.set(ongoing, tags={"app": dep.name})
        per_replica = ongoing / max(len(replicas), 1)
        if per_replica > cfg.target_ongoing_requests * cfg.upscale_threshold:
            return min(current + 1, cfg.max_replicas)
        if per_replica < cfg.target_ongoing_requests * cfg.downscale_threshold:
            return max(current - 1, cfg.min_replicas)
        return current
