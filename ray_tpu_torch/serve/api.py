"""Serve public API (reference ``python/ray/serve/api.py``; port of
``ray_tpu/serve/api.py``)."""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.deployment import Application, make_deployment
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.proxy import PROXY_NAME, ProxyActor, Request, Response

deployment = make_deployment

_lock = threading.Lock()
_controller = None
_proxy = None
_proxy_addr = None


def _get_or_create_controller():
    global _controller
    import ray_tpu_torch

    with _lock:
        if _controller is not None:
            return _controller
        try:
            _controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        except Exception:  # noqa: BLE001 — not started yet
            remote_cls = ray_tpu_torch.remote(ServeController)
            # infinite restarts: a crashed controller comes back and
            # re-applies the declarative spec persisted in the GCS KV
            # (schema.py) — programmatic-only apps die with it, as in the
            # reference without a checkpointed config
            _controller = remote_cls.options(
                name=CONTROLLER_NAME, max_concurrency=16,
                max_restarts=-1).remote()
        return _controller


def _deploy_tree(app: Application, controller, deployed: dict,
                 name: Optional[str] = None) -> DeploymentHandle:
    """Model composition (reference ``serve.run(Driver.bind(A.bind(),
    B.bind()))``): nested Applications in init args/kwargs deploy first
    (depth-first) and are replaced by their DeploymentHandles — handles
    pickle across the process boundary, so the driver replica receives
    live handles to its sub-models."""
    import cloudpickle

    import ray_tpu_torch

    def resolve(v):
        if isinstance(v, Application):
            return _deploy_tree(v, controller, deployed)
        return v

    dep = app.deployment
    app_name = name or dep.name
    if app_name in deployed:
        return deployed[app_name]
    init_args = tuple(resolve(a) for a in app.init_args)
    init_kwargs = {k: resolve(v) for k, v in app.init_kwargs.items()}
    ray_tpu_torch.get([controller.deploy.remote(
        app_name, cloudpickle.dumps(dep),
        cloudpickle.dumps(dep.func_or_class),
        init_args, init_kwargs)])
    handle = DeploymentHandle(app_name, controller)
    deployed[app_name] = handle
    return handle


def run(app: Application, *, name: Optional[str] = None,
        blocking: bool = False, wait_timeout_s: float = 60.0
        ) -> DeploymentHandle:
    """Deploy an application — including any nested Applications bound
    as init args (model composition) — and return the top handle
    (reference ``serve.run``)."""
    import time

    import ray_tpu_torch

    controller = _get_or_create_controller()
    deployed: dict = {}
    handle = _deploy_tree(app, controller, deployed, name=name)
    # wait for at least one replica of EVERY deployed app (children
    # included: the driver's first call must not race their boot)
    deadline = time.monotonic() + wait_timeout_s
    for app_name in deployed:
        while True:
            _, replicas, *_ = ray_tpu_torch.get(
                [controller.get_replicas.remote(app_name)])[0]
            if replicas:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"no replica of {app_name!r} became ready")
            time.sleep(0.1)
    if blocking:  # pragma: no cover — interactive use
        while True:
            time.sleep(1)
    return handle


def start(http_host: str = "127.0.0.1", http_port: int = 0,
          grpc_port: Optional[int] = 0) -> Dict[str, Any]:
    """Start the ingress proxy (HTTP + optional gRPC); idempotent.
    Returns the bound addresses (reference: serve.start / ProxyActor)."""
    global _proxy, _proxy_addr
    import ray_tpu_torch

    import time as _time

    with _lock:
        if _proxy_addr is not None:
            return dict(_proxy_addr)
    _get_or_create_controller()
    with _lock:
        if _proxy is None:
            try:
                _proxy = ray_tpu_torch.get_actor(PROXY_NAME)
            except Exception:  # noqa: BLE001 — not started yet
                remote_cls = ray_tpu_torch.remote(ProxyActor)
                _proxy = remote_cls.options(
                    name=PROXY_NAME, max_concurrency=64).remote(
                        http_host, http_port, grpc_port)
        proxy = _proxy
    # start() is idempotent on the actor; poll until the listener is bound
    # so a port of 0 (pre-bind) is never cached or returned.
    addr = ray_tpu_torch.get([proxy.start.remote()], timeout=60.0)[0]
    deadline = _time.monotonic() + 60.0
    while not addr.get("http_port") and _time.monotonic() < deadline:
        _time.sleep(0.1)
        addr = ray_tpu_torch.get([proxy.address.remote()], timeout=30.0)[0]
    with _lock:
        if _proxy_addr is None and addr.get("http_port"):
            _proxy_addr = addr
    return dict(addr)


def deploy_config(config: Optional[Dict[str, Any]] = None, *,
                  app=None, name: str = "default",
                  wait: bool = True, timeout_s: float = 120.0
                  ) -> Dict[str, Any]:
    """Declarative deploy (reference: ``serve deploy`` + ``PUT
    /api/serve/applications/``): persist a validated app spec in the GCS
    KV; the controller reconciles running apps onto it — across its own
    restarts.  Pass either a full config dict (see serve/schema.py) or a
    bound ``app`` (cloudpickled into the spec for un-importable apps).
    Returns the apply status."""
    import json
    import time as _time

    import ray_tpu_torch
    from ray_tpu_torch.core_worker.worker import CoreWorker
    from ray_tpu_torch.serve import schema

    if (config is None) == (app is None):
        raise ValueError("pass exactly one of config / app")
    if app is not None:
        config = {"applications": [
            {"name": name, "pickled_app": schema.pack_application(app)}]}
    doc = schema.make_config_doc(config)
    _get_or_create_controller()  # controller watches the KV key
    gcs = CoreWorker.current_or_raise().gcs
    gcs.kv_put(schema.KV_NAMESPACE, schema.KV_CONFIG_KEY,
               json.dumps(doc).encode(), overwrite=True)
    if not wait:
        return {"version": doc["version"], "apps": {}}
    deadline = _time.monotonic() + timeout_s
    want = {a["name"] for a in doc["config"]["applications"]}
    while _time.monotonic() < deadline:
        raw = gcs.kv_get(schema.KV_NAMESPACE, schema.KV_APPLY_STATUS_KEY)
        if raw:
            st = json.loads(raw)
            if st.get("version") == doc["version"]:
                failed = {n: s for n, s in st["apps"].items()
                          if s.get("state") == "DEPLOY_FAILED"}
                if failed:
                    raise RuntimeError(f"declarative deploy failed: {failed}")
                live = ray_tpu_torch.get(
                    [_get_or_create_controller().status.remote()])[0]
                if all(live.get(n, {}).get("running_replicas", 0) > 0
                       for n in want):
                    return st
        _time.sleep(0.2)
    raise TimeoutError("declarative deploy did not converge "
                       f"within {timeout_s:.0f}s")


def get_declarative_config() -> Optional[Dict[str, Any]]:
    """The spec currently persisted in the GCS KV (None = none)."""
    import json

    from ray_tpu_torch.core_worker.worker import CoreWorker
    from ray_tpu_torch.serve import schema

    raw = CoreWorker.current_or_raise().gcs.kv_get(
        schema.KV_NAMESPACE, schema.KV_CONFIG_KEY)
    return json.loads(raw) if raw else None


def llm_app(model: str = "tiny", *, name: str = "llm",
            num_replicas: int = 1, num_slots: int = 8,
            speculation=None, ray_actor_options: Optional[dict] = None,
            **engine_kwargs) -> Application:
    """Build a bound LLM-serving Application — the declarative-config
    entry point for GPU LLM replicas (``import_path:
    "ray_tpu_torch.serve.api:llm_app"`` with ``args: {model: ..., speculation:
    {method: draft, draft_model: ..., k: ...}}``). ``speculation`` is
    validated eagerly (SpeculationConfig.parse — the same rules the
    config schema applies, minus its JSON-only restriction), so a bad
    spec fails at deploy time.

    Prefix caching: pass ``prefix_cache="radix"`` (with optional
    ``prefix_cache_bytes``) through ``engine_kwargs`` and set the
    deployment override ``request_router: prefix_aware`` so the handle
    routes shared-prefix traffic at the replica whose radix tree
    already holds it."""
    from ray_tpu_torch.models.speculation import SpeculationConfig
    from ray_tpu_torch.serve.llm import LLMServer

    if speculation is not None:
        # validate eagerly, but hand the ORIGINAL spec to the engine:
        # programmatic draft_config/draft_params objects are legal here
        # (schema.validate_speculation would reject them — its canonical
        # JSON form is for declarative configs, which must name a
        # draft_model instead). Same rules the engine applies at boot:
        # thread the sibling spec_k default and check draft_model
        # membership now, not minutes later on the replica.
        cfg = SpeculationConfig.parse(
            speculation, default_k=int(engine_kwargs.get("spec_k", 4)))
        if cfg.draft_model is not None and cfg.draft_config is None:
            from ray_tpu_torch.models import llama

            if cfg.draft_model not in llama.CONFIGS:
                raise ValueError(
                    f"speculation draft_model {cfg.draft_model!r}: not "
                    f"in {sorted(llama.CONFIGS)}")
        engine_kwargs["speculation"] = speculation
        engine_kwargs.setdefault("kv_cache", "slot")
    # a replica on the card must hold a GPU lease (ray_actor_options=
    # {"num_gpus": N}): a worker without one sees no CUDA device, and the
    # engine's device=None then raises instead of serving on the CPU
    dep = make_deployment(LLMServer, name=name,
                          num_replicas=num_replicas,
                          ray_actor_options=ray_actor_options)
    return dep.bind(model=model, num_slots=num_slots, **engine_kwargs)


def proxy_address() -> Optional[Dict[str, Any]]:
    return dict(_proxy_addr) if _proxy_addr else None


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name, _get_or_create_controller())


def status() -> Dict[str, Any]:
    import ray_tpu_torch

    return ray_tpu_torch.get([_get_or_create_controller().status.remote()])[0]


def delete(name: str):
    import ray_tpu_torch

    ray_tpu_torch.get([_get_or_create_controller().delete_app.remote(name)])


def shutdown():
    global _controller, _proxy, _proxy_addr
    import ray_tpu_torch

    with _lock:
        proxy, _proxy, _proxy_addr = _proxy, None, None
    if proxy is not None:
        try:
            ray_tpu_torch.get([proxy.stop.remote()], timeout=10.0)
            ray_tpu_torch.kill(proxy)
        except Exception:  # noqa: BLE001
            pass
    with _lock:
        if _controller is None:
            return
        try:
            ray_tpu_torch.get([_controller.shutdown.remote()], timeout=30.0)
            ray_tpu_torch.kill(_controller)
        except Exception:  # noqa: BLE001 — cluster may already be down
            pass
        _controller = None
