"""Declarative Serve app specs (reference: ``python/ray/serve/schema.py``
``ServeDeploySchema`` / ``ServeApplicationSchema`` and the ``serve deploy``
CLI + ``PUT /api/serve/applications/`` REST route).

A config is data, not code::

    applications:
      - name: text_app
        import_path: my_pkg.serving:app      # Application or builder fn
        route_prefix: /text
        args: {model: "1b"}                  # builder-fn kwargs
        deployments:                          # per-deployment overrides
          - name: TextModel
            num_replicas: 2

The validated config is persisted in the GCS KV (``serve`` /
``declarative_config``); the Serve controller watches that key and
reconciles the running apps to it — so the spec survives controller
crashes and restarts (the reference persists the same schema in its
controller checkpoint).  ``pickled_app`` (base64 cloudpickle of a bound
Application) is an internal alternative to ``import_path`` used by
``serve.deploy_config(app=...)`` when the app isn't importable by name.
"""

from __future__ import annotations

import base64
from typing import Any, Dict, List

KV_NAMESPACE = "serve"
KV_CONFIG_KEY = b"declarative_config"
KV_APPLY_STATUS_KEY = b"declarative_apply_status"

# deployment-level fields an operator may override without touching code
_DEPLOYMENT_OVERRIDES = (
    "num_replicas", "max_ongoing_requests", "route_prefix",
    "request_router", "graceful_shutdown_timeout_s",
)


class ServeConfigError(ValueError):
    pass


def validate_speculation(spec, default_k: int = 4) -> Dict[str, Any]:
    """Canonicalize a speculative-decoding spec (method string or dict —
    see ``ray_tpu_torch.models.speculation.SpeculationConfig``) into its
    JSON-able form. Declarative LLM apps carry this under
    ``args.speculation`` (vLLM parity: the reference forwards
    ``speculative_config`` to the vLLM engine).

    The canonical form is what the replica boots from, and it cannot
    carry live ``draft_config``/``draft_params`` objects — a draft spec
    whose only source is an object is rejected HERE, at deploy time,
    instead of passing validation and failing replica boot minutes
    later (programmatic callers with real objects go through
    ``serve.api.llm_app``, which forwards the originals)."""
    from ray_tpu_torch.models.speculation import SpeculationConfig

    try:
        cfg = SpeculationConfig.parse(spec, default_k=default_k)
    except ValueError as e:
        raise ServeConfigError(f"speculation: {e}") from e
    if cfg.method == "draft":
        if cfg.draft_model is None:
            raise ServeConfigError(
                "speculation: draft_config/draft_params objects are not "
                "JSON-serializable — declarative configs must name a "
                "draft_model (ray_tpu_torch.models.llama.CONFIGS)")
        from ray_tpu_torch.models import llama

        if cfg.draft_model not in llama.CONFIGS:
            raise ServeConfigError(
                f"speculation: draft_model {cfg.draft_model!r} is not in "
                f"{sorted(llama.CONFIGS)}")
    return cfg.to_dict()


def validate_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Validate + normalize a deploy config dict.  Returns the canonical
    form; raises ServeConfigError with a field path on bad input."""
    if not isinstance(config, dict):
        raise ServeConfigError("config must be a mapping")
    apps = config.get("applications")
    if not isinstance(apps, list) or not apps:
        raise ServeConfigError("config.applications must be a non-empty list")
    out_apps: List[Dict[str, Any]] = []
    seen = set()
    for i, app in enumerate(apps):
        where = f"applications[{i}]"
        if not isinstance(app, dict):
            raise ServeConfigError(f"{where} must be a mapping")
        name = app.get("name")
        if not name or not isinstance(name, str):
            raise ServeConfigError(f"{where}.name is required")
        if name in seen:
            raise ServeConfigError(f"duplicate application name {name!r}")
        seen.add(name)
        has_import = isinstance(app.get("import_path"), str)
        has_blob = isinstance(app.get("pickled_app"), str)
        if has_import == has_blob:
            raise ServeConfigError(
                f"{where} needs exactly one of import_path / pickled_app")
        if has_import and ":" not in app["import_path"]:
            raise ServeConfigError(
                f"{where}.import_path must look like 'module.sub:attr'")
        args = app.get("args") or {}
        if not isinstance(args, dict):
            raise ServeConfigError(f"{where}.args must be a mapping")
        if args.get("speculation") is not None:
            # canonicalize eagerly so a bad spec fails the deploy call,
            # not the replica boot minutes later; thread the sibling
            # spec_k kwarg through so a spec with no explicit k inherits
            # it instead of pinning the canonical form to the default
            try:
                default_k = int(args.get("spec_k", 4))
            except (TypeError, ValueError):
                raise ServeConfigError(
                    f"{where}.args.spec_k must be an integer, got "
                    f"{args['spec_k']!r}") from None
            try:
                args = dict(args,
                            speculation=validate_speculation(
                                args["speculation"],
                                default_k=default_k))
            except ServeConfigError as e:
                # e already reads "speculation: ..." — just add the path
                raise ServeConfigError(f"{where}.args.{e}") from e
        if args.get("prefix_cache") is not None:
            # same reject-at-deploy-time contract as speculation: the
            # engine enforces these in __init__, but a typo'd mode
            # should fail the deploy call, not the replica boot
            pc = args["prefix_cache"]
            if pc not in ("radix", "legacy", "off"):
                raise ServeConfigError(
                    f"{where}.args.prefix_cache must be 'radix', "
                    f"'legacy' or 'off', got {pc!r}")
        if args.get("prefix_cache_bytes") is not None:
            try:
                pcb = int(args["prefix_cache_bytes"])
                if pcb < 0:
                    raise ValueError
            except (TypeError, ValueError):
                raise ServeConfigError(
                    f"{where}.args.prefix_cache_bytes must be a "
                    f"non-negative integer, got "
                    f"{args['prefix_cache_bytes']!r}") from None
            args = dict(args, prefix_cache_bytes=pcb)
        deployments = app.get("deployments") or []
        if not isinstance(deployments, list):
            raise ServeConfigError(f"{where}.deployments must be a list")
        norm_deps = []
        for j, d in enumerate(deployments):
            dw = f"{where}.deployments[{j}]"
            if not isinstance(d, dict) or not d.get("name"):
                raise ServeConfigError(f"{dw} needs a name")
            unknown = set(d) - {"name", *_DEPLOYMENT_OVERRIDES}
            if unknown:
                raise ServeConfigError(
                    f"{dw} has unknown fields {sorted(unknown)}; "
                    f"overridable: {sorted(_DEPLOYMENT_OVERRIDES)}")
            norm_deps.append(dict(d))
        entry: Dict[str, Any] = {"name": name, "args": args,
                                 "deployments": norm_deps}
        if has_import:
            entry["import_path"] = app["import_path"]
        else:
            entry["pickled_app"] = app["pickled_app"]
        if app.get("route_prefix") is not None:
            rp = app["route_prefix"]
            if not isinstance(rp, str) or not rp.startswith("/"):
                raise ServeConfigError(
                    f"{where}.route_prefix must start with '/'")
            entry["route_prefix"] = rp
        out_apps.append(entry)
    return {"applications": out_apps}


def make_config_doc(config: Dict[str, Any]) -> Dict[str, Any]:
    """Validate and wrap a config into the one canonical KV document
    shape — every submission path (python API, CLI, dashboard REST) MUST
    build the doc here so version-matching stays consistent."""
    import time

    return {"version": time.time_ns(), "config": validate_config(config)}


def pack_application(app) -> str:
    """cloudpickle an in-memory bound Application into the config's
    ``pickled_app`` transport form."""
    import cloudpickle

    return base64.b64encode(cloudpickle.dumps(app)).decode()


def resolve_application(entry: Dict[str, Any]):
    """Materialize an app entry: import (or unpickle) and, for builder
    functions, call with ``args``.  Returns a bound Application."""
    from ray_tpu_torch.serve.deployment import Application

    if "pickled_app" in entry:
        import cloudpickle

        app = cloudpickle.loads(base64.b64decode(entry["pickled_app"]))
    else:
        import importlib

        mod_name, _, attr = entry["import_path"].partition(":")
        obj = getattr(importlib.import_module(mod_name), attr)
        app = obj(**entry.get("args", {})) if callable(obj) \
            and not isinstance(obj, Application) else obj
    if not isinstance(app, Application):
        raise ServeConfigError(
            f"app {entry['name']!r} resolved to {type(app).__name__}, "
            "expected a bound Application (use Deployment.bind())")
    return app


def apply_overrides(app, entry: Dict[str, Any]) -> None:
    """Apply the config's per-deployment overrides + app-level
    route_prefix onto the resolved deployment objects (in place —
    Applications are built fresh per apply)."""
    from ray_tpu_torch.serve.deployment import Application

    deps_by_name = {}

    def collect(a):
        deps_by_name[a.deployment.name] = a.deployment
        for v in list(a.init_args) + list(a.init_kwargs.values()):
            if isinstance(v, Application):
                collect(v)

    collect(app)
    if entry.get("route_prefix") is not None:
        app.deployment.route_prefix = entry["route_prefix"]
    for d in entry.get("deployments", []):
        dep = deps_by_name.get(d["name"])
        if dep is None:
            raise ServeConfigError(
                f"override for unknown deployment {d['name']!r} "
                f"(have: {sorted(deps_by_name)})")
        for k, v in d.items():
            if k != "name":
                setattr(dep, k, v)
