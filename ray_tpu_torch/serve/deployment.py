"""Deployment descriptor (reference ``python/ray/serve/deployment.py``).

``@serve.deployment`` wraps a class (or function) with replica/resource/
autoscaling options; ``.bind(*args)`` produces an Application ready for
``serve.run``. Replicas are plain actors; the callable convention is
``__call__`` (functions are auto-wrapped).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple


@dataclasses.dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_threshold: float = 1.25    # scale up when load > target*this
    downscale_threshold: float = 0.5   # scale down when load < target*this


@dataclasses.dataclass
class Deployment:
    func_or_class: Any
    name: str
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    ray_actor_options: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    autoscaling_config: Optional[AutoscalingConfig] = None
    # HTTP ingress mount point (reference: Deployment.route_prefix);
    # None → "/<name>" at serve.run time.
    route_prefix: Optional[str] = None
    # "pow2" (power-of-two-choices) or "prefix_aware": requests whose
    # first argument shares a prefix route to the same replica so its
    # engine-side prefix cache hits (reference: serve request_router/
    # prefix-aware router over vLLM's prefix caching).
    request_router: str = "pow2"
    # How long a draining replica (redeploy, downscale, health ejection)
    # may finish in-flight work — including open SSE streams — before the
    # controller kills it (reference: graceful_shutdown_timeout_s).
    graceful_shutdown_timeout_s: float = 10.0

    def options(self, **kwargs) -> "Deployment":
        return dataclasses.replace(self, **kwargs)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)


@dataclasses.dataclass
class Application:
    deployment: Deployment
    init_args: Tuple
    init_kwargs: Dict[str, Any]


class _FunctionReplica:
    """Adapter: function deployments become single-method callables."""

    def __init__(self, fn: Callable):
        self._fn = fn

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


def make_deployment(func_or_class=None, *, name: Optional[str] = None,
                    num_replicas: int = 1, max_ongoing_requests: int = 8,
                    ray_actor_options: Optional[dict] = None,
                    autoscaling_config: Optional[dict] = None,
                    route_prefix: Optional[str] = None,
                    request_router: str = "pow2",
                    graceful_shutdown_timeout_s: float = 10.0) -> Any:
    def wrap(target):
        import functools

        cls = target
        if not isinstance(target, type):
            cls = functools.partial(_FunctionReplica, target)
            cls.__name__ = getattr(target, "__name__", "function_deployment")
        asc = autoscaling_config
        if isinstance(asc, dict):
            asc = AutoscalingConfig(**asc)
        return Deployment(
            func_or_class=cls,
            name=name or getattr(target, "__name__", "deployment"),
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            ray_actor_options=dict(ray_actor_options or {}),
            autoscaling_config=asc,
            route_prefix=route_prefix,
            request_router=request_router,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
        )

    if func_or_class is not None:
        return wrap(func_or_class)
    return wrap
