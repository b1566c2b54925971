"""User-facing actor machinery (reference: python/ray/actor.py).

``@ray_tpu_torch.remote`` on a class yields an :class:`ActorClass`; ``.remote(...)``
creates the actor via the GCS and returns an :class:`ActorHandle` whose method
proxies submit sequenced actor tasks.  Handles are serializable — passing one
to another task/actor gives that process its own submitter to the same actor.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.common.ids import ActorID


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns=1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def remote(self, *args, **kwargs):
        from .worker import CoreWorker

        cw = CoreWorker._current
        if cw is None:
            raise RuntimeError("ray_tpu_torch.init() must be called first")
        if self._num_returns == "streaming":
            return cw.submit_actor_task(
                self._handle._actor_id, self._method_name, args, kwargs,
                streaming=True)
        refs = cw.submit_actor_task(
            self._handle._actor_id, self._method_name, args, kwargs,
            num_returns=self._num_returns)
        return refs[0] if self._num_returns == 1 else refs

    def options(self, num_returns=1):
        return ActorMethod(self._handle, self._method_name, num_returns)


class ActorHandle:
    def __init__(self, actor_id: ActorID, method_names: Optional[list] = None):
        self._actor_id = actor_id
        self._method_names = method_names or []

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if self._method_names and name not in self._method_names:
            raise AttributeError(f"actor has no method {name!r}")
        return ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:12]}…)"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_names))


class ActorClass:
    def __init__(self, cls, default_options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._default_options = default_options or {}
        # per-class work hoisted off the per-creation critical path:
        # cloudpickling the class and scanning it for methods cost ~ms
        # each — at actor-churn rates that is a large share of the
        # driver-side creation budget
        self._serialized_cls: Optional[bytes] = None
        self._methods: Optional[list] = None
        self._default_concurrency: Optional[int] = None

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._create(args, kwargs, self._default_options)

    def options(self, **opts) -> "ActorClassOptions":
        merged = dict(self._default_options)
        merged.update(opts)
        return ActorClassOptions(self, merged)

    def bind(self, *args, **kwargs):
        """Compiled-graph entry (reference: dag API); see
        ray_tpu_torch.graph."""
        from ray_tpu_torch.graph.dag import ClassNode

        return ClassNode(self, args, kwargs, self._default_options)

    def _create(self, args, kwargs, opts):
        from .worker import CoreWorker

        cw = CoreWorker._current
        if cw is None:
            raise RuntimeError("ray_tpu_torch.init() must be called first")
        sched = _strategy_from_options(opts)
        if self._default_concurrency is None:
            # Async actors (any ``async def`` method) default to high
            # concurrency: calls interleave on the actor's event loop
            # rather than queueing (reference python/ray/actor.py
            # DEFAULT_MAX_CONCURRENCY_ASYNC=1000).
            import inspect

            self._default_concurrency = 1000 if any(
                inspect.iscoroutinefunction(getattr(self._cls, m, None))
                for m in dir(self._cls) if not m.startswith("__")) else 1
        if self._serialized_cls is None:
            import cloudpickle

            self._serialized_cls = cloudpickle.dumps(self._cls)
        actor_id = cw.create_actor(
            self._cls, args, kwargs,
            resources=_resources_from_options(opts, for_actor=True),
            label_selector=opts.get("label_selector"),
            scheduling_strategy=sched,
            max_restarts=opts.get("max_restarts", 0),
            max_concurrency=opts.get("max_concurrency",
                                     self._default_concurrency),
            name=opts.get("name"),
            namespace=opts.get("namespace", "default"),
            runtime_env=opts.get("runtime_env"),
            serialized_cls=self._serialized_cls,
        )
        if self._methods is None:
            self._methods = [
                m for m in dir(self._cls)
                if not m.startswith("_") and callable(getattr(self._cls, m))]
        return ActorHandle(actor_id, self._methods)


class ActorClassOptions:
    def __init__(self, actor_class: ActorClass, opts: Dict[str, Any]):
        self._actor_class = actor_class
        self._opts = opts

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._actor_class._create(args, kwargs, self._opts)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.graph.dag import ClassNode

        return ClassNode(self._actor_class, args, kwargs, self._opts)


def _resources_from_options(opts: Dict[str, Any], for_actor: bool = False) -> Dict[str, float]:
    """Tasks default to 1 CPU; actors default to 0 lifetime CPUs (as in the
    reference, where an idle actor holds no CPU so actor count isn't bounded
    by cores)."""
    resources = dict(opts.get("resources") or {})
    if "num_cpus" in opts:
        resources["CPU"] = opts["num_cpus"]
    elif not resources and not for_actor:
        resources["CPU"] = 1
    if "num_tpus" in opts:
        resources["TPU"] = opts["num_tpus"]
    if "num_gpus" in opts:
        resources["GPU"] = opts["num_gpus"]
    if "memory" in opts:
        resources["memory"] = opts["memory"]
    return resources


def _strategy_from_options(opts: Dict[str, Any]):
    from ray_tpu_torch.common.task_spec import (
        NodeAffinityStrategy,
        NodeLabelStrategy,
        PlacementGroupStrategy,
        SpreadStrategy,
    )

    strategy = opts.get("scheduling_strategy")
    if strategy is None:
        return None
    if isinstance(strategy, str):
        if strategy == "SPREAD":
            return SpreadStrategy()
        if strategy == "DEFAULT":
            return None
        raise ValueError(f"unknown scheduling strategy {strategy!r}")
    if isinstance(strategy, (NodeAffinityStrategy, NodeLabelStrategy, PlacementGroupStrategy,
                             SpreadStrategy)):
        return strategy
    # PlacementGroupSchedulingStrategy-style object from placement_group module
    if hasattr(strategy, "to_spec_strategy"):
        return strategy.to_spec_strategy()
    raise ValueError(f"bad scheduling strategy {strategy!r}")
