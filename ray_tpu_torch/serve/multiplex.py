"""Model multiplexing: many models time-sharing one replica pool.

Reference: ``python/ray/serve/multiplex.py`` (_ModelMultiplexWrapper),
``python/ray/serve/api.py`` (``@serve.multiplexed``,
``serve.get_multiplexed_model_id``). A deployment decorates a loader
``def get_model(model_id)`` with ``@serve.multiplexed(max_num_models_per_
replica=N)``; each replica then caches up to N loaded models with LRU
eviction, and the handle routes a request tagged
``handle.options(multiplexed_model_id="m1")`` to a replica that already
holds the model (model-affinity routing in ``handle._RouterState``).

GPU framing: "loading a model" is typically staging weights into the
replica's device memory — eviction really frees device memory, so the LRU
cap is the memory budget knob. Loads are serialized per replica (one
staging at a time) like the reference's per-wrapper lock.
"""

from __future__ import annotations

import contextvars
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, List, Optional

_current_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "rt_serve_multiplexed_model_id", default="")

# Wrappers alive in this process, weakly held: a deleted replica's
# wrapper (and the models it caches) must be collectable, not pinned by
# this introspection registry.
_REGISTRY: "weakref.WeakSet[_ModelMultiplexWrapper]" = weakref.WeakSet()
_REGISTRY_LOCK = threading.Lock()


def get_multiplexed_model_id() -> str:
    """Inside a replica handling a request: the model id the caller set
    via ``handle.options(multiplexed_model_id=...)`` (reference:
    ``serve.get_multiplexed_model_id``)."""
    return _current_model_id.get()


def loaded_model_ids(scope: Any = None) -> List[str]:
    """Model ids currently loaded. With ``scope`` (a deployment
    instance), only that instance's wrappers — the replica harness uses
    this so each replica reports its own placement; without it, the
    union across the process (debug introspection)."""
    if scope is not None:
        wrappers = [w for w in getattr(scope, "__dict__", {}).values()
                    if isinstance(w, _ModelMultiplexWrapper)]
    else:
        with _REGISTRY_LOCK:
            wrappers = list(_REGISTRY)
    out: List[str] = []
    for w in wrappers:
        out.extend(w.model_ids())
    return out


class _ModelMultiplexWrapper:
    """LRU cache of model_id -> loaded model around a user loader fn."""

    def __init__(self, loader: Callable[..., Any], max_models: int):
        if max_models < 1:
            raise ValueError("max_num_models_per_replica must be >= 1")
        self._loader = loader
        self._max = max_models
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self._load_s = 0.0  # cumulative load time, for metrics
        self.__name__ = getattr(loader, "__name__", "multiplexed")
        with _REGISTRY_LOCK:
            _REGISTRY.add(self)

    def model_ids(self) -> List[str]:
        with self._lock:
            return list(self._models)

    def _evict_lru(self) -> None:
        mid, model = self._models.popitem(last=False)
        del mid
        # Reference calls __del__ semantics: drop the reference and let
        # finalizers free device memory; an explicit unload hook wins.
        unload = getattr(model, "unload", None)
        if callable(unload):
            try:
                unload()
            except Exception:  # noqa: BLE001 — eviction must not fail
                pass

    def load(self, model_id: Optional[str] = None, *args: Any) -> Any:
        """Return the loaded model for ``model_id`` (default: the current
        request's multiplexed id), loading + LRU-evicting as needed."""
        mid = model_id if model_id is not None else _current_model_id.get()
        if not mid:
            raise ValueError(
                "no model id: pass one explicitly or set "
                "handle.options(multiplexed_model_id=...) on the caller")
        with self._lock:
            if mid in self._models:
                self._models.move_to_end(mid)
                return self._models[mid]
            # load outside? Reference serializes loads per wrapper; with
            # the lock held the load also blocks lookups, matching the
            # one-load-at-a-time behavior and keeping eviction atomic.
            while len(self._models) >= self._max:
                self._evict_lru()
            t0 = time.monotonic()
            model = self._loader(mid, *args)
            self._load_s += time.monotonic() - t0
            self._models[mid] = model
            return model

    # the decorated loader is called like the original function
    __call__ = load


def multiplexed(func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator form (reference ``serve.multiplexed``)::

        class LLMHost:
            @serve.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id: str):
                return load_weights_to_hbm(model_id)

            def __call__(self, prompt):
                model = self.get_model(serve.get_multiplexed_model_id())
                ...

    Methods are supported: the wrapper binds per-instance on first
    access so each replica instance gets its own LRU cache.
    """

    def wrap(fn: Callable):
        return _MultiplexedDescriptor(fn, max_num_models_per_replica)

    return wrap(func) if func is not None else wrap


class _MultiplexedDescriptor:
    """Descriptor so ``@multiplexed`` works on methods and functions."""

    def __init__(self, fn: Callable, max_models: int):
        self._fn = fn
        self._max = max_models
        self._plain: Optional[_ModelMultiplexWrapper] = None
        self._attr = f"__rt_multiplex_{id(self)}"

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        wrapper = getattr(obj, self._attr, None)
        if wrapper is None:
            bound = self._fn.__get__(obj, objtype)
            wrapper = _ModelMultiplexWrapper(bound, self._max)
            setattr(obj, self._attr, wrapper)
        return wrapper

    def __call__(self, *args, **kwargs):  # plain-function use
        if self._plain is None:
            self._plain = _ModelMultiplexWrapper(self._fn, self._max)
        return self._plain(*args, **kwargs)


def set_request_model_id(model_id: str) -> contextvars.Token:
    """Replica harness: bind the request's model id for the duration of
    the user call (pops on reset)."""
    return _current_model_id.set(model_id or "")


def reset_request_model_id(token: contextvars.Token) -> None:
    _current_model_id.reset(token)
