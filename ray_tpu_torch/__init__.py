"""ray_tpu_torch — the PyTorch + CUDA port of ``ray_tpu`` for NVIDIA Hopper.

The JAX package ``ray_tpu`` is the reference; this package re-implements its
modules under the same module and function names, in PyTorch, with every
Pallas TPU kernel replaced by a CUDA C++ kernel written for ``sm_90a``
(``ray_tpu_torch/csrc``). It imports torch, numpy and the standard library
only — never jax and never anything of ``ray_tpu``.

The runtime's public surface (``init``, ``@remote``, ``get``/``put``/
``wait``, actors, placement groups) and the submodules resolve lazily
(PEP 562), as in ``ray_tpu/__init__.py``: ``import ray_tpu_torch`` imports
neither torch nor the runtime, so a worker process loads torch only when a
value it handles holds a tensor.
"""

import importlib

__version__ = "0.1.0"

_API_SYMBOLS = {
    "ObjectRef",
    "ObjectRefGenerator",
    "available_resources",
    "cancel",
    "cluster_resources",
    "get",
    "get_actor",
    "get_async",
    "get_runtime_context",
    "init",
    "is_initialized",
    "kill",
    "method",
    "nodes",
    "put",
    "remote",
    "shutdown",
    "timeline",
    "wait",
}
_PG_SYMBOLS = {"placement_group", "remove_placement_group",
               "placement_group_table"}
_SUBMODULES = {
    "ops", "models", "serve", "bench", "common", "rpc", "gcs", "raylet",
    "object_store", "core_worker", "scheduling", "runtime_env", "util",
    "api", "graph", "collective", "cluster_utils", "parallel", "train",
    "rl", "data", "tune", "llm",
}
# the JAX package's modules a later slice brings (common/status.py::WAITING)
_WAITING = {"client", "dashboard", "job", "autoscaler", "control_plane"}


def resolve_device(device=None):
    """Entry points run on the card unless the caller asks for the CPU:
    ``None`` means ``"cuda"``, and a CUDA device without CUDA raises (there
    is no silent fall back to the CPU)."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on a CUDA device by default, and CUDA is not "
            "available here; pass device='cpu' to run on the CPU explicitly")
    return dev


def __getattr__(name):
    if name in _API_SYMBOLS:
        value = getattr(importlib.import_module("ray_tpu_torch.api"), name)
    elif name in _PG_SYMBOLS:
        value = getattr(importlib.import_module(
            "ray_tpu_torch.core_worker.placement_group"), name)
    elif name in _SUBMODULES:
        value = importlib.import_module(f"ray_tpu_torch.{name}")
    elif name in _WAITING:
        from ray_tpu_torch.common.status import not_ported

        raise not_ported(name)
    else:
        raise AttributeError(
            f"module 'ray_tpu_torch' has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(_API_SYMBOLS | _PG_SYMBOLS | _SUBMODULES
                  | {"__version__", "resolve_device"})
