"""ray_tpu_torch — the PyTorch + CUDA port of ``ray_tpu`` for NVIDIA Hopper.

The JAX package ``ray_tpu`` is the reference; this package re-implements its
modules under the same module and function names, in PyTorch, with every
Pallas TPU kernel replaced by a CUDA C++ kernel written for ``sm_90a``
(``ray_tpu_torch/csrc``). It imports torch, numpy and the standard library
only — never jax and never anything of ``ray_tpu``.

Submodules resolve lazily (PEP 562), as in ``ray_tpu/__init__.py``, so that
``import ray_tpu_torch`` costs one torch import and nothing else.
"""

import importlib

import torch

__version__ = "0.1.0"

_SUBMODULES = {"ops", "models", "serve", "bench"}


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU:
    ``None`` means ``"cuda"``, and a CUDA device without CUDA raises (there
    is no silent fall back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on a CUDA device by default, and CUDA is not "
            "available here; pass device='cpu' to run on the CPU explicitly")
    return dev


def __getattr__(name):
    if name in _SUBMODULES:
        value = importlib.import_module(f"ray_tpu_torch.{name}")
    else:
        raise AttributeError(
            f"module 'ray_tpu_torch' has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(_SUBMODULES | {"__version__", "resolve_device"})
