"""Weights across packages: the JAX package's parameter pytree, as numpy
arrays, becomes this package's parameter dict in the same layout.

``jax.random`` initialisations cannot be reproduced with torch generators,
so the two packages run on the same weights only by conversion.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _view(a: np.ndarray) -> torch.Tensor:
    # bfloat16 numpy arrays (ml_dtypes) have no torch.from_numpy route:
    # reinterpret the bits. Recognised by name, so ml_dtypes is not needed.
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tensor(a) -> torch.Tensor:
    return _view(np.array(a, order="C"))   # a writable copy: torch shares it


def tensor_from_host(a, device=None, dtype=None) -> torch.Tensor:
    """A host array (numpy, bf16 from ml_dtypes included, or a tensor) as
    a tensor of ``dtype`` on ``device``, for reading: the array is copied
    on the host only when it is not C-contiguous and writable."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        if not (a.flags.c_contiguous and a.flags.writeable):
            a = np.array(a, order="C")
        a = _view(a)
    return a.to(device=device, dtype=dtype)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor → a numpy copy of it on the host, in the JAX package's
    dtypes: bf16 comes out as ``ml_dtypes.bfloat16`` (the same bits)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree: Any, device=None) -> Any:
    """Nested dicts/lists of arrays → the same nesting of torch tensors,
    bit-for-bit, placed on ``device`` (default: the CPU)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    t = _tensor(tree)
    return t if device is None else t.to(device)


def train_state_from_jax(state: Any, device=None):
    """A JAX ``TrainState`` (``ray_tpu/models/training.py``: step, params,
    and the optax state of ``OptimizerConfig.make()``) → the port's
    :class:`~ray_tpu_torch.models.training.TrainState`, so that a run
    trained in JAX carries on here. The optax state is
    ``(clip state, (ScaleByAdamState(count, mu, nu), weight-decay state,
    ScaleByScheduleState(count)))``; its parts are found by their fields,
    so neither optax nor jax is imported."""
    from ray_tpu_torch.models.training import (AdamWState, TrainState,
                                               tree_leaves)

    adam = schedule = None
    stack = [state.opt_state]
    while stack:
        node = stack.pop()
        fields = getattr(node, "_fields", ())          # optax NamedTuples
        if {"count", "mu", "nu"} <= set(fields):
            adam = node
        elif tuple(fields) == ("count",):
            schedule = node
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    if adam is None or schedule is None:
        raise ValueError("opt_state holds no Adam and schedule state: not "
                         "the state of OptimizerConfig.make()")
    params = params_from_jax(state.params, device)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    return TrainState(
        step=int(np.asarray(state.step)), params=params,
        opt_state=AdamWState(
            adam_count=int(np.asarray(adam.count)),
            mu=params_from_jax(adam.mu, device),
            nu=params_from_jax(adam.nu, device),
            schedule_count=int(np.asarray(schedule.count))))


def params_to(tree: Any, device) -> Any:
    """A parameter dict with every tensor on ``device``; tensors already
    there are the same objects (no copy)."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    return tree.to(device)
