"""Weights across packages: the JAX package's parameter pytree, as numpy
arrays, becomes this package's parameter dict in the same layout.

``jax.random`` initialisations cannot be reproduced with torch generators,
so the two packages run on the same weights only by conversion.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.array(a, order="C")     # a writable copy: torch shares it
    # bfloat16 numpy arrays (ml_dtypes) have no torch.from_numpy route:
    # reinterpret the bits. Recognised by name, so ml_dtypes is not needed.
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: Any, device=None) -> Any:
    """Nested dicts/lists of arrays → the same nesting of torch tensors,
    bit-for-bit, placed on ``device`` (default: the CPU)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    t = _tensor(tree)
    return t if device is None else t.to(device)
