"""Layer rematerialisation (the counterpart of the ``jax.checkpoint``
policies of ``ray_tpu/models/llama.py:207-212``), shared by the Llama, MoE
and ViT blocks.

- ``"nothing"`` (``nothing_saveable``): only the layer's inputs are kept,
  and the backward recomputes the whole layer.
- ``"dots"`` (``dots_with_no_batch_dims_saveable``): the outputs of the
  matrix products without batch dimensions are kept. In this package those
  are the ``aten.mm`` calls, every 2-D ``@``: the weight products of
  ``llama._proj``, and the MoE router, dispatch and combine. ``aten.bmm``
  contracts over a batch dimension (the MoE expert products, the plain
  attention's scores), which JAX does not save either, so it is recomputed
  with everything else: norms, RoPE, activations and the flash forward.

As in the JAX package, every policy name other than ``"dots"`` means
``"nothing"``.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

# The ops whose outputs "dots" keeps (the rest are recomputed).
DOTS_SAVED = (torch.ops.aten.mm.default,)


def remat(block: Callable, policy: str = "nothing") -> Callable:
    """``block`` under ``torch.utils.checkpoint`` (non-reentrant) with the
    named policy. The wrapped block takes positional arguments and may
    return any nesting of tensors."""
    kw = {"use_reentrant": False}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, list(DOTS_SAVED))

    def wrapped(*args):
        return checkpoint(block, *args, **kw)

    return wrapped
