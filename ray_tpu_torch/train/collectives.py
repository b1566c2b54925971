"""Train-worker collective sugar (port of ``ray_tpu/train/collectives.py``;
reference: ``python/ray/train/collective/collectives.py`` —
``broadcast_from_rank_zero:20``, ``barrier:82``).

Control-plane-sized values only (configs, seeds, small metadata): these
ride the GCS KV rendezvous namespace, like the reference routes them
through the controller and actors rather than the tensor fabric. Tensor-sized
data belongs in the process group's collectives (NCCL on the GPU, the
collectives DTensor inserts) — broadcasting gigabytes through the KV
store is the anti-pattern this docstring exists to warn about.

Each call auto-synchronizes on a per-experiment epoch counter, so
repeated broadcasts/barriers in a training loop need no explicit keys.
"""

from __future__ import annotations

import pickle
import time
from typing import Any, Dict, Optional

import numpy as np

from ray_tpu_torch.train.context import get_context


def _kv():
    from ray_tpu_torch.core_worker.worker import CoreWorker

    return CoreWorker.current_or_raise().gcs


_epochs = {"broadcast": 0, "barrier": 0}


def broadcast_from_rank_zero(data: Any = None, *,
                             timeout_s: float = 120.0) -> Any:
    """Rank 0 passes ``data``; every rank returns rank 0's value."""
    ctx = get_context()
    _epochs["broadcast"] += 1
    # run_id keys the namespace per gang INSTANCE: a restart or a rerun
    # of the same experiment name must never read a previous attempt's
    # rendezvous keys (they are left behind — control-plane sized)
    ns = f"rt_train_bcast:{ctx.get_experiment_name()}:{ctx.get_run_id()}"
    key = f"epoch:{_epochs['broadcast']}".encode()
    kv = _kv()
    if ctx.get_world_rank() == 0:
        kv.kv_put(ns, key, pickle.dumps(data))
        return data
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        blob = kv.kv_get(ns, key)
        if blob is not None:
            return pickle.loads(blob)
        time.sleep(0.05)
    raise TimeoutError(
        f"broadcast_from_rank_zero: rank 0 never published epoch "
        f"{_epochs['broadcast']}")


def barrier(*, timeout_s: float = 120.0,
            tag: Optional[str] = None) -> None:
    """Block until every worker in the gang has arrived. ``tag`` only
    labels the barrier for debugging; every call advances the epoch
    counter, so the same tag in a loop still synchronizes each pass."""
    ctx = get_context()
    _epochs["barrier"] += 1
    epoch = f"{tag or 'b'}:{_epochs['barrier']}"
    ns = (f"rt_train_barrier:{ctx.get_experiment_name()}:"
          f"{ctx.get_run_id()}:{epoch}")
    kv = _kv()
    kv.kv_put(ns, f"arrived:{ctx.get_world_rank()}".encode(), b"1")
    world = ctx.get_world_size()
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if len(kv.kv_keys(ns, prefix=b"arrived:")) >= world:
            return
        time.sleep(0.05)
    raise TimeoutError(
        f"barrier {epoch!r}: not all {world} workers arrived in "
        f"{timeout_s}s")


# ---------------------------------------------------------------------------
# ZeRO-style sharded optimizer state (per "Automatic Cross-Replica Sharding
# of Weight Update"): each data-parallel replica keeps optimizer state for
# only its 1/W shard of the flat parameter vector.  One step is
#
#     reducescatter(grads)  ->  shard-local update  ->  allgather(params)
#
# so per-replica optimizer memory drops by W and the wire carries one
# grad-shard in and one param-shard out instead of a full allreduce, while
# the math stays EXACTLY the replicated update: reducescatter then a
# shard-local elementwise update then allgather commutes with updating the
# full vector everywhere (the parity the round-trip test asserts).
# ---------------------------------------------------------------------------


class FlatOptimizer:
    """Elementwise first-order optimizers over flat numpy vectors.

    Deliberately array-sliceable: updating a contiguous shard of the
    parameter vector with the matching shard of state gives bit-identical
    results to slicing the full-vector update — the property ZeRO
    sharding relies on.  Supported kinds: ``sgd``, ``momentum``, ``adam``.
    """

    def __init__(self, kind: str = "sgd", lr: float = 0.01,
                 momentum: float = 0.9, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8):
        if kind not in ("sgd", "momentum", "adam"):
            raise ValueError(f"unknown optimizer kind {kind!r}")
        self.kind = kind
        self.lr = lr
        self.momentum = momentum
        self.beta1, self.beta2, self.eps = beta1, beta2, eps

    def init_state(self, n: int, dtype=np.float32) -> Dict[str, Any]:
        if self.kind == "sgd":
            return {"t": 0}
        if self.kind == "momentum":
            return {"t": 0, "m": np.zeros(n, dtype=dtype)}
        return {"t": 0, "m": np.zeros(n, dtype=dtype),
                "v": np.zeros(n, dtype=dtype)}

    def update(self, params: np.ndarray, grads: np.ndarray,
               state: Dict[str, Any]) -> np.ndarray:
        """One step; mutates ``state`` in place, returns new params."""
        params = np.asarray(params)
        grads = np.asarray(grads, dtype=params.dtype)
        state["t"] += 1
        if self.kind == "sgd":
            return params - self.lr * grads
        if self.kind == "momentum":
            state["m"] = self.momentum * state["m"] + grads
            return params - self.lr * state["m"]
        t = state["t"]
        state["m"] = self.beta1 * state["m"] + (1 - self.beta1) * grads
        state["v"] = self.beta2 * state["v"] + (1 - self.beta2) * grads ** 2
        mhat = state["m"] / (1 - self.beta1 ** t)
        vhat = state["v"] / (1 - self.beta2 ** t)
        return params - self.lr * mhat / (np.sqrt(vhat) + self.eps)


class ZeroShardedOptimizer:
    """ZeRO stage-1/2 weight update over a member-style collective group
    (each member calls with its own full-size local arrays; KVGroup is the
    cross-process transport, and its quantized wire carries the
    reducescatter when ``RT_quantized_collectives`` is on).

    The flat vector is zero-padded to a multiple of ``world_size``; this
    member owns contiguous shard ``rank`` and holds optimizer state for
    that shard only.
    """

    def __init__(self, group, optimizer: FlatOptimizer):
        self._group = group
        self._opt = optimizer
        self._state: Optional[Dict[str, Any]] = None
        self._shard_n = 0

    @property
    def state(self) -> Optional[Dict[str, Any]]:
        return self._state

    def step(self, params: np.ndarray, grads: np.ndarray,
             average: bool = True) -> np.ndarray:
        """One synchronized update; every member returns the same full,
        updated parameter vector.  ``average`` divides the reduced grads
        by world size (data-parallel mean)."""
        group = self._group
        W = group.world_size
        params = np.asarray(params)
        grads = np.asarray(grads)
        if params.ndim != 1 or params.shape != grads.shape:
            raise ValueError(
                f"flat vectors required: params {params.shape} grads "
                f"{grads.shape}")
        n = params.size
        npad = -(-n // W) * W
        shard_n = npad // W
        gpad = np.pad(grads, (0, npad - n))
        grad_shard = np.asarray(group.reducescatter(gpad))
        if average:
            grad_shard = grad_shard / W
        if self._state is None or self._shard_n != shard_n:
            self._state = self._opt.init_state(shard_n, params.dtype)
            self._shard_n = shard_n
        lo = group.rank * shard_n
        param_shard = np.pad(params, (0, npad - n))[lo:lo + shard_n]
        new_shard = self._opt.update(param_shard, grad_shard, self._state)
        full = np.concatenate(
            [np.asarray(p) for p in group.allgather(new_shard)])
        return full[:n].astype(params.dtype, copy=False)
