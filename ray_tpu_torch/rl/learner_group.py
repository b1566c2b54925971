"""Multi-learner LearnerGroup with synchronized gradients (port of
``ray_tpu/rl/learner_group.py``).

Reference: ``rllib/core/learner/learner_group.py:100`` — N learner actors
wrapped in torch DDP with an async update queue. Here, as in the JAX
package, the learners are plain actors holding torch learners; gradient
sync is a per-leaf mean allreduce through ``ray_tpu_torch.collective`` (the
KV backend between processes) between ``compute_gradients`` and
``apply_gradients`` — the same split the reference Learner API exposes
(``learner.py:464 compute_gradients``, ``:607 apply_gradients``). With
``ray_remote_args={"num_gpus": 1}`` each learner actor takes a GPU lease:
a fresh worker whose ``CUDA_VISIBLE_DEVICES`` is its grant, where a
learner built with ``device=None`` runs on that GPU.

Synchronization model: every ``update`` shards one batch across all N
learners and each applies the *mean* gradient, so parameters stay bitwise
in sync (same init, same averaged grads, same optimizer). ``async_update``
pipelines batches through the actors' ordered submission queues — rank
lockstep is preserved because every actor processes update k before k+1.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np


def _num_steps(batch) -> int:
    """Env steps in a train batch: B for flat batches, B·L for (B, L)
    sequence windows of a stateful module (rl/module.py contract).
    Sequence windows are identified by their marker columns, NOT by obs
    rank — a flat batch of image observations is also ndim >= 3."""
    if hasattr(batch, "get") and batch.get("obs") is not None and (
            "is_first" in batch
            or any(str(k).startswith("state_in_") for k in batch)):
        obs = np.asarray(batch["obs"])
        if obs.ndim >= 3:
            return int(obs.shape[0] * obs.shape[1])
    return len(next(iter(batch.values())))


class LearnerWorker:
    """One learner actor: local torch learner + collective gradient sync."""

    def __init__(self, factory_blob: bytes, rank: int, world_size: int,
                 group_name: str, backend: str = "kv"):
        import cloudpickle

        factory = cloudpickle.loads(factory_blob)
        self._learner = factory()
        self._rank = rank
        self._world = world_size
        self._group = group_name
        self._backend = backend
        self._group_ready = False

    def ping(self) -> bool:
        return True

    def _ensure_group(self):
        """Join the collective group lazily, on the FIRST update: the GCS
        serializes actor creations, so a rendezvous inside the constructor
        would deadlock rank 0 against rank 1's unstarted creation. First
        updates are submitted to all ranks concurrently, so all members
        arrive here together."""
        if self._group_ready or self._world == 1:
            return
        from ray_tpu_torch import collective

        collective.init_collective_group(
            self._world, self._rank, backend=self._backend,
            group_name=self._group)
        self._group_ready = True

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One synchronized SGD step on this rank's shard."""
        if self._world == 1:
            return self._learner.update(batch)
        from ray_tpu_torch import collective

        self._ensure_group()
        grads, aux = self._learner.compute_gradients(batch)
        # mean-allreduce each leaf (sorted keys, jax.tree's dict order): SUM
        # over ranks, then / world — learners stay identical because every
        # rank applies the same averaged grad
        reduced = {
            k: np.asarray(collective.allreduce(
                np.asarray(grads[k].detach().cpu().numpy(), np.float32),
                group_name=self._group)) / self._world
            for k in sorted(grads)
        }
        self._learner.apply_gradients(reduced)
        out = {k: float(v) for k, v in aux.items()}
        out["num_env_steps_trained"] = _num_steps(batch)
        return out

    def get_weights(self) -> Dict[str, np.ndarray]:
        return self._learner.get_weights()

    def set_weights(self, weights: Dict[str, np.ndarray]) -> None:
        self._learner.set_weights(weights)

    def num_updates(self) -> int:
        return getattr(self._learner, "updates", 0)


class LearnerGroup:
    """Fan-out controller over N learner actors (reference
    ``LearnerGroup``). ``update`` is synchronous; ``async_update`` pipelines
    through the actors' ordered queues and ``poll_updates`` drains finished
    results — the IMPALA-family consumption pattern."""

    def __init__(self, learner_factory: Callable[[], Any], *,
                 num_learners: int = 1, backend: str = "kv",
                 group_name: Optional[str] = None,
                 ray_remote_args: Optional[dict] = None,
                 max_inflight_updates: int = 4):
        import os

        import cloudpickle

        import ray_tpu_torch

        self._n = max(1, num_learners)
        self._group_name = group_name or f"learner_group_{os.getpid()}_{id(self)}"
        self._max_inflight = max_inflight_updates
        blob = cloudpickle.dumps(learner_factory)
        cls = ray_tpu_torch.remote(LearnerWorker)
        opts = dict(ray_remote_args or {})
        opts.setdefault("num_cpus", 0)
        self._workers = [
            cls.options(**opts).remote(blob, rank, self._n,
                                       self._group_name, backend)
            for rank in range(self._n)
        ]
        # Constructors run concurrently; the collective group rendezvous
        # inside them completes only when all ranks arrive.
        ray_tpu_torch.get([w.ping.remote() for w in self._workers], timeout=120)
        self._inflight: List[List[Any]] = []  # list of per-rank ref lists

    # -------------------------------------------------------------- helpers
    @staticmethod
    def _shard(batch: Dict[str, np.ndarray], n: int
               ) -> List[Dict[str, np.ndarray]]:
        """Slice along axis 0. For (B, L) sequence batches this is
        sequence-aware by construction: whole windows move together, so
        every rank's ``state_in_*`` rows stay aligned with their
        windows."""
        if n == 1:
            return [batch]
        size = len(next(iter(batch.values())))
        per = size // n
        if per == 0:
            return [batch] * n  # degenerate tiny batch: replicate
        shards = []
        for i in range(n):
            lo = i * per
            hi = size if i == n - 1 else (i + 1) * per
            shards.append({k: v[lo:hi] for k, v in batch.items()})
        return shards

    @staticmethod
    def _merge(metrics: List[Dict[str, float]]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if not metrics:
            return out
        for k in metrics[0]:
            vals = [m[k] for m in metrics if k in m]
            out[k] = (float(np.sum(vals)) if k.startswith("num_")
                      else float(np.mean(vals)))
        return out

    # --------------------------------------------------------------- update
    def update(self, batch: Dict[str, np.ndarray],
               timeout: float = 300.0) -> Dict[str, float]:
        import ray_tpu_torch

        shards = self._shard(batch, self._n)
        refs = [w.update.remote(s) for w, s in zip(self._workers, shards)]
        return self._merge(ray_tpu_torch.get(refs, timeout=timeout))

    def async_update(self, batch: Dict[str, np.ndarray]) -> bool:
        """Enqueue one synchronized update without waiting. Returns False
        (and drops the batch) when the pipeline is full — IMPALA-style
        backpressure on the learner queue."""
        if len(self._inflight) >= self._max_inflight:
            return False
        shards = self._shard(batch, self._n)
        self._inflight.append(
            [w.update.remote(s) for w, s in zip(self._workers, shards)])
        return True

    def poll_updates(self, timeout: float = 0.0) -> List[Dict[str, float]]:
        """Drain finished async updates (oldest first, order preserved)."""
        import ray_tpu_torch

        done: List[Dict[str, float]] = []
        while self._inflight:
            refs = self._inflight[0]
            ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                    timeout=timeout)
            if len(ready) < len(refs):
                break
            self._inflight.pop(0)
            done.append(self._merge(ray_tpu_torch.get(refs)))
        return done

    @property
    def num_inflight_updates(self) -> int:
        return len(self._inflight)

    # -------------------------------------------------------------- weights
    def get_weights(self, timeout: float = 60.0) -> Dict[str, np.ndarray]:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._workers[0].get_weights.remote(),
                           timeout=timeout)

    def set_weights(self, weights: Dict[str, np.ndarray]) -> None:
        import ray_tpu_torch

        ray_tpu_torch.get([w.set_weights.remote(weights) for w in self._workers],
                    timeout=60)

    def num_updates(self, timeout: float = 60.0) -> int:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._workers[0].num_updates.remote(),
                           timeout=timeout)

    @property
    def num_learners(self) -> int:
        return self._n

    def shutdown(self):
        import ray_tpu_torch

        for w in self._workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass
