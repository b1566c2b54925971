"""Worker group: gang-scheduled training-worker actors (port of
``ray_tpu/train/worker_group.py``).

Reference: ``python/ray/train/v2/_internal/execution/worker_group/
worker_group.py:99`` (actor fleet in a placement group, rank assignment,
context injection) and ``worker.py:116`` (RayTrainWorker: run train_fn in a
thread, poll status). GPU specifics: a bundle's ``GPU`` is leased as
``num_gpus`` is — a fresh worker that sees its grant as
``CUDA_VISIBLE_DEVICES`` — and rank 0 picks the port of the process
group's TCP store.
"""

from __future__ import annotations

import socket
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional


def _host() -> str:
    """The host this worker's own RPC server listens on, as the other
    processes of the session reach it; 127.0.0.1 when unknown. (No probe
    of an outside address.)"""
    try:
        from ray_tpu_torch.core_worker.worker import CoreWorker

        host = CoreWorker.current_or_raise().server.address.rsplit(":", 1)[0]
        return host if host not in ("", "0.0.0.0") else "127.0.0.1"
    except Exception:  # noqa: BLE001 — outside a worker
        return "127.0.0.1"


class TrainWorker:
    """Actor harness around the user's ``train_fn`` (one per rank)."""

    def __init__(self):
        self._ctx = None
        self._thread: Optional[threading.Thread] = None
        self._status = "idle"
        self._error: Optional[str] = None

    def get_coordinator_address(self) -> str:
        """Rank 0: a free port for the process group's TCP store."""
        host = _host()
        with socket.socket() as s:
            s.bind((host, 0))
            port = s.getsockname()[1]
        return f"{host}:{port}"

    def setup(self, ctx_kwargs: Dict[str, Any]) -> bool:
        from ray_tpu_torch.train.checkpoint import Checkpoint
        from ray_tpu_torch.train.context import TrainContext, _set_context

        resume = ctx_kwargs.pop("resume_from_path", None)
        datasets = ctx_kwargs.pop("datasets", None)
        ctx = TrainContext(**ctx_kwargs)
        if datasets:
            ctx._datasets = dict(datasets)
        if resume:
            ctx.resume_from = Checkpoint(resume)
        self._ctx = ctx
        _set_context(ctx)
        return True

    def run(self, train_fn: Callable, config: Optional[dict]) -> bool:
        if self._thread is not None:
            raise RuntimeError("worker already running")
        self._status = "running"

        def target():
            try:
                if _fn_wants_config(train_fn):
                    train_fn(config or {})
                else:
                    train_fn()
                self._status = "finished"
            except BaseException:  # noqa: BLE001 — report, don't die
                self._error = traceback.format_exc()
                self._status = "error"

        self._thread = threading.Thread(target=target, daemon=True,
                                        name="train_fn")
        self._thread.start()
        return True

    def poll(self) -> Dict[str, Any]:
        # Status BEFORE draining: a 'finished' status then guarantees every
        # report (train_fn pushes before the thread flips the status) was
        # included in this drain — no lost final checkpoint.
        status, error = self._status, self._error
        reports = self._ctx._drain_reports() if self._ctx else []
        return {"status": status, "error": error, "reports": reports}

    def stop(self) -> bool:
        if self._ctx is not None:
            self._ctx._stop_event.set()
        return True

    def shutdown_worker(self) -> bool:
        return True


def _fn_wants_config(fn) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return True
    return len(sig.parameters) >= 1


def _actor_options(bundle: Dict[str, float]) -> Dict[str, Any]:
    """Actor options that ask for ``bundle``: its GPUs through
    ``num_gpus``, the lease path of a GPU actor, the rest as resources."""
    rest = {k: v for k, v in bundle.items() if k != "GPU"}
    opts: Dict[str, Any] = {"resources": rest}
    if bundle.get("GPU"):
        opts["num_gpus"] = bundle["GPU"]
    return opts


class WorkerGroup:
    """Controller-side handle on the actor fleet + its placement group."""

    def __init__(self, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 placement_strategy: str = "PACK"):
        self.num_workers = num_workers
        self.resources_per_worker = dict(resources_per_worker)
        self.placement_strategy = placement_strategy
        self.workers: List[Any] = []
        self.pg = None

    def start(self, *, experiment_name: str, storage_path: str,
              train_fn: Callable, config: Optional[dict],
              resume_from_path: Optional[str] = None,
              dataset_shards: Optional[Dict[str, list]] = None,
              pg_timeout: float = 60.0) -> None:
        import ray_tpu_torch

        bundles = [dict(self.resources_per_worker)
                   for _ in range(self.num_workers)]
        self.pg = ray_tpu_torch.placement_group(
            bundles, strategy=self.placement_strategy)
        if not self.pg.ready(timeout=pg_timeout):
            raise TimeoutError(
                f"placement group for {self.num_workers} workers "
                f"({self.resources_per_worker} each) not schedulable in "
                f"{pg_timeout}s")

        from ray_tpu_torch.core_worker.placement_group import (
            PlacementGroupSchedulingStrategy,
        )

        remote_cls = ray_tpu_torch.remote(TrainWorker)
        self.workers = [
            remote_cls.options(
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=self.pg,
                    placement_group_bundle_index=i),
                **_actor_options(self.resources_per_worker),
            ).remote()
            for i in range(self.num_workers)
        ]

        coordinator = None
        if self.num_workers > 1:
            coordinator = ray_tpu_torch.get(
                self.workers[0].get_coordinator_address.remote())

        import uuid

        run_id = uuid.uuid4().hex[:12]  # fresh per gang instance
        setups = []
        for rank, w in enumerate(self.workers):
            setups.append(w.setup.remote({
                "run_id": run_id,
                "experiment_name": experiment_name,
                "world_rank": rank,
                "world_size": self.num_workers,
                "local_rank": 0,
                "local_world_size": 1,
                "node_rank": rank,
                "storage_path": storage_path,
                "coordinator": coordinator,
                "resume_from_path": resume_from_path,
                "datasets": ({name: shards[rank] for name, shards
                              in dataset_shards.items()}
                             if dataset_shards else None),
            }))
        ray_tpu_torch.get(setups)
        ray_tpu_torch.get([w.run.remote(train_fn, config)
                           for w in self.workers])

    def poll(self, timeout: float = 30.0) -> List[Dict[str, Any]]:
        import ray_tpu_torch

        return ray_tpu_torch.get([w.poll.remote() for w in self.workers],
                                 timeout=timeout)

    def shutdown(self, grace_s: float = 5.0):
        import ray_tpu_torch

        # Deliver the cooperative stop (should_stop()) before killing, so
        # workers can flush final state; best-effort with a bounded wait.
        try:
            ray_tpu_torch.get([w.stop.remote() for w in self.workers],
                              timeout=grace_s)
        except Exception:  # noqa: BLE001 — dead workers can't ack
            pass
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001 — already dead is fine
                pass
        if self.pg is not None:
            try:
                ray_tpu_torch.remove_placement_group(self.pg)
            except Exception:  # noqa: BLE001
                pass
        self.workers, self.pg = [], None
