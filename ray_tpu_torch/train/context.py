"""Worker-side training context + report API (port of
``ray_tpu/train/context.py``).

Reference: ``python/ray/train/v2/api/context.py`` (TrainContext) and
``ray.train.report`` — metrics/checkpoint flow from workers to the
controller. The context carries the process-group bootstrap (rank 0's
coordinator address, rank, world size), so ``train_fn`` joins
``torch.distributed`` with one call.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_context_lock = threading.Lock()
_context: Optional["TrainContext"] = None


def holds_gpu() -> bool:
    """True when this worker holds a GPU lease (the raylet exports it as
    ``CUDA_VISIBLE_DEVICES``; a worker without one sees none)."""
    return os.environ.get("CUDA_VISIBLE_DEVICES", "") not in ("", "-1")


@dataclasses.dataclass
class TrainContext:
    experiment_name: str
    world_rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    node_rank: int
    storage_path: str
    # process-group bootstrap: rank 0's TCP store address
    coordinator: Optional[str] = None
    resume_from: Optional[Checkpoint] = None
    # unique per gang INSTANCE (fresh on every restart/resize): keys
    # collective rendezvous namespaces so attempts never see stale state
    run_id: str = ""

    # populated by the worker harness
    _reports: List[dict] = dataclasses.field(default_factory=list)
    _report_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)
    _stop_event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)
    # name -> this rank's DataIterator (JaxTrainer(datasets=...))
    _datasets: dict = dataclasses.field(default_factory=dict, repr=False)

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_run_id(self) -> str:
        return self.run_id

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_storage_path(self) -> str:
        return self.storage_path

    def get_dataset_shard(self, name: str = "train"):
        """This worker's streaming shard of the trainer dataset ``name``
        (reference: ``ray.train.get_dataset_shard``): a
        :class:`~ray_tpu_torch.data.DataIterator` fed by ``streaming_split``;
        ``iter_torch_batches()`` lands its batches on this worker's GPU."""
        if name not in self._datasets:
            raise KeyError(
                f"no dataset shard {name!r}; trainer datasets: "
                f"{sorted(self._datasets)}")
        return self._datasets[name]

    def get_checkpoint(self) -> Optional[Checkpoint]:
        """Checkpoint to resume from (set on restore / failure restart)."""
        return self.resume_from

    def should_stop(self) -> bool:
        """Cooperative-cancellation flag (elastic resize / shutdown)."""
        return self._stop_event.is_set()

    def init_jax_distributed(self) -> None:
        """Join the gang's ``torch.distributed`` process group (the name
        of the JAX package's call, which joins its global mesh): NCCL when
        this worker holds a GPU lease, gloo otherwise, against rank 0's
        coordinator. No-op when single-process (tests, one-worker runs);
        ``parallel.make_mesh`` then makes a group of this process alone."""
        if self.world_size == 1 or self.coordinator is None:
            return
        import torch.distributed as dist

        if dist.is_initialized():
            return
        if holds_gpu():
            import torch

            torch.cuda.set_device(self.local_rank)
        dist.init_process_group(
            "nccl" if holds_gpu() else "gloo",
            init_method=f"tcp://{self.coordinator}",
            rank=self.world_rank, world_size=self.world_size)

    # -------------------------------------------------- report plumbing
    def _push_report(self, metrics: Dict[str, Any],
                     checkpoint: Optional[Checkpoint]):
        with self._report_lock:
            self._reports.append({
                "metrics": dict(metrics),
                "checkpoint_path": checkpoint.path if checkpoint else None,
            })

    def _drain_reports(self) -> List[dict]:
        with self._report_lock:
            out, self._reports = self._reports, []
            return out


def get_dataset_shard(name: str = "train"):
    """This worker's dataset shard (reference:
    ``ray.train.get_dataset_shard``)."""
    return get_context().get_dataset_shard(name)


def get_context() -> TrainContext:
    with _context_lock:
        if _context is None:
            raise RuntimeError(
                "ray_tpu_torch.train.get_context() called outside a "
                "training worker")
        return _context


def _set_context(ctx: Optional[TrainContext]):
    global _context
    with _context_lock:
        _context = ctx


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (+ checkpoint) from inside ``train_fn``.

    Like the reference, the checkpoint must already be persisted (written
    to a directory under the storage path — e.g. via
    ``Checkpoint.from_pytree``); report only registers it.
    """
    get_context()._push_report(metrics, checkpoint)


def checkpoint_dir(step: int) -> str:
    """Canonical per-step checkpoint directory for this run (rank-shared)."""
    ctx = get_context()
    return os.path.join(ctx.storage_path, f"checkpoint_{step:08d}")
