"""JaxTrainer: controller loop + configs (port of
``ray_tpu/train/trainer.py``; the class keeps the JAX package's name).

Reference: ``python/ray/train/v2/api/data_parallel_trainer.py:108`` (fit)
driving ``TrainController`` (``…/controller/controller.py:93`` — poll
workers, consult failure policy, restart group). Same control shape here,
in the caller's process: the controller loop polls the worker group,
registers reported checkpoints, and restarts the gang (from the latest
checkpoint) on worker failure until ``FailureConfig.max_failures`` is
exhausted.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    CheckpointConfig,
    CheckpointManager,
)
from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ScalingConfig:
    """Reference: ``ray.train.ScalingConfig`` (air/config.py). ``use_gpu``
    gives each worker a bundle of one GPU (the JAX package's ``use_tpu``
    gives one TPU chip). Setting ``min_workers``/``max_workers`` turns on
    elastic scaling (reference: train/v2 scaling_policy/): the gang starts
    at the largest feasible size, shrinks on failure instead of wedging,
    and restarts bigger from the latest checkpoint when capacity appears."""

    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    min_workers: Optional[int] = None
    max_workers: Optional[int] = None

    def bundle(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        if not res:
            res = {"GPU": 1.0} if self.use_gpu else {"CPU": 1.0}
        return res


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    path: str
    error: Optional[str] = None


class TrainingFailedError(RuntimeError):
    pass


class JaxTrainer:
    """Data-parallel/SPMD trainer over a gang of workers, one GPU each
    with ``use_gpu`` (the JAX package's name for its trainer)."""

    def __init__(self, train_loop_per_worker: Optional[Callable] = None,
                 *, train_loop_config: Optional[dict] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 poll_interval_s: float = 0.2,
                 scaling_policy=None,
                 datasets: Optional[dict] = None,
                 pipeline_spec=None):
        if (train_loop_per_worker is None) == (pipeline_spec is None):
            raise ValueError(
                "JaxTrainer needs exactly one of train_loop_per_worker "
                "(SPMD gang mode) or pipeline_spec (MPMD pipeline mode)")
        self.train_fn = train_loop_per_worker
        self.pipeline_spec = pipeline_spec
        self.config = train_loop_config
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from = resume_from_checkpoint
        self.poll_interval_s = poll_interval_s
        self._policy_override = scaling_policy
        # name -> Dataset: split per gang size at start, one DataIterator
        # per rank (reference: Train dataset ingest via streaming_split)
        self.datasets = dict(datasets or {})
        self._split_coords: list = []

    def _reap_coords(self):
        """Kill split coordinators so their streaming executions stop
        (and their buffered block refs unpin)."""
        import ray_tpu_torch

        for coord in self._split_coords:
            try:
                ray_tpu_torch.kill(coord)
            except Exception:  # noqa: BLE001
                pass
        self._split_coords = []

    def _make_shards(self, size: int):
        """Split each named dataset into per-rank streaming iterators for
        THIS gang instance; a resize re-splits at the new size. Old split
        coordinators are reaped so their executions stop."""
        if not self.datasets:
            return None
        self._reap_coords()
        shards = {}
        for dname, ds in self.datasets.items():
            its = ds.streaming_split(size)
            if its:
                self._split_coords.append(its[0]._coord)
            shards[dname] = its
        return shards

    # ------------------------------------------------------------------ fit
    def fit(self, timeout_s: float = 3600.0) -> Result:
        name = self.run_config.name or f"train_{int(time.time())}"
        storage = os.path.join(
            self.run_config.storage_path
            or os.path.expanduser("~/ray_tpu_torch_results"), name)
        os.makedirs(storage, exist_ok=True)
        if self.pipeline_spec is not None:
            return self._fit_pipeline(storage, timeout_s)
        manager = CheckpointManager(storage,
                                    self.run_config.checkpoint_config)
        if self.resume_from is None:
            found = _latest_checkpoint_in(storage)
            if found is not None:
                logger.info("auto-resuming from %s", found.path)
                self.resume_from = found

        from ray_tpu_torch.train.scaling_policy import (
            ElasticScalingPolicy, FixedScalingPolicy)

        sc = self.scaling
        if self._policy_override is not None:
            policy = self._policy_override
        elif sc.min_workers is not None or sc.max_workers is not None:
            lo = sc.min_workers or 1
            policy = ElasticScalingPolicy(
                lo, max(lo, sc.max_workers or sc.num_workers))
        else:
            policy = FixedScalingPolicy(sc.num_workers)
        self._policy = policy
        try:
            return self._fit_loop(sc, policy, manager, name, storage,
                                  time.monotonic() + timeout_s)
        finally:
            # every exit (success, timeout, max-failures, scheduling
            # failure) reaps split coordinators — a raising exit must not
            # leave their streaming executions running
            self._reap_coords()

    def _fit_pipeline(self, storage: str, timeout_s: float) -> Result:
        """MPMD pipeline mode: stage actors on channel hops instead of an
        SPMD gang (train/pipeline.py). ``pipeline_spec.data_fn(step)``
        supplies each step's ``(xs, ys)`` microbatch lists; the final
        per-stage params land in ``Result.metrics['stage_params']``."""
        from ray_tpu_torch.graph.compiled import PipelineStageError
        from ray_tpu_torch.train.pipeline import PipelineRunner

        spec = self.pipeline_spec
        if spec.data_fn is None:
            raise ValueError(
                "pipeline mode needs pipeline_spec.data_fn(step) -> (xs, ys)")
        deadline = time.monotonic() + timeout_s
        runner = PipelineRunner(spec)
        metrics: Dict[str, Any] = {}
        try:
            for step in range(spec.num_steps):
                if time.monotonic() > deadline:
                    raise TimeoutError("JaxTrainer.fit timeout exceeded")
                xs, ys = spec.data_fn(step)
                metrics = runner.step(xs, ys)
            metrics["stage_params"] = runner.finish()
        except PipelineStageError as e:
            raise TrainingFailedError(
                f"pipeline training failed: {e}") from e
        finally:
            runner.shutdown()
        return Result(metrics=metrics, checkpoint=None, path=storage)

    def _fit_loop(self, sc, policy, manager, name, storage, deadline):
        from ray_tpu_torch.train.scaling_policy import ResizeDecision

        failures = 0
        last_metrics: Dict[str, Any] = {}
        next_size: Optional[int] = None
        started_once = False
        while True:
            bundle = sc.bundle()
            if next_size is not None:
                size = next_size
            elif not started_once:
                size = policy.initial_size(bundle, self._available())
            else:
                size = policy.size_after_failure(bundle, self._available())
            next_size = None
            started_once = True
            group = WorkerGroup(size, bundle, sc.placement_strategy)
            resume = manager.latest or self.resume_from
            error = None
            try:
                # start() inside the try: a scheduling failure must still
                # release the placement group + any created actors.
                group.start(experiment_name=name, storage_path=storage,
                            dataset_shards=self._make_shards(size),
                            train_fn=self.train_fn, config=self.config,
                            resume_from_path=resume.path if resume else None)
                error, last_metrics = self._poll_until_done(
                    group, manager, last_metrics, deadline)
            except (TimeoutError, TrainingFailedError):
                raise
            except Exception as e:  # noqa: BLE001 — scheduling failure.
                # Elastic policies retry at whatever size is feasible NOW;
                # for a fixed size the failure is permanent config/capacity
                # mismatch — propagate it immediately with its real type.
                if not getattr(policy, "WATCHES_CAPACITY", False):
                    raise
                error = f"worker group start failed: {type(e).__name__}: {e}"
            finally:
                group.shutdown()
            if error is None:
                return Result(metrics=last_metrics,
                              checkpoint=manager.latest, path=storage)
            if isinstance(error, ResizeDecision):
                # elastic upscale: restart from the latest checkpoint at
                # the new size — not a failure
                logger.info("elastic resize %d -> %d (%s)", size,
                            error.num_workers, error.reason)
                next_size = error.num_workers
                continue
            failures += 1
            max_failures = self.run_config.failure_config.max_failures
            if failures > max_failures:
                raise TrainingFailedError(
                    f"training failed {failures} time(s), "
                    f"max_failures={max_failures} exhausted:\n{error}")
            logger.warning("worker failure (%d/%d), restarting group:\n%s",
                           failures,
                           self.run_config.failure_config.max_failures,
                           error)

    @staticmethod
    def _available() -> Dict[str, float]:
        import ray_tpu_torch

        try:
            return ray_tpu_torch.available_resources()
        except Exception:  # noqa: BLE001 — no cluster yet / local mode
            return {}

    def _poll_until_done(self, group: WorkerGroup,
                         manager: CheckpointManager,
                         last_metrics: Dict[str, Any],
                         deadline: float):
        # Only elastic policies watch cluster capacity; don't pay an
        # available_resources() RPC per poll tick on the fixed path.
        watches = getattr(self._policy, "WATCHES_CAPACITY", False)
        bundle = self.scaling.bundle()
        while True:
            if time.monotonic() > deadline:
                raise TimeoutError("JaxTrainer.fit timeout exceeded")
            try:
                statuses = group.poll()
            except Exception as e:  # noqa: BLE001 — actor death IS a failure
                return (f"worker group poll failed (worker process died?): "
                        f"{type(e).__name__}: {e}"), last_metrics
            for rank, st in enumerate(statuses):
                for rep in st["reports"]:
                    if rep["metrics"]:
                        last_metrics = rep["metrics"]
                    # rank 0's checkpoint registration wins; other ranks
                    # contribute shards to the same directory.
                    if rep["checkpoint_path"] and rank == 0:
                        manager.register(Checkpoint(rep["checkpoint_path"]),
                                         rep["metrics"])
            errs = [st["error"] for st in statuses if st["status"] == "error"]
            if errs:
                return errs[0], last_metrics
            if all(st["status"] == "finished" for st in statuses):
                return None, last_metrics
            # Resize only AFTER this interval's reports/checkpoints are
            # harvested and completion is ruled out — a restart must
            # resume from the newest checkpoint, not preempt a finish.
            if watches:
                decision = self._policy.decide(group.num_workers, bundle,
                                               self._available())
                if decision is not None:
                    return decision, last_metrics
            time.sleep(self.poll_interval_s)


def _latest_checkpoint_in(storage: str) -> Optional[Checkpoint]:
    try:
        entries = sorted(
            e for e in os.listdir(storage)
            if e.startswith("checkpoint_")
            and os.path.isdir(os.path.join(storage, e)))
    except FileNotFoundError:
        return None
    # Only count checkpoints that completed registration.
    for e in reversed(entries):
        path = os.path.join(storage, e)
        if os.path.exists(os.path.join(path, "_metrics.json")):
            return Checkpoint(path)
    return None
