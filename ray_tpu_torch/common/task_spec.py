"""Task specification — the unit shipped from submitter to executor.

Equivalent of the reference's ``TaskSpecification``
(src/ray/common/task/task_spec.h:258): function descriptor, serialized args
(inline values or ObjectID references), resource demand, scheduling strategy,
and retry policy.  Serialized with cloudpickle for function payloads and plain
pickle-able dataclasses for metadata.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID, TaskID, WorkerID
from .resources import ResourceRequest


class TaskType(enum.Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2
    DRIVER_TASK = 3


@dataclass
class FunctionDescriptor:
    """Language-agnostic function identity (module, qualname, payload hash)."""

    module: str
    qualname: str
    function_hash: bytes = b""

    def key(self) -> Tuple[str, str, bytes]:
        return (self.module, self.qualname, self.function_hash)


class SchedulingStrategy:
    """Base scheduling strategy (reference: scheduling_strategy proto)."""


@dataclass
class DefaultStrategy(SchedulingStrategy):
    pass


@dataclass
class SpreadStrategy(SchedulingStrategy):
    pass


@dataclass
class NodeAffinityStrategy(SchedulingStrategy):
    node_id: NodeID
    soft: bool = False


@dataclass
class NodeLabelStrategy(SchedulingStrategy):
    hard: Dict[str, object] = field(default_factory=dict)
    soft: Dict[str, object] = field(default_factory=dict)


@dataclass
class PlacementGroupStrategy(SchedulingStrategy):
    placement_group_id: PlacementGroupID
    bundle_index: int = -1
    capture_child_tasks: bool = False


@dataclass
class TaskArg:
    """Either an inline value (bytes) or a reference to an object."""

    is_inline: bool
    value: Optional[bytes] = None
    object_id: Optional[ObjectID] = None
    owner: Optional[WorkerID] = None
    owner_address: Optional[Tuple[str, int]] = None
    # Unique id of this by-ref handoff; the owner's transit guard is keyed on
    # it so acks are idempotent under retries/races (see worker.py borrow
    # protocol).
    handoff_token: Optional[bytes] = None

    @classmethod
    def inline(cls, value: bytes) -> "TaskArg":
        return cls(is_inline=True, value=value)

    @classmethod
    def by_ref(cls, object_id: ObjectID, owner: Optional[WorkerID] = None) -> "TaskArg":
        return cls(is_inline=False, object_id=object_id, owner=owner)


@dataclass
class _FastArgs:
    """Single-pickle argument bundle for the native actor-call fast path:
    the whole (args, kwargs) is ONE serialized value instead of one
    TaskArg frame per argument."""

    args: tuple
    kwargs: dict


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    function: FunctionDescriptor
    serialized_func: Optional[bytes]  # cloudpickled callable (None => registry lookup)
    args: List[TaskArg]
    num_returns: int
    required_resources: ResourceRequest
    scheduling_strategy: SchedulingStrategy = field(default_factory=DefaultStrategy)
    max_retries: int = 0
    retry_exceptions: bool = False
    parent_task_id: Optional[TaskID] = None
    caller_worker_id: Optional[WorkerID] = None
    caller_address: Optional[Tuple[str, int]] = None
    # actor fields
    actor_id: Optional[ActorID] = None
    actor_method_name: Optional[str] = None
    sequence_number: int = 0
    max_restarts: int = 0
    max_concurrency: int = 1
    # Streaming generator returns (reference: core_worker.proto:430
    # ReportGeneratorItemReturns): yielded items are reported to the owner
    # one by one under ObjectID.from_index(task_id, i+1); num_returns is 0.
    streaming: bool = False
    # runtime env / misc
    runtime_env: Optional[dict] = None
    name: str = ""
    # content hash of runtime_env, computed ONCE at submit time (hashing
    # walks working_dir trees — far too hot for shape_key, which runs on
    # the IO loop for every task)
    runtime_env_hash: Optional[str] = None
    # tracing context of the submitting span ({trace_id, span_id}), so
    # the executing worker's span parents across the process boundary
    # (reference: ray.util.tracing injects the OTel context into task
    # metadata). None when tracing is off — the common case.
    tracing: Optional[dict] = None

    def return_ids(self) -> List[ObjectID]:
        return [ObjectID.from_index(self.task_id, i + 1) for i in range(self.num_returns)]

    def is_actor_task(self) -> bool:
        return self.task_type == TaskType.ACTOR_TASK

    def is_actor_creation(self) -> bool:
        return self.task_type == TaskType.ACTOR_CREATION_TASK

    def dependencies(self) -> List[ObjectID]:
        return [a.object_id for a in self.args if not a.is_inline and a.object_id is not None]

    @classmethod
    def from_fast(cls, blob: bytes) -> "TaskSpec":
        """Rebuild a task from a native fastspec buffer (see
        rpc/native/fastspec.c): v1 = ACTOR_TASK, v2 = NORMAL_TASK (the
        lease-cached dispatch channel's record). Only fields the executee
        reads are populated; the rest hold cheap defaults."""
        if len(blob) > 4 and blob[4] == 2:
            return cls._from_fast_task(blob)
        from ray_tpu_torch.rpc.native import unpack_fastspec

        (task_raw, job_raw, actor_raw, wid_raw, host, method, payload,
         seq, num_returns, port) = unpack_fastspec(blob)
        method_s = method.decode()
        return cls(
            task_id=TaskID(task_raw),
            job_id=JobID(job_raw),
            task_type=TaskType.ACTOR_TASK,
            function=FunctionDescriptor("", method_s),
            serialized_func=None,
            args=[TaskArg.inline(payload)],
            num_returns=num_returns,
            required_resources=ResourceRequest({}),
            actor_id=ActorID(actor_raw),
            actor_method_name=method_s,
            sequence_number=seq,
            caller_worker_id=WorkerID(wid_raw),
            caller_address=(host.decode(), port),
            name=method_s,
        )

    @classmethod
    def _from_fast_task(cls, blob: bytes) -> "TaskSpec":
        """v2 record: a normal task pushed over the native dispatch
        channel. The args payload is ONE pickle of the per-arg inline
        frames (eligibility guarantees every arg was inline)."""
        import pickle as _pickle

        from ray_tpu_torch.rpc.native import unpack_fasttask

        (task_raw, job_raw, wid_raw, host, qualname, func, payload,
         name, num_returns, port) = unpack_fasttask(blob)
        qual_s = qualname.decode()
        return cls(
            task_id=TaskID(task_raw),
            job_id=JobID(job_raw),
            task_type=TaskType.NORMAL_TASK,
            function=FunctionDescriptor("", qual_s),
            serialized_func=func,
            args=[TaskArg.inline(v) for v in _pickle.loads(payload)],
            num_returns=num_returns,
            required_resources=ResourceRequest({}),
            caller_worker_id=WorkerID(wid_raw),
            caller_address=(host.decode(), port),
            # display name travels in the record: task events / errors
            # must report the submit-side name, not the qualname
            name=name.decode() or qual_s,
        )

    def shape_key(self) -> tuple:
        """Lease-pooling key: tasks with the same shape can share leases.
        Runtime env joins the key — a lease's worker is a process forked
        into ONE materialized environment."""
        if self.runtime_env is not None and self.runtime_env_hash is None:
            from ray_tpu_torch.runtime_env.runtime_env import env_hash

            self.runtime_env_hash = env_hash(self.runtime_env)
        return (self.required_resources.shape_key(),
                type(self.scheduling_strategy).__name__,
                self.runtime_env_hash)
