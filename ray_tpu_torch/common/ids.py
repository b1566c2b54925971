"""Deterministic nested binary IDs.

Design follows the reference's ID nesting scheme (src/ray/common/id.h:130-264):
``JobID ⊂ ActorID ⊂ TaskID ⊂ ObjectID`` — each wider ID embeds the narrower one
so ownership and provenance can be recovered from the bytes alone.  Object IDs
are *computed*, not random: they derive from the owning task plus a return /
put index, which is what makes lineage reconstruction possible (re-executing
the creating task regenerates the same ObjectID).

Sizes (bytes):
    JobID    4
    ActorID  4 (job) + 12 (unique)            = 16
    TaskID   16 (actor id) + 8 (unique)       = 24
    ObjectID 24 (task id) + 4 (index)         = 28

A "nil" ID is all 0xff, as in the reference.
"""

from __future__ import annotations

import hashlib
import os
import threading

_JOB_ID_SIZE = 4
_ACTOR_UNIQUE_SIZE = 12
_ACTOR_ID_SIZE = _JOB_ID_SIZE + _ACTOR_UNIQUE_SIZE
_TASK_UNIQUE_SIZE = 8
_TASK_ID_SIZE = _ACTOR_ID_SIZE + _TASK_UNIQUE_SIZE
_OBJECT_INDEX_SIZE = 4
_OBJECT_ID_SIZE = _TASK_ID_SIZE + _OBJECT_INDEX_SIZE

# Object index space is split: indices >= PUT_INDEX_BASE are ray.put()s,
# below are task returns (reference: ObjectID::FromIndex semantics).
PUT_INDEX_BASE = 1 << 31


class BaseID:
    """Immutable fixed-width binary ID."""

    SIZE = 0
    __slots__ = ("_bytes", "_hash")

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}"
            )
        self._bytes = bytes(binary)
        self._hash = None

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes

    def __hash__(self) -> int:
        # IDs key every hot-path dict (refcounts, pending calls, dedup);
        # an actor call hashes IDs ~18 times end-to-end, so cache it.
        h = self._hash
        if h is None:
            h = self._hash = hash((type(self).__name__, self._bytes))
        return h

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._bytes.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = _JOB_ID_SIZE

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(_JOB_ID_SIZE, "little"))

    def to_int(self) -> int:
        return int.from_bytes(self._bytes, "little")


class UniqueID(BaseID):
    """Free-standing 16-byte ID (nodes, workers, placement groups, clients)."""

    SIZE = 16


class NodeID(UniqueID):
    pass


class WorkerID(UniqueID):
    pass


class PlacementGroupID(UniqueID):
    pass


class ActorID(BaseID):
    SIZE = _ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID, parent_task_id: "TaskID", actor_creation_index: int) -> "ActorID":
        h = hashlib.sha256()
        h.update(parent_task_id.binary())
        h.update(actor_creation_index.to_bytes(4, "little"))
        return cls(job_id.binary() + h.digest()[:_ACTOR_UNIQUE_SIZE])

    @classmethod
    def nil_from_job(cls, job_id: JobID) -> "ActorID":
        """The 'no actor' actor id still carrying the job: used for normal tasks."""
        return cls(job_id.binary() + b"\xff" * _ACTOR_UNIQUE_SIZE)

    def job_id(self) -> JobID:
        return JobID(self._bytes[:_JOB_ID_SIZE])


class TaskID(BaseID):
    SIZE = _TASK_ID_SIZE

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        return cls(ActorID.nil_from_job(job_id).binary() + b"\x00" * _TASK_UNIQUE_SIZE)

    @classmethod
    def for_worker_thread(cls, job_id: JobID, worker_id: "WorkerID") -> "TaskID":
        """The parent of what a worker's threads submit outside any task: its
        own in each worker (``for_driver``'s is the same in every process of
        the job, so two workers minted the same ActorIDs from such threads)."""
        h = hashlib.sha256(b"worker-thread")
        h.update(worker_id.binary())
        return cls(
            ActorID.nil_from_job(job_id).binary() + h.digest()[:_TASK_UNIQUE_SIZE]
        )

    @classmethod
    def for_normal_task(cls, job_id: JobID, parent_task_id: "TaskID", task_index: int) -> "TaskID":
        h = hashlib.sha256()
        h.update(parent_task_id.binary())
        h.update(task_index.to_bytes(8, "little"))
        return cls(
            ActorID.nil_from_job(job_id).binary() + h.digest()[:_TASK_UNIQUE_SIZE]
        )

    @classmethod
    def for_actor_creation_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(actor_id.binary() + b"\x00" * _TASK_UNIQUE_SIZE)

    @classmethod
    def for_actor_task(
        cls, actor_id: ActorID, parent_task_id: "TaskID", task_index: int
    ) -> "TaskID":
        h = hashlib.sha256()
        h.update(parent_task_id.binary())
        h.update(task_index.to_bytes(8, "little"))
        return cls(actor_id.binary() + h.digest()[:_TASK_UNIQUE_SIZE])

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[:_ACTOR_ID_SIZE])

    def job_id(self) -> JobID:
        return JobID(self._bytes[:_JOB_ID_SIZE])


class ObjectID(BaseID):
    SIZE = _OBJECT_ID_SIZE

    @classmethod
    def from_index(cls, task_id: TaskID, index: int) -> "ObjectID":
        """Return-value object: index is 1-based return position."""
        return cls(task_id.binary() + index.to_bytes(_OBJECT_INDEX_SIZE, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        return cls.from_index(task_id, PUT_INDEX_BASE + put_index)

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:_TASK_ID_SIZE])

    def job_id(self) -> JobID:
        return JobID(self._bytes[:_JOB_ID_SIZE])

    def index(self) -> int:
        return int.from_bytes(self._bytes[_TASK_ID_SIZE:], "little")

    def is_put(self) -> bool:
        return self.index() >= PUT_INDEX_BASE


class _Counter:
    """Thread-safe monotonically increasing counter."""

    def __init__(self, start: int = 0):
        self._value = start
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value
