"""Collective API (reference: python/ray/util/collective/collective.py).

Same call surface as the reference — ``init_collective_group`` inside each
member, or ``create_collective_group`` on the driver to declare a group over
actor handles (members then lazily join on their first collective call,
reference ``collective.py:187-253``). The KV backend runs between host
processes; the in-program backend (``"xla"``, or ``"nccl"``) runs NCCL
across the devices one process owns (``xla_group.py``).
"""

from __future__ import annotations

import pickle
import threading
from typing import Dict, List, Optional

from ray_tpu_torch.collective.types import Backend, ReduceOp
from ray_tpu_torch.collective.kv_group import KVGroup
from ray_tpu_torch.collective.xla_group import XlaGroup

_DECLARED_NS = "collective:_declared"


def _gcs():
    from ray_tpu_torch.core_worker.worker import CoreWorker

    return CoreWorker.current_or_raise().gcs


class GroupManager:
    """Per-process registry of joined collective groups
    (reference ``collective.py:60``)."""

    def __init__(self):
        self._groups: Dict[str, object] = {}
        self._lock = threading.Lock()

    def create(self, backend, world_size: int, rank: int, group_name: str,
               **kwargs):
        backend = Backend.parse(str(getattr(backend, "value", backend)))
        with self._lock:
            if group_name in self._groups:
                raise RuntimeError(f"group {group_name!r} already initialized")
            if backend is Backend.KV:
                group = KVGroup(_gcs(), world_size, rank, group_name,
                                **kwargs)
            else:
                group = XlaGroup(world_size, rank, group_name, **kwargs)
            self._groups[group_name] = group
            return group

    def get(self, group_name: str):
        with self._lock:
            group = self._groups.get(group_name)
        if group is not None:
            return group
        # Declared-on-driver group? Join lazily with our actor's rank.
        info = _gcs().kv_get(_DECLARED_NS, group_name)
        if info is None:
            raise RuntimeError(
                f"collective group {group_name!r} is not initialized in this "
                f"process; call init_collective_group() or declare it with "
                f"create_collective_group()")
        meta = pickle.loads(info)
        rank = self._my_declared_rank(meta)
        try:
            return self.create(meta["backend"], meta["world_size"], rank,
                               group_name)
        except RuntimeError:
            # Only swallow the lazy-join race (a concurrent thread created
            # the group); re-raise genuine construction failures.
            with self._lock:
                if group_name in self._groups:
                    return self._groups[group_name]
            raise

    @staticmethod
    def _my_declared_rank(meta) -> int:
        from ray_tpu_torch.core_worker.worker import CoreWorker

        me = CoreWorker.current_or_raise()
        actor_id = me._actor_id
        key = actor_id.hex() if actor_id is not None else None
        try:
            return meta["members"].index(key)
        except ValueError:
            raise RuntimeError(
                "this process is not a member of collective group "
                f"{meta['group_name']!r}")

    def exists(self, group_name: str) -> bool:
        with self._lock:
            return group_name in self._groups

    def destroy(self, group_name: str):
        with self._lock:
            group = self._groups.pop(group_name, None)
        if group is not None:
            group.destroy()


_group_mgr = GroupManager()


def is_group_initialized(group_name: str = "default") -> bool:
    return _group_mgr.exists(group_name)


def init_collective_group(world_size: int, rank: int,
                          backend="kv", group_name: str = "default",
                          **kwargs) -> None:
    """Join a collective group from inside a member (actor/task/driver)."""
    _group_mgr.create(backend, world_size, rank, group_name, **kwargs)


def create_collective_group(actors: List, world_size: int,
                            ranks: Optional[List[int]] = None,
                            backend="kv",
                            group_name: str = "default") -> None:
    """Declare a group over actor handles from the driver; members join
    lazily on their first collective call (reference ``collective.py:187``).
    """
    if len(actors) != world_size:
        raise ValueError(
            f"{len(actors)} actors != world_size {world_size}")
    ranks = ranks or list(range(world_size))
    if sorted(ranks) != list(range(world_size)):
        raise ValueError(f"ranks must be a permutation of 0..{world_size-1}")
    members = [None] * world_size
    for actor, rank in zip(actors, ranks):
        members[rank] = actor._actor_id.hex()
    meta = {"group_name": group_name, "backend": str(Backend.parse(
        str(getattr(backend, "value", backend))).value),
        "world_size": world_size, "members": members}
    _gcs().kv_put(_DECLARED_NS, group_name, pickle.dumps(meta),
                  overwrite=True)


def destroy_collective_group(group_name: str = "default") -> None:
    if _group_mgr.exists(group_name):
        _group_mgr.destroy(group_name)
    try:
        _gcs().kv_del(_DECLARED_NS, group_name)
    except Exception:  # noqa: BLE001 — driver may already be disconnected
        pass


def get_rank(group_name: str = "default") -> int:
    return _group_mgr.get(group_name).rank if _group_mgr.exists(group_name) \
        else -1


def get_collective_group_size(group_name: str = "default") -> int:
    return (_group_mgr.get(group_name).world_size
            if _group_mgr.exists(group_name) else -1)


def get_group_handle(group_name: str = "default"):
    return _group_mgr.get(group_name)


# ------------------------------------------------------------------- ops
def allreduce(tensor, group_name: str = "default", op=ReduceOp.SUM):
    return _group_mgr.get(group_name).allreduce(tensor, op)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op=ReduceOp.SUM):
    return _group_mgr.get(group_name).reduce(tensor, dst_rank, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _group_mgr.get(group_name).broadcast(tensor, src_rank)


def allgather(tensor, group_name: str = "default"):
    return _group_mgr.get(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = "default", op=ReduceOp.SUM):
    return _group_mgr.get(group_name).reducescatter(tensor, op)


def send(tensor, dst_rank: int, group_name: str = "default"):
    return _group_mgr.get(group_name).send(tensor, dst_rank)


def recv(tensor_or_src, src_rank: Optional[int] = None,
         group_name: str = "default"):
    """recv(src_rank) → array. (The reference mutates a passed-in buffer;
    functional arrays make that shape awkward — accept both call forms.)"""
    src = src_rank if src_rank is not None else tensor_or_src
    return _group_mgr.get(group_name).recv(src)


def barrier(group_name: str = "default"):
    return _group_mgr.get(group_name).barrier()
