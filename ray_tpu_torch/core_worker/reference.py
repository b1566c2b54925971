"""ObjectRef — a distributed future carrying its owner's identity.

As in the reference (ownership model, core_worker/reference_count.h:73), the
*owner* of an object is the worker that created it; the ref carries the
owner's RPC address so any holder can resolve value/location/lineage by asking
the owner directly — no central object directory.

Borrower protocol (reference core_worker/reference_count.h:73 borrower sets):

- Serializing a ref is a *handoff*, identified by a fresh random token
  embedded in the pickled payload. The serialize sink registers the token in
  the owner's in-flight set (locally if the serializer is the owner, via an
  ``incref_inflight`` RPC otherwise) BEFORE the bytes can reach anyone, so
  the object outlives the transit window.
- Deserializing a ref makes this process a *borrower*: the deserialize sink
  sends ``borrow_ack(token)`` — consuming that token (idempotently: the same
  blob deserialized N times acks the same token N times, which is one
  consume) and adding this worker to the owner's borrower set.
- When the last local Python ref in a borrower dies, the release sink sends
  ``borrow_release``; the owner frees the value + lineage only when its own
  local refs are gone AND the in-flight token set is empty AND the borrower
  set is empty. Tokens also carry a timestamp so a handoff whose receiver
  died in transit expires instead of pinning the object forever.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

from ray_tpu_torch.common.ids import ObjectID, WorkerID

# process-global sinks, installed by the CoreWorker at startup
_release_sink = None
_serialize_sink = None    # called with the ref when it is pickled
_deserialize_sink = None  # called with the ref when it is unpickled
_release_lock = threading.Lock()


def install_release_sink(fn):
    global _release_sink
    with _release_lock:
        _release_sink = fn


def install_borrow_sinks(on_serialize, on_deserialize):
    global _serialize_sink, _deserialize_sink
    with _release_lock:
        _serialize_sink = on_serialize
        _deserialize_sink = on_deserialize


class ObjectRef:
    __slots__ = ("object_id", "owner_id", "owner_address", "_borrowed", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_id: Optional[WorkerID] = None,
                 owner_address: Optional[Tuple[str, int]] = None, _borrowed: bool = False):
        self.object_id = object_id
        self.owner_id = owner_id
        self.owner_address = tuple(owner_address) if owner_address else None
        self._borrowed = _borrowed

    def binary(self) -> bytes:
        return self.object_id.binary()

    def hex(self) -> str:
        return self.object_id.hex()

    def __eq__(self, other) -> bool:
        return isinstance(other, ObjectRef) and other.object_id == self.object_id

    def __hash__(self) -> int:
        return hash(self.object_id)

    def __repr__(self) -> str:
        return f"ObjectRef({self.object_id.hex()[:16]}…)"

    def __reduce__(self):
        # Serialization is a handoff: guard the transit window at the owner
        # under a fresh token that travels inside the pickled payload.
        import os as _os

        token = _os.urandom(8)
        sink = _serialize_sink
        if sink is not None:
            try:
                sink(self, token)
            except Exception:  # noqa: BLE001 - never break pickling
                pass
        # Deserialized copies are *borrowed* references.
        return (_rebuild_borrowed_ref,
                (self.object_id, self.owner_id, self.owner_address, token))

    def __del__(self):
        sink = _release_sink
        if sink is not None:
            try:
                sink(self)
            except Exception:  # noqa: BLE001 - interpreter shutdown
                pass

    # convenience: obj_ref.get() / await-ability can come later
    def future(self):
        raise NotImplementedError("use ray_tpu_torch.get / ray_tpu_torch.wait")


def _rebuild_borrowed_ref(object_id, owner_id, owner_address, token=None):
    ref = ObjectRef(object_id, owner_id, owner_address, _borrowed=True)
    sink = _deserialize_sink
    if sink is not None:
        try:
            sink(ref, token)
        except Exception:  # noqa: BLE001 - never break unpickling
            pass
    return ref
