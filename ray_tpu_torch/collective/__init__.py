"""Collective communication library.

API surface mirrors the reference's ``ray.util.collective``
(``python/ray/util/collective/collective.py:150-692``): process-group-style
collectives among actors/tasks — allreduce, reduce, broadcast, allgather,
reducescatter, send/recv, barrier.

Backends:

- ``"kv"``  — GCS-KV-store-based transport among distributed actors for
  numpy arrays and tensors (the gloo replacement; rendezvous through the
  internal KV exactly as the reference's collective groups bootstrap via
  the GCS). A CUDA tensor is staged to the host and comes back on its
  own device.
- ``"xla"`` (or ``"nccl"``) — the in-program backend: one process owns
  the group's devices, ops take a stacked tensor whose leading axis is the
  member axis, and the collective is NCCL's across the devices
  (``torch.cuda.nccl``), or the same reduction as tensor ops on CPU
  slabs.

Both backends take the block-int8 quantized form of float SUM reductions
when ``RT_quantized_collectives`` is on (``quantization.py``).
"""

from ray_tpu_torch.collective.collective import (  # noqa: F401
    GroupManager,
    allgather,
    allreduce,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    get_collective_group_size,
    get_group_handle,
    get_rank,
    init_collective_group,
    is_group_initialized,
    recv,
    reduce,
    reducescatter,
    send,
)
from ray_tpu_torch.collective.types import Backend, ReduceOp  # noqa: F401

from ray_tpu_torch.util.usage import record_library_usage as _record_usage
_record_usage("collective")
del _record_usage
