"""KV-store collective group — the backend between host processes.

Plays the role of the reference's gloo backend (reference
``python/ray/util/collective/collective_group/gloo_collective_group.py``),
but transports tensor bytes through the GCS internal KV + long-polls, the
same store the reference uses only for rendezvous. No extra daemon, works
for any actor set, survives raylet topology changes.

Operands are numpy arrays or ``torch.Tensor``s. A tensor travels as a CPU
tensor (a CUDA tensor is staged to the host first), is reduced with torch
in its own dtype (bfloat16 included, which numpy lacks), and each result
comes back as a tensor on the device of the tensor this member passed in.
A numpy operand gives numpy results, as in the JAX package.

Semantics: standard process-group rules — every member calls the same
collective ops in the same order (per-group monotone sequence numbers keep
ops matched; mismatched call orders surface as timeouts, not corruption).

Data-plane keys are garbage-collected every ``GC_EVERY`` ops behind a
barrier, so long-running groups don't grow the KV unboundedly.

Quantized wire mode (``RT_quantized_collectives=1``, or ``quantized=True``
per group): float payloads of allreduce/reduce/reducescatter travel as
block-wise int8 codes + per-block scale/offset (collective/quantization.py)
— ~3.9x fewer bytes through the KV for f32 — and every member dequantizes
before reducing. broadcast/allgather/p2p stay exact (their value IS the
payload; re-encoding them would silently lossy-copy).
``wire_put_bytes`` / ``wire_get_bytes`` count the actual serialized blob
sizes either way, so benches report measured bytes on the wire, not a
formula.
"""

from __future__ import annotations

import pickle
import sys
import time
from typing import List, Optional

import numpy as np

from ray_tpu_torch.collective import quantization as q
from ray_tpu_torch.collective.types import (NUMPY_REDUCERS, TORCH_REDUCERS,
                                            ReduceOp)

GC_EVERY = 16


def _is_tensor(value) -> bool:
    torch = sys.modules.get("torch")  # a tensor exists only once it loaded
    return torch is not None and isinstance(value, torch.Tensor)


def _wire(value):
    """What a member publishes: a CPU tensor, or a numpy array."""
    if _is_tensor(value):
        return value.detach().cpu()
    return np.asarray(value)


def _is_float(value) -> bool:
    if _is_tensor(value):
        return value.is_floating_point()
    return np.issubdtype(np.asarray(value).dtype, np.floating)


def _on_device_of(result, like):
    """``result`` on the device of ``like``, this member's operand (a
    numpy result for a numpy operand)."""
    if _is_tensor(like):
        return result.to(like.device)
    return result


def _reduce(out, part, op: ReduceOp):
    if out is None:
        return part
    if _is_tensor(part):
        return getattr(sys.modules["torch"], TORCH_REDUCERS[op])(out, part)
    return getattr(np, NUMPY_REDUCERS[op])(out, part)


class KVGroup:
    backend_name = "kv"

    def __init__(self, kv, world_size: int, rank: int, group_name: str,
                 timeout_s: float = 60.0, quantized: Optional[bool] = None,
                 quantized_block: Optional[int] = None):
        if not (0 <= rank < world_size):
            raise ValueError(f"rank {rank} out of range [0, {world_size})")
        from ray_tpu_torch.common.config import GLOBAL_CONFIG

        self._kv = kv                       # GcsClient (kv_put/kv_get/…)
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self.timeout_s = timeout_s
        self.quantized = (GLOBAL_CONFIG.get("quantized_collectives")
                          if quantized is None else quantized)
        self.quantized_block = (
            GLOBAL_CONFIG.get("quantized_collectives_block")
            if quantized_block is None else quantized_block)
        # measured serialized bytes published/consumed by THIS member
        self.wire_put_bytes = 0
        self.wire_get_bytes = 0
        self._ns = f"collective:{group_name}"
        self._seq = 0
        self._p2p_send_seq = {}
        self._p2p_recv_seq = {}
        # Rendezvous: announce, then wait for the full membership.
        self._kv.kv_put(self._ns, f"member:{rank}",
                        pickle.dumps(world_size), overwrite=True)
        for r in range(world_size):
            self._wait_key(f"member:{r}")

    # ------------------------------------------------------------ plumbing
    def _wait_key(self, key: str, timeout: Optional[float] = None) -> bytes:
        deadline = time.monotonic() + (timeout or self.timeout_s)
        delay = 0.002
        while True:
            blob = self._kv.kv_get(self._ns, key)
            if blob is not None:
                return blob
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"collective group {self.group_name!r} rank {self.rank}: "
                    f"timed out waiting for {key!r} — mismatched op order or "
                    f"a dead member?")
            time.sleep(delay)
            delay = min(delay * 2, 0.05)

    def _put(self, key: str, value):
        blob = pickle.dumps(_wire(value), protocol=5)
        self.wire_put_bytes += len(blob)
        self._kv.kv_put(self._ns, key, blob, overwrite=True)

    def _put_reduce(self, key: str, value):
        """Data-plane put for reduce-family ops: quantized encode when the
        group runs in quantized wire mode and the payload is float."""
        if self.quantized and _is_float(value):
            blob = pickle.dumps(q.encode_payload(
                value if _is_tensor(value) else np.asarray(value),
                self.quantized_block), protocol=5)
            self.wire_put_bytes += len(blob)
            self._kv.kv_put(self._ns, key, blob, overwrite=True)
            return
        self._put(key, value)

    def _get(self, key: str):
        blob = self._wait_key(key)
        self.wire_get_bytes += len(blob)
        value = pickle.loads(blob)
        if q.is_quantized_payload(value):
            return q.decode_payload(value)
        return value

    def _next(self) -> int:
        self._seq += 1
        if self._seq % GC_EVERY == 0:
            self._gc()
        return self._seq

    def _gc(self):
        """Barrier, then rank 0 deletes data keys from finished ops."""
        seq = self._seq
        self._barrier_at(f"gcb:{seq}")
        if self.rank == 0:
            horizon = seq - 1
            for key in self._kv.kv_keys(self._ns, prefix=b"op:"):
                try:
                    op_seq = int(key.decode().split(":")[1])
                except (ValueError, IndexError):
                    continue
                if op_seq <= horizon:
                    self._kv.kv_del(self._ns, key)
            # Barrier keys from the *previous* GC round: every member has
            # passed that barrier (they reached this one), safe to delete.
            for r in range(self.world_size):
                self._kv.kv_del(self._ns, f"gcb:{seq - GC_EVERY}:{r}")

    def _barrier_at(self, tag: str):
        self._kv.kv_put(self._ns, f"{tag}:{self.rank}", b"1", overwrite=True)
        for r in range(self.world_size):
            self._wait_key(f"{tag}:{r}")

    def _reduce_parts(self, tag: str, op: ReduceOp):
        out = None
        for r in range(self.world_size):
            out = _reduce(out, self._get(f"{tag}:{r}"), op)
        return out

    # ---------------------------------------------------------- collectives
    def barrier(self):
        self._barrier_at(f"op:{self._next()}:bar")

    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        seq = self._next()
        self._put_reduce(f"op:{seq}:ar:{self.rank}", tensor)
        return _on_device_of(self._reduce_parts(f"op:{seq}:ar", op), tensor)

    def reduce(self, tensor, dst_rank: int = 0,
               op: ReduceOp = ReduceOp.SUM):
        seq = self._next()
        self._put_reduce(f"op:{seq}:rd:{self.rank}", tensor)
        if self.rank != dst_rank:
            return tensor if _is_tensor(tensor) else np.asarray(tensor)
        return _on_device_of(self._reduce_parts(f"op:{seq}:rd", op), tensor)

    def broadcast(self, tensor, src_rank: int = 0):
        seq = self._next()
        if self.rank == src_rank:
            self._put(f"op:{seq}:bc", tensor)
            return tensor if _is_tensor(tensor) else np.asarray(tensor)
        return _on_device_of(self._get(f"op:{seq}:bc"), tensor)

    def allgather(self, tensor) -> List:
        seq = self._next()
        self._put(f"op:{seq}:ag:{self.rank}", tensor)
        return [_on_device_of(self._get(f"op:{seq}:ag:{r}"), tensor)
                for r in range(self.world_size)]

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        """Reduce across members, return this rank's 1/world_size slice of
        axis 0 (axis-0 length must divide evenly)."""
        if not _is_tensor(tensor):
            tensor = np.asarray(tensor)
        if tensor.shape[0] % self.world_size:
            raise ValueError(
                f"reducescatter axis-0 length {tensor.shape[0]} not "
                f"divisible by world size {self.world_size}")
        full = self.allreduce(tensor, op)
        chunk = full.shape[0] // self.world_size
        return full[self.rank * chunk:(self.rank + 1) * chunk]

    def send(self, tensor, dst_rank: int):
        seq = self._p2p_send_seq.get(dst_rank, 0) + 1
        self._p2p_send_seq[dst_rank] = seq
        self._put(f"p2p:{self.rank}:{dst_rank}:{seq}", tensor)

    def recv(self, src_rank: int):
        """The value sent, as it was sent: a CPU tensor for a tensor (the
        receiver passes no operand whose device it could take), else a
        numpy array."""
        seq = self._p2p_recv_seq.get(src_rank, 0) + 1
        self._p2p_recv_seq[src_rank] = seq
        key = f"p2p:{src_rank}:{self.rank}:{seq}"
        out = self._get(key)
        self._kv.kv_del(self._ns, key)
        return out

    def destroy(self):
        # Exit barrier first: rank 0 must not delete op keys while a slower
        # member is still reading its parts of the final op (deleting early
        # strands that member in _wait_key until timeout). If a member died
        # and never reaches the barrier, time out and clean up anyway.
        try:
            self._barrier_at(f"destroy:{self._seq}")
        except TimeoutError:
            pass
        if self.rank == 0:
            # Delete only data-plane keys. member:/destroy: barrier keys stay:
            # a slower rank may still be polling them inside _barrier_at, and
            # deleting underneath it would stall that rank until timeout.
            for key in self._kv.kv_keys(self._ns):
                if key.startswith((b"op:", b"p2p:", b"gcb:")):
                    self._kv.kv_del(self._ns, key)
