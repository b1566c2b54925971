"""In-program collective group — NCCL across the devices one process owns
(port of ``ray_tpu/collective/xla_group.py``; the class keeps the JAX
package's name, and ``Backend.parse("nccl")`` maps to it).

The NCCL group of the reference (``python/ray/util/collective/
collective_group/nccl_collective_group.py``), in the JAX package's
single-controller shape: a "group" is a set of devices owned by ONE
process, and each op is one collective over them.

Convention: ops take a **stacked** tensor whose leading axis is the member
axis (length ``world_size``); member i's slab is placed on
``devices[i]``, the collective runs over those devices, and the result
comes back replicated (allreduce/allgather) or member-sharded
(reducescatter). On CUDA devices the collectives are NCCL's, through
``torch.cuda.nccl`` (one communicator clique over the slabs' devices); on
CPU slabs they are the same reductions as tensor ops. A torch tensor lives
on one device where a JAX array may span the mesh, so a replicated result
is returned as member 0's copy, on ``devices[0]``, and a member-sharded
one as the stack of the members' chunks on ``devices[0]``.

With ``RT_quantized_collectives`` on, float SUM allreduce and
reducescatter take the two-phase block-int8 form
(``collective/quantization.py``): each member quantizes its W chunks,
chunk c of every member moves to member c's device (the all_to_all),
which dequantizes, sums, requantizes; the reduced chunks are gathered and
dequantized. Every other (op, dtype) stays on the exact path.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ray_tpu_torch.collective.types import ReduceOp

# ncclRedOp_t of each op this backend reduces with (as the JAX package's
# psum, pmax, pmin)
_NCCL_OPS = {ReduceOp.SUM: 0, ReduceOp.MAX: 2, ReduceOp.MIN: 3}
_TORCH_OPS = {ReduceOp.SUM: "add", ReduceOp.MAX: "maximum",
              ReduceOp.MIN: "minimum"}


class XlaGroup:
    backend_name = "xla"

    def __init__(self, world_size: int, rank: int = 0, group_name: str = "",
                 devices: Optional[list] = None, axis: str = "x"):
        import torch

        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "XlaGroup(devices=None) takes every visible CUDA device, "
                    "and CUDA is not available here; pass devices= (e.g. "
                    "[torch.device('cpu')] * world_size) to run on the CPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        if world_size > len(devices):
            raise ValueError(
                f"world_size {world_size} exceeds {len(devices)} devices")
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self.axis = axis
        self.devices = devices[:world_size]
        self._nccl = self.devices[0].type == "cuda"
        if self._nccl and len({d for d in self.devices}) != world_size:
            raise ValueError(
                "NCCL needs one device per member; got "
                f"{[str(d) for d in self.devices]}")

    # ------------------------------------------------------------ plumbing
    def _check(self, tensor):
        if tensor.shape[0] != self.world_size:
            raise ValueError(
                f"leading (member) axis {tensor.shape[0]} != world_size "
                f"{self.world_size}")

    @staticmethod
    def _tensor(tensor):
        import torch

        if isinstance(tensor, torch.Tensor):
            return tensor
        return torch.from_numpy(np.array(tensor))

    def _placed(self, tensor) -> list:
        """A copy of member i's slab on ``devices[i]``, contiguous (NCCL
        reduces in place, and needs contiguous buffers)."""
        return [tensor[i].to(d, copy=True).contiguous()
                for i, d in enumerate(self.devices)]

    def _out(self, t):
        return t.to(self.devices[0])

    # ------------------------------------------------- quantized substrate
    def _quantization_block(self) -> int:
        from ray_tpu_torch.common.config import GLOBAL_CONFIG

        return GLOBAL_CONFIG.get("quantized_collectives_block")

    def _use_quantized(self, tensor, op: ReduceOp) -> bool:
        """Quantized lowering applies to float SUM reductions only; every
        other (op, dtype) combination stays on the exact path, which also
        remains the default (RT_quantized_collectives=0) and is untouched
        by this routing — bit-identical results with the flag off."""
        from ray_tpu_torch.common.config import GLOBAL_CONFIG

        if not GLOBAL_CONFIG.get("quantized_collectives"):
            return False
        return op is ReduceOp.SUM and tensor.is_floating_point()

    def _phase1(self, rows: list, block: int) -> list:
        """``rows[i]``: member i's (W, chunk) per-destination chunks on its
        device. Each member quantizes its chunks, chunk c of every member
        moves to member c's device (the all_to_all), and member c
        dequantizes and sums them: returns each member's (cpad,) sum chunk
        on its device."""
        import torch.nn.functional as F

        from ray_tpu_torch.collective.quantization import (
            dequantize_blocks_torch, quantize_blocks_torch)

        W = self.world_size
        chunk = rows[0].shape[1]
        cpad = -(-chunk // block) * block
        sent = []
        for r in rows:
            blocks = F.pad(r, (0, cpad - chunk)).reshape(W, cpad // block,
                                                         block)
            sent.append(quantize_blocks_torch(blocks))
        sums = []
        for c, dev in enumerate(self.devices):
            parts = [dequantize_blocks_torch(
                codes[c].to(dev), scale[c].to(dev), lo[c].to(dev),
                rows[c].dtype) for codes, scale, lo in sent]
            sums.append(sum(parts[1:], parts[0]).reshape(-1))
        return sums

    def _allreduce_quantized(self, slabs: list, block: int):
        """The two-phase quantized allreduce; member 0's result."""
        import torch
        import torch.nn.functional as F

        from ray_tpu_torch.collective.quantization import (
            dequantize_blocks_torch, quantize_blocks_torch)

        W = self.world_size
        shape = slabs[0].shape
        n = slabs[0].numel()
        chunk = -(-n // W)
        rows = [F.pad(s.reshape(-1), (0, W * chunk - n)).reshape(W, chunk)
                for s in slabs]
        red = self._phase1(rows, block)
        cpad = red[0].shape[0]
        enc = [quantize_blocks_torch(r.reshape(cpad // block, block))
               for r in red]
        # the all_gather of the reduced chunks, at member 0
        dev = self.devices[0]
        codes2 = torch.stack([c.to(dev) for c, _, _ in enc])
        s2 = torch.stack([s.to(dev) for _, s, _ in enc])
        l2 = torch.stack([lo.to(dev) for _, _, lo in enc])
        full = dequantize_blocks_torch(codes2, s2, l2, slabs[0].dtype)
        full = full.reshape(W, cpad)[:, :chunk].reshape(-1)[:n]
        return full.reshape(shape)

    def _reducescatter_quantized(self, slabs: list, block: int) -> list:
        """The quantized reducescatter: member i's (c, ...) chunk on its
        device."""
        W = self.world_size
        c = slabs[0].shape[0] // W
        rest = tuple(slabs[0].shape[1:])
        rows = [s.reshape(W, -1) for s in slabs]       # (W, c*E)
        chunk = rows[0].shape[1]
        return [r[:chunk].reshape((c,) + rest)
                for r in self._phase1(rows, block)]

    # ---------------------------------------------------------- collectives
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        """(W, ...) stacked → (...) reduced, replicated over the group."""
        tensor = self._tensor(tensor)
        self._check(tensor)
        if op not in _NCCL_OPS:
            raise ValueError(f"{op} unsupported by the xla backend")
        slabs = self._placed(tensor)
        if self._use_quantized(tensor, op):
            return self._allreduce_quantized(
                slabs, self._quantization_block())
        if self._nccl:
            from torch.cuda import nccl

            nccl.all_reduce(slabs, op=_NCCL_OPS[op])
            return slabs[0]
        import torch

        reducer = getattr(torch, _TORCH_OPS[op])
        out = slabs[0]
        for s in slabs[1:]:
            out = reducer(out, s)
        return out

    def reduce(self, tensor, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        # Single-controller: result is replicated anyway.
        return self.allreduce(tensor, op)

    def broadcast(self, tensor, src_rank: int = 0):
        """Replicate member ``src_rank``'s slab over the group."""
        tensor = self._tensor(tensor)
        self._check(tensor)
        slabs = self._placed(tensor)
        if self._nccl:
            from torch.cuda import nccl

            nccl.broadcast(slabs, root=src_rank)
            return slabs[0]
        return self._out(slabs[src_rank])

    def allgather(self, tensor) -> List:
        """(W, ...) stacked → list of W tensors, each replicated."""
        import torch

        tensor = self._tensor(tensor)
        self._check(tensor)
        slabs = self._placed(tensor)
        if self._nccl:
            from torch.cuda import nccl

            outs = [torch.empty((self.world_size,) + tuple(s.shape),
                                dtype=s.dtype, device=s.device)
                    for s in slabs]
            nccl.all_gather(slabs, outs)
            gathered = outs[0]
        else:
            gathered = torch.stack([self._out(s) for s in slabs])
        return [gathered[i] for i in range(self.world_size)]

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        """(W, W·c, ...) stacked → (W, c, ...): member i gets the reduction
        of every member's i-th chunk (member i's chunk computed on its
        device; the chunks come back stacked on ``devices[0]``)."""
        import torch

        tensor = self._tensor(tensor)
        self._check(tensor)
        if op is not ReduceOp.SUM:
            raise ValueError("xla reducescatter supports SUM only")
        if tensor.shape[1] % self.world_size:
            raise ValueError(
                f"axis-1 length {tensor.shape[1]} not divisible by "
                f"world size {self.world_size}")
        W = self.world_size
        slabs = self._placed(tensor)
        c = tensor.shape[1] // W
        rest = tuple(tensor.shape[2:])
        if self._use_quantized(tensor, op):
            chunks = self._reducescatter_quantized(
                slabs, self._quantization_block())
        elif self._nccl:
            from torch.cuda import nccl

            chunks = [torch.empty((c,) + rest, dtype=s.dtype,
                                  device=s.device) for s in slabs]
            nccl.reduce_scatter(slabs, chunks, op=_NCCL_OPS[op])
        else:
            total = slabs[0]
            for s in slabs[1:]:
                total = total + s
            chunks = list(total.reshape((W, c) + rest))
        return torch.stack([self._out(ch) for ch in chunks])

    def barrier(self):
        """Single-controller: wait for the work queued on every member's
        device."""
        import torch

        if self._nccl:
            for d in self.devices:
                torch.cuda.synchronize(d)

    def destroy(self):
        pass
