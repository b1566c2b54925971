"""Collective nodes for actor DAGs.

Reference: ``python/ray/dag/collective_node.py:23`` (``_CollectiveOperation``
+ ``CollectiveOutputNode:252``) — N branch outputs, one per participating
actor, whose values are allreduced across the group.

Lowering: in a channel-compiled DAG each participating stage actor joins
a collective group (``ray_tpu_torch.collective``, the KV backend between
host processes) and allreduces its stage output in place, so the reduced
tensor flows on down the pipeline without touching the driver.
In eager / RPC-compiled execution the reduction falls back to a driver-side
sum of the branch refs — semantically identical, used for debugging.

Usage (same shape as the reference)::

    from ray_tpu_torch.graph import allreduce
    with InputNode() as inp:
        outs = [w.grad.bind(inp) for w in workers]       # N ClassMethodNodes
        reduced = allreduce.bind(outs)                    # N outputs
        dag = MultiOutputNode(reduced)
"""

from __future__ import annotations

import uuid
from typing import List, Sequence

from ray_tpu_torch.graph.dag import DAGNode


class _CollectiveOperation:
    """Shared identity of ONE collective op across its branch outputs."""

    def __init__(self, inputs: Sequence[DAGNode], op: str = "sum"):
        if not inputs:
            raise ValueError("collective op needs at least one input node")
        if op not in ("sum", "mean"):
            raise ValueError(f"unsupported collective op {op!r}")
        self.inputs = list(inputs)
        self.op = op
        self.group_name = f"dag_coll_{uuid.uuid4().hex[:12]}"

    @property
    def world_size(self) -> int:
        return len(self.inputs)


class CollectiveOutputNode(DAGNode):
    """Branch ``index``'s reduced output (reference
    ``CollectiveOutputNode:252``)."""

    def __init__(self, op: _CollectiveOperation, index: int):
        # Bind ALL branch inputs so topological order resolves every branch
        # before any output runs (the eager reduction needs all of them).
        super().__init__(tuple(op.inputs), {})
        self._op = op
        self._index = index

    def _apply(self, resolved, input_args, input_kwargs):
        # Eager/RPC fallback: one driver-side reduce per op per execution
        # (channel compilation replaces this with an in-stage allreduce).
        if id(self._op) not in resolved:
            import ray_tpu_torch

            vals = ray_tpu_torch.get([resolved[id(n)]
                                      for n in self._op.inputs])
            total = vals[0]
            for v in vals[1:]:
                total = total + v
            if self._op.op == "mean":
                total = total / len(vals)
            resolved[id(self._op)] = ray_tpu_torch.put(total)
        return resolved[id(self._op)]


class _AllreduceNamespace:
    """``allreduce.bind(nodes)`` — mirrors the reference's
    ``ray.experimental.collective.allreduce.bind``."""

    @staticmethod
    def bind(nodes: Sequence[DAGNode], op: str = "sum"
             ) -> List[CollectiveOutputNode]:
        coll = _CollectiveOperation(nodes, op)
        return [CollectiveOutputNode(coll, i) for i in range(len(nodes))]


allreduce = _AllreduceNamespace()
