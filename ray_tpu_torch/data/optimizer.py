"""Logical-plan optimizer (port of ``ray_tpu/data/optimizer.py``; the three
rules, copied. Reference: ``python/ray/data/_internal/logical/
optimizers.py`` — rule-based rewrites applied before physical planning).

Rules run in order over the op list until a fixed point:

- :class:`PushFilterThroughShuffle` — a filter after repartition /
  random_shuffle / sort moves in front of it: those ops only reorder or
  re-bucket rows, so filtering first is equivalent and shrinks the data
  crossing the shuffle barrier.
- :class:`FuseMapChains` — runs of plain (non-actor-pool) block maps
  compose into ONE task per block (reference OperatorFusionRule), so a
  ``map().filter().map()`` chain costs one scheduling round-trip.
- :class:`FuseReadMap` — the map chain directly after a read folds into
  the read tasks themselves: read+transform is one task, halving task
  count for the ubiquitous ``read_*().map_batches()`` pipeline.
"""

from __future__ import annotations

from typing import List


class Rule:
    def apply(self, ops: List) -> List:  # pragma: no cover - interface
        raise NotImplementedError


class PushFilterThroughShuffle(Rule):
    """filter ∘ shuffle ≡ shuffle ∘ filter for row-preserving shuffles."""

    _COMMUTING_MODES = {"repartition", "random", "sort"}

    def apply(self, ops: List) -> List:
        from ray_tpu_torch.data.dataset import _MapBlock, _Shuffle

        ops = list(ops)
        changed = True
        while changed:
            changed = False
            for i in range(len(ops) - 1):
                a, b = ops[i], ops[i + 1]
                if (isinstance(a, _Shuffle)
                        and a.mode in self._COMMUTING_MODES
                        and isinstance(b, _MapBlock)
                        and b.actor_pool is None
                        and b.name == "filter"):
                    ops[i], ops[i + 1] = b, a
                    changed = True
        return ops


class FuseMapChains(Rule):
    def apply(self, ops: List) -> List:
        from ray_tpu_torch.data.dataset import _MapBlock

        out: List = []
        for op in ops:
            prev = out[-1] if out else None
            if (isinstance(op, _MapBlock) and op.actor_pool is None
                    and isinstance(prev, _MapBlock)
                    and prev.actor_pool is None):
                def fused(block, _f=prev.fn, _g=op.fn):
                    return _g(_f(block))

                out[-1] = _MapBlock(fused, f"{prev.name}->{op.name}")
            else:
                out.append(op)
        return out


class FuseReadMap(Rule):
    """Fold the first plain map into the read tasks (runs after
    FuseMapChains, so that map already is the whole leading chain)."""

    def apply(self, ops: List) -> List:
        from ray_tpu_torch.data.dataset import _MapBlock, _Read

        if (len(ops) >= 2 and isinstance(ops[0], _Read)
                and isinstance(ops[1], _MapBlock)
                and ops[1].actor_pool is None):
            fn = ops[1].fn
            fused_tasks = [
                (lambda _t=task, _f=fn: _f(_t()))
                for task in ops[0].read_tasks
            ]
            return [_Read(fused_tasks)] + ops[2:]
        return ops


DEFAULT_RULES = (PushFilterThroughShuffle(), FuseMapChains(), FuseReadMap())


def optimize(ops: List, rules=DEFAULT_RULES) -> List:
    """Apply the rule set to a logical op list. Pure: returns a new list."""
    for rule in rules:
        ops = rule.apply(ops)
    return ops
