"""Scaling policies: how many workers the trainer gangs up, and when to
resize a running gang (an own copy of ``ray_tpu/train/scaling_policy.py``).

Reference: ``python/ray/train/v2/_internal/execution/scaling_policy/``
(FixedScalingPolicy + the pluggable elastic interface consulted by the
TrainController loop). A resize is a gang RESTART at a new world size —
a process group and its mesh are made for a fixed world, so elasticity
means "restart from the latest checkpoint on a bigger/smaller mesh", not
adding workers to a live mesh. The policy decides sizes; the trainer
owns the restart mechanics it already has for failures.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional


@dataclasses.dataclass
class ResizeDecision:
    num_workers: int
    reason: str = ""


NOOP = None  # decide() returns None for "keep running as-is"


def _feasible_workers(bundle: Dict[str, float],
                      available: Dict[str, float]) -> int:
    """How many copies of `bundle` fit in `available` resources."""
    n = math.inf
    for res, qty in bundle.items():
        if qty <= 0:
            continue
        n = min(n, int(available.get(res, 0.0) // qty))
    return 0 if n is math.inf else int(n)


class FixedScalingPolicy:
    """Always the configured size; failures restart at the same size
    (the v1 behavior the trainer had built in)."""

    WATCHES_CAPACITY = False  # trainer skips capacity polling entirely

    def __init__(self, num_workers: int):
        self.num_workers = num_workers

    def initial_size(self, bundle, available) -> int:
        del bundle, available
        return self.num_workers

    def size_after_failure(self, bundle, available) -> int:
        del bundle, available
        return self.num_workers

    def decide(self, current_size: int, bundle, available):
        return NOOP


class ElasticScalingPolicy:
    """Run with whatever fits between min_workers and max_workers.

    - start: largest feasible size <= max (>= min or scheduling blocks)
    - failure: shrink to what is feasible NOW instead of insisting on
      the lost size (a dead node must not wedge training)
    - while running: if capacity for >= `upscale_step` more workers sits
      idle for `upscale_patience_s`, request an upscale restart from the
      latest checkpoint (cheap with frequent checkpoints; the trainer
      does the restart)
    """

    WATCHES_CAPACITY = True

    def __init__(self, min_workers: int, max_workers: int, *,
                 upscale_step: int = 1, upscale_patience_s: float = 5.0):
        if min_workers < 1 or max_workers < min_workers:
            raise ValueError("need 1 <= min_workers <= max_workers")
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.upscale_step = upscale_step
        self.upscale_patience_s = upscale_patience_s
        self._surplus_since: Optional[float] = None

    def _clamp(self, n: int) -> int:
        return max(self.min_workers, min(self.max_workers, n))

    def initial_size(self, bundle, available) -> int:
        return self._clamp(_feasible_workers(bundle, available))

    def size_after_failure(self, bundle, available) -> int:
        # the gang is down: its resources read as available again
        return self._clamp(_feasible_workers(bundle, available))

    def decide(self, current_size: int, bundle, available):
        if current_size >= self.max_workers:
            self._surplus_since = None
            return NOOP
        headroom = _feasible_workers(bundle, available)  # beyond the gang
        target = min(self.max_workers, current_size + headroom)
        if target - current_size < self.upscale_step:
            self._surplus_since = None
            return NOOP
        now = time.monotonic()
        if self._surplus_since is None:
            self._surplus_since = now
            return NOOP
        if now - self._surplus_since < self.upscale_patience_s:
            return NOOP
        self._surplus_since = None
        return ResizeDecision(
            target, f"idle capacity for {target - current_size} more workers")
