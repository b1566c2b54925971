"""Fault-tolerant fan-out to an actor fleet (port of
``ray_tpu/rl/actor_manager.py``, on the port's runtime).

Reference: ``rllib/utils/actor_manager.py:198 FaultTolerantActorManager`` —
async fan-out with per-actor health tracking; results come back tagged with
the actor id; unhealthy actors are skipped and can be restored/replaced.
Used for EnvRunner fleets and learner groups.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CallResult:
    actor_index: int
    ok: bool
    value: Any = None
    error: Optional[BaseException] = None

    def get(self):
        if not self.ok:
            raise self.error
        return self.value


class FaultTolerantActorManager:
    def __init__(self, actors: List[Any],
                 max_remote_requests_in_flight_per_actor: int = 2):
        self._actors: Dict[int, Any] = dict(enumerate(actors))
        self._healthy: Dict[int, bool] = {i: True for i in self._actors}
        self._max_in_flight = max_remote_requests_in_flight_per_actor

    # ------------------------------------------------------------ topology
    @property
    def actors(self) -> Dict[int, Any]:
        return dict(self._actors)

    def healthy_actor_ids(self) -> List[int]:
        return [i for i, h in self._healthy.items() if h]

    def num_healthy_actors(self) -> int:
        return len(self.healthy_actor_ids())

    def set_actor_state(self, actor_index: int, healthy: bool):
        self._healthy[actor_index] = healthy

    def add_actor(self, actor: Any) -> int:
        idx = max(self._actors) + 1 if self._actors else 0
        self._actors[idx] = actor
        self._healthy[idx] = True
        return idx

    def remove_actor(self, actor_index: int):
        import ray_tpu_torch

        actor = self._actors.pop(actor_index, None)
        self._healthy.pop(actor_index, None)
        if actor is not None:
            try:
                ray_tpu_torch.kill(actor)
            except Exception:  # noqa: BLE001
                pass

    # ------------------------------------------------------------- fan-out
    def foreach_actor(self, fn: Callable[[Any], Any], *,
                      healthy_only: bool = True,
                      remote_actor_ids: Optional[List[int]] = None,
                      timeout_seconds: Optional[float] = 60.0,
                      mark_unhealthy: bool = True) -> List[CallResult]:
        """``fn(actor) -> ObjectRef`` is applied to each actor (it should
        call ``.remote()``); results are fetched with per-actor fault
        isolation: one dead actor yields a failed CallResult, not an
        exception for the whole fleet."""
        import ray_tpu_torch

        ids = remote_actor_ids if remote_actor_ids is not None else (
            self.healthy_actor_ids() if healthy_only
            else list(self._actors))
        refs: Dict[int, Any] = {}
        results: List[CallResult] = []
        for i in ids:
            try:
                refs[i] = fn(self._actors[i])
            except Exception as e:  # noqa: BLE001 — submit-side failure
                results.append(CallResult(i, False, error=e))
                if mark_unhealthy:
                    self._healthy[i] = False
        # One shared deadline bounds the WHOLE fan-out: a single stuck
        # actor costs timeout_seconds once, not once per actor.
        import time

        deadline = (None if timeout_seconds is None
                    else time.monotonic() + timeout_seconds)
        for i, ref in refs.items():
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            try:
                value = ray_tpu_torch.get([ref], timeout=remaining)[0]
                results.append(CallResult(i, True, value=value))
            except Exception as e:  # noqa: BLE001 — actor died / timeout
                results.append(CallResult(i, False, error=e))
                if mark_unhealthy:
                    self._healthy[i] = False
        results.sort(key=lambda r: r.actor_index)
        return results

    def probe_health(self, method: str = "ping") -> List[int]:
        """Re-probe unhealthy actors; mark recovered ones healthy again."""
        import ray_tpu_torch

        recovered = []
        for i, h in list(self._healthy.items()):
            if h:
                continue
            try:
                ray_tpu_torch.get([getattr(self._actors[i], method).remote()],
                            timeout=5.0)
                self._healthy[i] = True
                recovered.append(i)
            except Exception:  # noqa: BLE001 — still dead
                pass
        return recovered
