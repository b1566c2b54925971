"""Placement groups — the gang-scheduling primitive (reference:
python/ray/util/placement_group.py + gcs_placement_group_mgr).

TPU-first addition: strategy ``"SLICE_PACK"`` places all bundles on nodes of a
single ICI slice (label ``rt.io/tpu-slice``), one bundle per node — the SPMD
gang primitive for pjit worker groups.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from ray_tpu_torch.common.ids import PlacementGroupID
from ray_tpu_torch.common.task_spec import PlacementGroupStrategy

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD", "SLICE_PACK")


@dataclass
class PlacementGroup:
    id: PlacementGroupID
    bundles: List[Dict[str, float]]
    strategy: str

    def ready(self, timeout: float = 60.0) -> bool:
        cw = _core_worker()
        reply = cw.gcs.wait_placement_group_ready(self.id, timeout)
        return bool(reply.get("ok"))

    def wait(self, timeout_seconds: float = 60.0) -> bool:
        return self.ready(timeout_seconds)

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return self.bundles

    def table(self) -> Optional[dict]:
        return _core_worker().gcs.get_placement_group(self.id)


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: PlacementGroup
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False

    def to_spec_strategy(self) -> PlacementGroupStrategy:
        return PlacementGroupStrategy(
            placement_group_id=self.placement_group.id,
            bundle_index=self.placement_group_bundle_index,
            capture_child_tasks=self.placement_group_capture_child_tasks,
        )


def _core_worker():
    from ray_tpu_torch.core_worker.worker import CoreWorker

    return CoreWorker.current_or_raise()


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: Optional[str] = None,
) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be non-empty dicts")
    cw = _core_worker()
    pg_id = PlacementGroupID.from_random()
    cw.gcs.create_placement_group(
        pg_id,
        [{"resources": dict(b)} for b in bundles],
        strategy,
        name=name,
        job_id=cw.job_id,
    )
    return PlacementGroup(pg_id, [dict(b) for b in bundles], strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    _core_worker().gcs.remove_placement_group(pg.id)


def placement_group_table() -> List[dict]:
    return _core_worker().gcs.list_placement_groups()
