"""Scheduling policies.

Node-selection strategies mirroring the reference's policy objects
(src/ray/raylet/scheduling/policy/hybrid_scheduling_policy.h:28-49,
bundle_scheduling_policy.h), plus a TPU-slice-aware gang policy that has no
reference counterpart: ICI topology makes TPU placement non-fungible, so
bundle policies can require all bundles land on nodes of one slice
(label ``rt.io/tpu-slice``).
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from ray_tpu_torch.common.config import GLOBAL_CONFIG
from ray_tpu_torch.common.ids import NodeID
from ray_tpu_torch.common.resources import LABEL_SLICE_NAME, NodeResources, ResourceRequest
from ray_tpu_torch.common.task_spec import (
    DefaultStrategy,
    NodeAffinityStrategy,
    NodeLabelStrategy,
    SchedulingStrategy,
    SpreadStrategy,
)
from .cluster_state import ClusterView, NodeEntry


def _score(entry: NodeEntry, local_node: Optional[NodeID]) -> float:
    """Hybrid policy score: lower is better.  Prefers (1) low utilization up to
    a threshold — packing below it, spreading above — and (2) locality."""
    threshold = GLOBAL_CONFIG.get("scheduler_spread_threshold")
    util = entry.resources.utilization()
    score = 0.0 if util <= threshold else util
    if local_node is not None and entry.node_id == local_node:
        score -= 0.25  # locality bonus: prefer granting locally
    return score


def pick_node(
    view: ClusterView,
    request: ResourceRequest,
    strategy: Optional[SchedulingStrategy] = None,
    local_node: Optional[NodeID] = None,
    rng: Optional[random.Random] = None,
    require_available: bool = True,
    arg_bytes_by_node: Optional[Dict[str, int]] = None,
) -> Optional[NodeEntry]:
    """Select a node for one request.  Returns None if nothing is feasible
    (caller decides to queue or fail).

    ``arg_bytes_by_node`` ({node_id_hex: total argument bytes resident
    there}) is the data-locality hint (reference: the locality-aware lease
    policy, ``locality_aware_scheduling``): among usable candidates the
    node holding the most argument bytes wins outright — shipping the task
    is cheaper than shipping its args — with the hybrid pack/spread score
    only breaking ties.  Explicit placement strategies (affinity, labels,
    spread) are never overridden by the hint."""
    rng = rng or random
    strategy = strategy or DefaultStrategy()
    nodes = list(view.alive_nodes())

    if isinstance(strategy, NodeAffinityStrategy):
        entry = view.get(strategy.node_id)
        ok = (
            entry is not None
            and entry.alive
            and (entry.resources.is_available(request) if require_available
                 else entry.resources.is_feasible(request))
        )
        if ok:
            return entry
        if strategy.soft:
            return pick_node(view, request, DefaultStrategy(), local_node, rng, require_available)
        return None

    if isinstance(strategy, NodeLabelStrategy):
        from ray_tpu_torch.common.resources import LabelSelector

        hard = LabelSelector(strategy.hard)
        nodes = [n for n in nodes if hard.matches(n.resources.labels)]
        if strategy.soft:
            soft = LabelSelector(strategy.soft)
            preferred = [n for n in nodes if soft.matches(n.resources.labels)]
            if preferred:
                nodes = preferred

    def usable(n: NodeEntry) -> bool:
        return n.resources.is_available(request) if require_available else n.resources.is_feasible(request)

    candidates = [n for n in nodes if usable(n)]
    if not candidates:
        return None

    if isinstance(strategy, SpreadStrategy):
        # round-robin-ish: least utilized first, random tiebreak
        return min(candidates, key=lambda n: (n.resources.utilization(), rng.random()))

    if arg_bytes_by_node and GLOBAL_CONFIG.get("locality_scheduling"):
        best = max(candidates,
                   key=lambda n: (arg_bytes_by_node.get(n.node_id.hex(), 0),
                                  -_score(n, local_node)))
        if arg_bytes_by_node.get(best.node_id.hex(), 0) > 0:
            return best

    # hybrid: score, then top-k random choice to avoid herding
    scored = sorted(candidates, key=lambda n: _score(n, local_node))
    k = max(
        GLOBAL_CONFIG.get("scheduler_top_k_absolute"),
        int(len(scored) * GLOBAL_CONFIG.get("scheduler_top_k_fraction")),
    )
    return rng.choice(scored[:k])


# ---------------------------------------------------------------------------
# Placement group bundle policies (gang scheduling)
# ---------------------------------------------------------------------------

class BundlePlacementError(Exception):
    pass


def place_bundles(
    view: ClusterView,
    bundles: Sequence[ResourceRequest],
    strategy: str,
    rng: Optional[random.Random] = None,
) -> Optional[List[NodeID]]:
    """Map each bundle to a node. Strategies: PACK, SPREAD, STRICT_PACK,
    STRICT_SPREAD, SLICE_PACK (all bundles on nodes sharing one TPU slice
    label, one bundle per node — the SPMD gang primitive).

    Returns None if currently infeasible (PGs stay pending), raises
    BundlePlacementError if *never* feasible.
    """
    rng = rng or random
    nodes = list(view.alive_nodes())
    if strategy == "SLICE_PACK":
        return _place_slice_pack(nodes, bundles, rng)

    # simulate allocations on copies so one node's capacity isn't double-counted
    sim: Dict[NodeID, NodeResources] = {
        n.node_id: NodeResources.from_snapshot(n.resources.snapshot()) for n in nodes
    }
    order = {n.node_id: n for n in nodes}

    def nodes_sorted_for(strategy_: str) -> List[NodeID]:
        if strategy_ in ("PACK", "STRICT_PACK"):
            return sorted(sim, key=lambda nid: sim[nid].utilization(), reverse=True)
        return sorted(sim, key=lambda nid: sim[nid].utilization())

    placement: List[NodeID] = []
    used_nodes: set = set()
    for bundle in bundles:
        placed = False
        for nid in nodes_sorted_for(strategy):
            if strategy == "STRICT_SPREAD" and nid in used_nodes:
                continue
            if not sim[nid].labels and order[nid].resources.labels:
                sim[nid].labels = dict(order[nid].resources.labels)
            if sim[nid].allocate(bundle) is not None:
                placement.append(nid)
                used_nodes.add(nid)
                placed = True
                break
        if not placed:
            if strategy == "STRICT_PACK" and placement:
                # STRICT_PACK: everything must fit one node; retry all-on-one
                return _place_strict_pack(nodes, bundles)
            return None
    if strategy == "STRICT_PACK" and len(set(placement)) > 1:
        return _place_strict_pack(nodes, bundles)
    return placement


def _place_strict_pack(nodes: List[NodeEntry], bundles: Sequence[ResourceRequest]):
    for n in nodes:
        sim = NodeResources.from_snapshot(n.resources.snapshot())
        if all(sim.allocate(b) is not None for b in bundles):
            return [n.node_id] * len(bundles)
    return None


def _place_slice_pack(nodes: List[NodeEntry], bundles: Sequence[ResourceRequest], rng):
    """All bundles on one ICI slice, spread across its member nodes."""
    by_slice: Dict[str, List[NodeEntry]] = defaultdict(list)
    for n in nodes:
        slice_name = n.resources.labels.get(LABEL_SLICE_NAME)
        if slice_name:
            by_slice[slice_name].append(n)
    for slice_name in sorted(by_slice, key=lambda s: len(by_slice[s])):
        members = by_slice[slice_name]
        if len(members) < len(bundles):
            continue
        sim = {n.node_id: NodeResources.from_snapshot(n.resources.snapshot()) for n in members}
        placement: List[NodeID] = []
        used: set = set()
        ok = True
        for bundle in bundles:
            for nid in sim:
                if nid in used:
                    continue
                if sim[nid].allocate(bundle) is not None:
                    placement.append(nid)
                    used.add(nid)
                    break
            else:
                ok = False
                break
        if ok:
            return placement
    return None
