"""Resource model with fractional fixed-point accounting and first-class TPU.

Follows the reference's scheduling resource model
(src/ray/common/scheduling/cluster_resource_data.h:37, resource_instance_set.h:25,
fixed_point.h:25) with one deliberate divergence: **TPU is a predefined resource**
(the reference keeps TPU as a string custom resource set up by an accelerator
plugin, python/ray/_private/accelerators/tpu.py) and nodes carry ICI-topology
labels (slice name, worker index, topology) so placement policies can
gang-schedule SPMD groups onto one slice.

All quantities are fixed-point with 1e-4 resolution so fractional resources
(e.g. num_tpus=0.25) have exact arithmetic.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional

RESOLUTION = 10_000

# Predefined resource names (reference: scheduling_ids.h:32 PredefinedResourcesEnum,
# which has CPU/MEM/GPU/OBJECT_STORE_MEM; we add TPU).
CPU = "CPU"
MEM = "memory"
GPU = "GPU"
TPU = "TPU"
OBJECT_STORE_MEM = "object_store_memory"
PREDEFINED = (CPU, MEM, GPU, TPU, OBJECT_STORE_MEM)

# Node labels with framework meaning (TPU topology; reference expresses the
# equivalent via `TPU-<pod_type>-head` custom resources, tpu.py:338-374).
LABEL_SLICE_NAME = "rt.io/tpu-slice"
LABEL_SLICE_TOPOLOGY = "rt.io/tpu-topology"
LABEL_SLICE_WORKER_INDEX = "rt.io/tpu-worker-index"
LABEL_NODE_ID = "rt.io/node-id"

# Unit-instance resources: allocation happens per whole device instance when
# the request is an integer (reference: NodeResourceInstanceSet).
UNIT_INSTANCE_RESOURCES = (GPU, TPU)


def to_fixed(value: float | int) -> int:
    return round(value * RESOLUTION)


def from_fixed(value: int) -> float:
    if value % RESOLUTION == 0:
        return value // RESOLUTION
    return value / RESOLUTION


class ResourceSet:
    """Immutable-ish map of resource name -> fixed-point quantity (>0 entries only)."""

    __slots__ = ("_fixed",)

    def __init__(self, resources: Optional[Mapping[str, float]] = None, _fixed=None):
        if _fixed is not None:
            self._fixed: Dict[str, int] = {k: v for k, v in _fixed.items() if v > 0}
        else:
            self._fixed = {}
            for name, qty in (resources or {}).items():
                if qty < 0:
                    raise ValueError(f"negative resource {name}={qty}")
                f = to_fixed(qty)
                if f > 0:
                    self._fixed[name] = f

    @classmethod
    def _from_fixed(cls, fixed: Dict[str, int]) -> "ResourceSet":
        return cls(_fixed=fixed)

    def get(self, name: str) -> float:
        return from_fixed(self._fixed.get(name, 0))

    def get_fixed(self, name: str) -> int:
        return self._fixed.get(name, 0)

    def names(self) -> Iterable[str]:
        return self._fixed.keys()

    def is_empty(self) -> bool:
        return not self._fixed

    def to_dict(self) -> Dict[str, float]:
        return {k: from_fixed(v) for k, v in self._fixed.items()}

    def is_subset_of(self, other: "ResourceSet") -> bool:
        return all(other._fixed.get(k, 0) >= v for k, v in self._fixed.items())

    def __add__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._fixed)
        for k, v in other._fixed.items():
            out[k] = out.get(k, 0) + v
        return ResourceSet._from_fixed(out)

    def __sub__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._fixed)
        for k, v in other._fixed.items():
            out[k] = out.get(k, 0) - v
            if out[k] < 0:
                raise ValueError(f"resource {k} would go negative")
        return ResourceSet._from_fixed(out)

    def __eq__(self, other) -> bool:
        return isinstance(other, ResourceSet) and self._fixed == other._fixed

    def __repr__(self) -> str:
        return f"ResourceSet({self.to_dict()})"

    def __reduce__(self):
        return (_resource_set_from_dict, (self.to_dict(),))


def _resource_set_from_dict(d):
    return ResourceSet(d)


class LabelSelector:
    """Node-label constraint (reference: label_selector.h:56).

    Supported ops: ``in``, ``!in``, ``exists``, ``!exists`` expressed as a dict
    {key: spec} where spec is a string value ("v" / "!v") or list of values.
    """

    def __init__(self, selector: Optional[Mapping[str, object]] = None):
        self._selector = dict(selector or {})

    def matches(self, labels: Mapping[str, str]) -> bool:
        for key, spec in self._selector.items():
            if spec == "exists":
                if key not in labels:
                    return False
            elif spec == "!exists":
                if key in labels:
                    return False
            elif isinstance(spec, str):
                if spec.startswith("!"):
                    if labels.get(key) == spec[1:]:
                        return False
                elif labels.get(key) != spec:
                    return False
            elif isinstance(spec, (list, tuple, set)):
                if labels.get(key) not in spec:
                    return False
            else:
                raise ValueError(f"bad label selector spec {key}={spec!r}")
        return True

    def is_empty(self) -> bool:
        return not self._selector

    def to_dict(self):
        return dict(self._selector)

    def __repr__(self):
        return f"LabelSelector({self._selector})"


class NodeResources:
    """A node's total/available resources + labels, with per-instance accounting
    for unit-instance resources (TPU/GPU chips)."""

    def __init__(
        self,
        total: Mapping[str, float],
        labels: Optional[Mapping[str, str]] = None,
    ):
        self.total = ResourceSet(total)
        self.available = ResourceSet(total)
        self.labels: Dict[str, str] = dict(labels or {})
        # chip-index -> fixed-point free fraction, for TPU/GPU visibility assignment
        self._instances: Dict[str, List[int]] = {}
        for res in UNIT_INSTANCE_RESOURCES:
            n = self.total.get(res)
            if n and float(n).is_integer():
                self._instances[res] = [RESOLUTION] * int(n)

    # -- queries --
    def is_feasible(self, request: "ResourceRequest") -> bool:
        """Could this request EVER fit on an empty node (capacity + labels)?"""
        return request.resources.is_subset_of(self.total) and request.label_selector.matches(
            self.labels
        )

    def is_available(self, request: "ResourceRequest") -> bool:
        return request.resources.is_subset_of(self.available) and request.label_selector.matches(
            self.labels
        )

    def utilization(self) -> float:
        worst = 0.0
        for name in self.total.names():
            t = self.total.get_fixed(name)
            a = self.available.get_fixed(name)
            if t > 0:
                worst = max(worst, (t - a) / t)
        return worst

    # -- mutation --
    def allocate(self, request: "ResourceRequest") -> Optional[Dict[str, List[int]]]:
        """Subtract the request; returns {resource: [chip indices]} for unit
        resources (used to set CUDA_VISIBLE_DEVICES), or None if it doesn't fit."""
        if not self.is_available(request):
            return None
        # Two-phase: tentatively pick instance slots for every unit resource,
        # then apply atomically — a partial failure must not leak zeroed slots.
        plan: List[tuple] = []  # (insts, index, new_value)
        assignment: Dict[str, List[int]] = {}
        for res, insts in self._instances.items():
            need = request.resources.get_fixed(res)
            if need == 0:
                continue
            picked: List[int] = []
            if need % RESOLUTION == 0:
                want = need // RESOLUTION
                for i, free in enumerate(insts):
                    if free == RESOLUTION and len(picked) < want:
                        picked.append(i)
                        plan.append((insts, i, 0))
                if len(picked) < want:
                    # aggregate has capacity but chips are fragmented by
                    # fractional allocations: whole-chip request can't be met
                    return None
            else:
                # fractional: carve from the first instance with enough room
                for i, free in enumerate(insts):
                    if free >= need:
                        picked.append(i)
                        plan.append((insts, i, free - need))
                        break
                else:
                    return None
            assignment[res] = picked
        self.available = self.available - request.resources
        for insts, i, new_value in plan:
            insts[i] = new_value
        return assignment

    def free(self, request: "ResourceRequest", assignment: Optional[Dict[str, List[int]]] = None):
        self.available = self.available + request.resources
        for res, picked in (assignment or {}).items():
            insts = self._instances.get(res)
            if insts is None:
                continue
            need = request.resources.get_fixed(res)
            if need % RESOLUTION == 0:
                for i in picked:
                    insts[i] = RESOLUTION
            elif picked:
                insts[picked[0]] += need

    def snapshot(self) -> dict:
        return {
            "total": self.total.to_dict(),
            "available": self.available.to_dict(),
            "labels": dict(self.labels),
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "NodeResources":
        nr = cls(snap["total"], snap.get("labels"))
        nr.available = ResourceSet(snap["available"])
        return nr

    def __repr__(self):
        return f"NodeResources(total={self.total.to_dict()}, avail={self.available.to_dict()})"


class ResourceRequest:
    """What a task/actor/bundle demands (reference: cluster_resource_data.h:37)."""

    def __init__(
        self,
        resources: Optional[Mapping[str, float]] = None,
        label_selector: Optional[Mapping[str, object]] = None,
    ):
        self.resources = ResourceSet(resources)
        self.label_selector = LabelSelector(label_selector)

    def is_empty(self) -> bool:
        return self.resources.is_empty() and self.label_selector.is_empty()

    def to_dict(self) -> dict:
        return {
            "resources": self.resources.to_dict(),
            "label_selector": self.label_selector.to_dict(),
        }

    @classmethod
    def from_dict(cls, d) -> "ResourceRequest":
        return cls(d.get("resources"), d.get("label_selector"))

    def shape_key(self) -> tuple:
        """Hashable key grouping equivalent requests (lease pooling)."""
        return (
            tuple(sorted(self.resources.to_dict().items())),
            tuple(sorted((k, str(v)) for k, v in self.label_selector.to_dict().items())),
        )

    def __repr__(self):
        return f"ResourceRequest({self.resources.to_dict()}, labels={self.label_selector.to_dict()})"
