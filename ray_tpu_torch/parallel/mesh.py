"""Device mesh construction (port of ``ray_tpu/parallel/mesh.py``).

Axis convention (outer → inner, slowest → fastest varying), as in the JAX
package:

    ``dp``    pure data parallel; gradients all-reduced.
    ``fsdp``  data parallel with parameter/optimizer sharding (ZeRO-3 style).
    ``sp``    sequence/context parallel (ring attention / all-to-all).
    ``tp``    tensor parallel (megatron-style activation collectives); the
              chattiest axis, innermost.
    ``ep``    expert parallel for MoE, aliased over fsdp×sp.
    ``pp``    pipeline stages.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the current process group, one rank a device: the GPU a rank
sees (its lease's ``CUDA_VISIBLE_DEVICES``) or, when the caller asks for
``"cpu"``, a CPU process on gloo. Collectives between its ranks are NCCL
on the GPU and gloo on the CPU; there is no DCN, so ``num_slices > 1``
refuses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Degrees for each parallelism axis. ``-1`` on at most one axis means
    "absorb all remaining devices"."""

    dp: int = 1
    fsdp: int = -1
    sp: int = 1
    tp: int = 1
    pp: int = 1
    # Number of slices; >1 would put the leading dp axis on DCN, which a
    # GPU host does not have (make_mesh refuses it).
    num_slices: int = 1

    def resolve(self, n_devices: int) -> dict:
        sizes = {"pp": self.pp, "dp": self.dp, "fsdp": self.fsdp,
                 "sp": self.sp, "tp": self.tp}
        wildcards = [a for a, s in sizes.items() if s == -1]
        if len(wildcards) > 1:
            raise ValueError(f"at most one axis may be -1, got {wildcards}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wildcards:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[wildcards[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return sizes


def mesh_shape_for(n_devices: int, config: Optional[MeshConfig] = None):
    config = config or MeshConfig()
    sizes = config.resolve(n_devices)
    return tuple(sizes[a] for a in AXIS_ORDER)


def _mesh_device_type(device_type: Optional[str]) -> str:
    """``"cuda"`` unless the caller asks for ``"cpu"`` (the rule of
    ``ray_tpu_torch.resolve_device``); CUDA that is not there raises."""
    from ray_tpu_torch import resolve_device

    return resolve_device(device_type).type


def _ensure_process_group(device_type: str) -> None:
    """A process group for the mesh: the one ``init_jax_distributed`` (or
    the caller) joined, else one of this process alone (world 1, an
    in-memory store: no port, no network), NCCL for ``"cuda"`` and gloo
    for ``"cpu"``."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = AXIS_ORDER,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``config``'s shape over ``devices``, a sequence
    of global ranks (default: every rank of the process group), with the
    mesh dims named ``axis_names``. ``device_type`` is ``"cuda"`` unless
    the caller asks for ``"cpu"``. Every rank of the process group calls
    it, as every process of a JAX program builds its mesh."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    config = config or MeshConfig()
    if config.num_slices > 1:
        raise ValueError(
            "num_slices > 1 puts dp on DCN across TPU slices; a GPU host "
            "has no DCN (ROADMAP.md, places where the port differs on "
            "purpose)")
    dtype = _mesh_device_type(device_type)
    _ensure_process_group(dtype)
    if dtype == "cuda" and not torch.cuda.is_initialized():
        # DeviceMesh's own guess, made here before CUDA comes up: a
        # worker under a GPU lease sees its one device as 0
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    if devices is None:
        sizes = config.resolve(dist.get_world_size())
        shape = tuple(sizes[a] for a in axis_names)
        return init_device_mesh(dtype, shape,
                                mesh_dim_names=tuple(axis_names))
    ranks = list(devices)
    sizes = config.resolve(len(ranks))
    shape = tuple(sizes[a] for a in axis_names)
    return DeviceMesh(dtype, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def best_effort_mesh(tp: int = 1, sp: int = 1, devices=None,
                     device_type: Optional[str] = None):
    """Mesh that uses all devices: requested tp/sp, remainder on fsdp."""
    import torch.distributed as dist

    if devices is None:
        _ensure_process_group(_mesh_device_type(device_type))
    n = len(devices) if devices is not None else dist.get_world_size()
    tp = math.gcd(tp, n)
    sp = math.gcd(sp, max(1, n // tp))
    return make_mesh(MeshConfig(fsdp=-1, sp=sp, tp=tp), devices=devices,
                     device_type=device_type)


def stage_device_slices(n_stages: int, devices: Sequence):
    """Partition ``devices`` (``torch.device``s, or ranks) into
    ``n_stages`` contiguous equal slices — the per-stage device placement
    for MPMD pipeline parallelism. The pp axis is outermost in
    :data:`AXIS_ORDER`, so a contiguous slice is one neighborhood and the
    only traffic between slices is the stage boundary's hop."""
    devices = list(devices)
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if len(devices) % n_stages:
        raise ValueError(
            f"{len(devices)} devices not divisible into {n_stages} equal "
            f"stage slices")
    per = len(devices) // n_stages
    return [devices[i * per:(i + 1) * per] for i in range(n_stages)]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape alone — axis names and sizes, no devices and no
    process group — for shape and sharding reasoning (the counterpart of
    ``jax.sharding.AbstractMesh``)."""

    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def get_abstract_mesh(n_devices: int, config: Optional[MeshConfig] = None,
                      axis_names: Sequence[str] = AXIS_ORDER):
    """An :class:`AbstractMesh` for shape/sharding reasoning without real
    devices."""
    config = config or MeshConfig()
    sizes = config.resolve(n_devices)
    return AbstractMesh(tuple(sizes[a] for a in axis_names),
                        tuple(axis_names))
