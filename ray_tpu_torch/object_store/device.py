"""Device-resident objects: ``put``/``get`` for ``torch.Tensor``s that stay
on their device instead of round-tripping through host serialization.

Reference: ``python/ray/experimental/gpu_object_manager/``
(``gpu_object_manager.py:50`` GPUObjectManager, ``gpu_object_store.py``):
"tensor transport" for regular ``ray.put``/task args — tensors stay on
the producing worker's device, the owner triggers an out-of-band
transfer when a consumer on another worker needs them
(``trigger_out_of_band_tensor_transfer:183``). The tiers are the JAX
package's:

- same process: ``get`` returns the *same* ``torch.Tensor`` — zero copies,
  zero host traffic (``data_ptr`` equal).
- cross process: the owner stages each tensor to host
  (:meth:`DeviceObjectStore.stage_to_host`, one device-to-host copy a
  leaf) and ships it through the ordinary zero-copy object plane (framed
  pickle-5 over shm/RPC); the consumer restores it onto its own device of
  the same type (:func:`restore_on_device`). One host hop.
- a CUDA tensor got by a process that sees no GPU raises; it is never
  handed back as a CPU tensor.

Values may be arbitrary pytrees (``torch.utils._pytree``); every
``torch.Tensor`` leaf stays on its device, other leaves ride along
untouched. torch is never imported here: a value that holds a tensor was
made by a process that has imported it already.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DeviceObjectMarker:
    """What the object plane stores/ships INSTEAD of the tensor bytes: a
    pointer to the process holding the device value plus shape/dtype/
    device metadata (reference: the GPU-object metadata travelling in
    place of the tensor, gpu_object_manager.py). Resolving a marker is the
    out-of-band transfer trigger."""

    object_id: bytes
    holder: Tuple[str, int]  # RPC address of the process with the value
    spec: Tuple  # ((shape, dtype, device type), ...) of the tensor leaves


@dataclasses.dataclass(frozen=True)
class HostTensor:
    """A staged leaf: the tensor's host copy and the device type it must
    be restored onto."""

    tensor: Any  # a CPU torch.Tensor
    device_type: str


def _torch():
    return sys.modules.get("torch")


def _tensor_leaves(value: Any) -> list:
    torch = _torch()
    if torch is None:
        return []
    from torch.utils import _pytree

    return [x for x in _pytree.tree_leaves(value)
            if isinstance(x, torch.Tensor)]


def is_device_value(value: Any) -> bool:
    """True if the value contains at least one torch.Tensor leaf (worth
    keeping on device)."""
    return bool(_tensor_leaves(value))


def spec_of(value: Any) -> List[Tuple[Tuple[int, ...], str, str]]:
    """(shape, dtype, device type) of each tensor leaf — shipped in the
    marker so consumers can plan placement without fetching."""
    return [(tuple(x.shape), str(x.dtype).removeprefix("torch."),
             x.device.type) for x in _tensor_leaves(value)]


class DeviceObjectStore:
    """Per-process map: object id -> device-resident pytree."""

    def __init__(self) -> None:
        self._objects: Dict[bytes, Any] = {}
        self._lock = threading.Lock()

    def put(self, object_id: bytes, value: Any) -> None:
        with self._lock:
            self._objects[object_id] = value

    def get(self, object_id: bytes) -> Optional[Any]:
        with self._lock:
            return self._objects.get(object_id)

    def contains(self, object_id: bytes) -> bool:
        with self._lock:
            return object_id in self._objects

    def free(self, object_id: bytes) -> None:
        with self._lock:
            self._objects.pop(object_id, None)

    def stage_to_host(self, object_id: bytes) -> Optional[Any]:
        """Owner-side out-of-band step: each tensor leaf -> a
        :class:`HostTensor` (one device-to-host copy a leaf; a CPU leaf
        is shipped as it is), leaving the device copy in place. The
        result serializes through the zero-copy object plane."""
        with self._lock:
            value = self._objects.get(object_id)
        if value is None:
            return None
        torch = _torch()
        if torch is None:
            return value
        from torch.utils import _pytree

        return _pytree.tree_map(
            lambda x: HostTensor(x.detach().cpu(), x.device.type)
            if isinstance(x, torch.Tensor) else x, value)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            vals = list(self._objects.values())
        nbytes = sum(x.numel() * x.element_size()
                     for v in vals for x in _tensor_leaves(v))
        return {"num_objects": len(vals), "device_bytes": nbytes}


def _target_device(device_type: str):
    torch = _torch()
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            import os

            raise RuntimeError(
                "the device object holds a CUDA tensor, and this process "
                "sees no GPU (CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}); request "
                "num_gpus for the task or actor that gets it")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def restore_on_device(host_value: Any) -> Any:
    """Consumer-side: place staged host tensors onto this process's device
    of the type they were staged from; other leaves pass through."""
    torch = _torch()
    if torch is None:  # no tensor was unpickled here, so none was staged
        return host_value
    from torch.utils import _pytree

    return _pytree.tree_map(
        lambda x: x.tensor.to(_target_device(x.device_type))
        if isinstance(x, HostTensor) else x, host_value)
