"""Channels: preallocated transports for compiled actor graphs.

Reference: ``python/ray/experimental/channel/shared_memory_channel.py``
(mutable shm buffer channel), ``torch_tensor_accelerator_channel.py``
(device-tensor channel). Here:

- :class:`ShmChannel` — native mutable shared-memory channel
  (``object_store/native/shm_channel.cc``): the writer rewrites one buffer
  after every reader has consumed the previous value (depth-1
  backpressure, which is exactly the per-stage buffering a pipeline
  wants). Payloads are pickled values; channel ends are picklable by NAME
  and lazily opened per process.
- :class:`DeviceBufferChannel` — carries ``torch.Tensor``s between GPU
  actors: a tensor is staged to the host on write (framed as its raw
  bytes, shape, torch dtype name and device type) and placed again on
  read: a CUDA tensor on the reader's leased GPU, a CPU tensor on the
  CPU. The hop stays host-staged, as the reference's CPU-mediated path
  for non-p2p transports is; moving tensors between processes by CUDA
  IPC is later speed work.
"""

from __future__ import annotations

import ctypes
import os
import pickle
import sys
from typing import Any, Optional

from ray_tpu_torch.common import faults
from ray_tpu_torch.object_store import shm as _shm

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    # object_store/native/shm_channel.cc, beside the object store's source
    lib = ctypes.CDLL(_shm.build_native("shm_channel.cc", "libshm_channel.so"))
    lib.rtc_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                               ctypes.c_uint64]
    lib.rtc_create.restype = ctypes.c_int
    lib.rtc_open.argtypes = [ctypes.c_char_p]
    lib.rtc_open.restype = ctypes.c_int
    lib.rtc_write.argtypes = [ctypes.c_int, ctypes.c_char_p,
                              ctypes.c_uint64, ctypes.c_int64]
    lib.rtc_write.restype = ctypes.c_int
    lib.rtc_read.argtypes = [ctypes.c_int, ctypes.c_uint64, ctypes.c_char_p,
                             ctypes.c_uint64,
                             ctypes.POINTER(ctypes.c_uint64),
                             ctypes.c_int64]
    lib.rtc_read.restype = ctypes.c_int64
    lib.rtc_close.argtypes = [ctypes.c_int]
    lib.rtc_close.restype = ctypes.c_int
    lib.rtc_unlink.argtypes = [ctypes.c_char_p]
    lib.rtc_unlink.restype = ctypes.c_int
    _lib = lib
    return lib


class ChannelClosed(Exception):
    pass


# read_nowait()'s "nothing new" sentinel: distinguishes an empty poll
# from a channel legitimately carrying None. Identity-compared, so it is
# meaningful only within one process (polling loops, not wire payloads).
NO_MESSAGE = object()


class ShmChannel:
    """One named mutable shm channel end; both ends are the same object,
    distinguished by which methods you call. Picklable by name."""

    def __init__(self, name: str, capacity: int = 4 * 1024 * 1024,
                 num_readers: int = 1, _create: bool = True):
        self.name = name
        self.capacity = capacity
        self.num_readers = num_readers
        self._h: Optional[int] = None
        self._create = _create
        self._last_version = 0
        self._buf = None

    def _handle(self) -> int:
        if self._h is None:
            lib = _load()
            h = lib.rtc_create(self.name.encode(), self.capacity,
                               self.num_readers) if self._create \
                else lib.rtc_open(self.name.encode())
            if h < 0:
                raise OSError(-h, f"channel {self.name}: {os.strerror(-h)}")
            self._h = h
            self._buf = ctypes.create_string_buffer(self.capacity)
        return self._h

    def write(self, value: Any, timeout_s: float = 60.0) -> None:
        faults.fault_point("graph.channel.write")
        blob = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
        rc = _load().rtc_write(self._handle(), blob, len(blob),
                               int(timeout_s * 1000))
        if rc == -32:  # EPIPE
            raise ChannelClosed(self.name)
        if rc == -11:  # EAGAIN
            raise TimeoutError(f"channel {self.name} write timed out")
        if rc != 0:
            raise OSError(-rc, os.strerror(-rc))

    def read(self, timeout_s: float = 60.0) -> Any:
        faults.fault_point("graph.channel.read")
        out_len = ctypes.c_uint64()
        v = _load().rtc_read(self._handle(), self._last_version, self._buf,
                             self.capacity, ctypes.byref(out_len),
                             int(timeout_s * 1000))
        if v == -32:
            raise ChannelClosed(self.name)
        if v == -11:
            raise TimeoutError(f"channel {self.name} read timed out")
        if v < 0:
            raise OSError(-v, os.strerror(-v))
        self._last_version = int(v)
        # zero-copy view into the scratch buffer (raw[:n] would copy again)
        return pickle.loads(memoryview(self._buf)[:out_len.value])

    def read_nowait(self) -> Any:
        """Non-blocking poll: the latest unseen value, or
        :data:`NO_MESSAGE` when the writer hasn't published a new
        version since our last read. ``ChannelClosed`` still raises —
        a poller must see the closure cascade, not spin on it."""
        try:
            return self.read(timeout_s=0.0)
        except TimeoutError:
            return NO_MESSAGE

    def close(self):
        if self._h is not None:
            _load().rtc_close(self._h)

    def unlink(self):
        try:
            _load().rtc_unlink(self.name.encode())
        except Exception:  # noqa: BLE001
            pass

    def __reduce__(self):
        # the receiving process OPENS (never re-creates) the segment
        return (_open_channel, (self.name, self.capacity, self.num_readers))


def _open_channel(name, capacity, num_readers):
    return ShmChannel(name, capacity, num_readers, _create=False)


def _is_tensor(value) -> bool:
    torch = sys.modules.get("torch")  # a tensor exists only once it loaded
    return torch is not None and isinstance(value, torch.Tensor)


def _frame_tensor(t) -> dict:
    """A tensor as the channel carries it: its bytes, shape, torch dtype
    name and device type. A CUDA tensor is staged to the host by a
    blocking ``.cpu()``, which copies after the work queued before it on
    the default stream, from whichever thread writes. numpy has no
    bfloat16, so the bytes travel as uint8 and the dtype by name."""
    import torch

    host = t.detach()
    if host.device.type != "cpu":
        host = host.cpu()
    host = host.resolve_conj().resolve_neg().contiguous().reshape(-1)
    return {"shape": tuple(t.shape),
            "dtype": str(t.dtype).removeprefix("torch."),
            "device": t.device.type,
            "data": host.view(torch.uint8).numpy()}


def _unframe_tensor(msg: dict, device=None):
    """The tensor of :func:`_frame_tensor`'s frame, on ``device`` when
    given, else by the device object store's rule
    (``object_store/device.py::_target_device``): a CUDA tensor on this
    process's GPU (raises where it sees none), a CPU tensor on the CPU."""
    import warnings

    import torch

    from ray_tpu_torch.object_store.device import _target_device

    target = (torch.device(device) if device is not None
              else _target_device(msg["device"]))
    dtype = getattr(torch, msg["dtype"])
    raw = msg["data"]
    if target.type == "cpu" and not raw.flags.writeable:
        raw = raw.copy()  # the reader owns a writable tensor
    with warnings.catch_warnings():
        # a read-only frame is copied by the move to the device below
        warnings.simplefilter("ignore", UserWarning)
        flat = torch.from_numpy(raw)
    return flat.view(dtype).reshape(msg["shape"]).to(target)


class DeviceBufferChannel:
    """Channel for ``torch.Tensor``s between GPU actors: host-staged
    transfer with placement on the reader's device (reference
    torch_tensor_accelerator_channel.py's CPU-mediated fallback path)."""

    def __init__(self, name: str, capacity: int = 64 * 1024 * 1024,
                 num_readers: int = 1, _create: bool = True):
        self._ch = ShmChannel(name, capacity, num_readers, _create=_create)

    def _handle(self) -> int:
        return self._ch._handle()

    def write(self, value, timeout_s: float = 60.0) -> None:
        if not _is_tensor(value):
            # non-tensor payload (e.g. a pipeline _StageError marker):
            # pickled fallback so compiled device pipelines can still
            # shuttle control/error values through the same edge
            self._ch.write({"pickled": pickle.dumps(value)}, timeout_s)
            return
        self._ch.write(_frame_tensor(value), timeout_s)

    def read(self, timeout_s: float = 60.0, device=None):
        msg = self._ch.read(timeout_s)
        if "pickled" in msg:
            return pickle.loads(msg["pickled"])
        return _unframe_tensor(msg, device)

    def close(self):
        self._ch.close()

    def unlink(self):
        self._ch.unlink()

    def __reduce__(self):
        ch = self._ch
        return (_open_device_channel,
                (ch.name, ch.capacity, ch.num_readers))


def _open_device_channel(name, capacity, num_readers):
    return DeviceBufferChannel(name, capacity, num_readers, _create=False)
