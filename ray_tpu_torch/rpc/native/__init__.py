"""Native (C) codecs for RPC hot paths — built on first import.

The CPython extension is compiled with the system toolchain against this
interpreter's headers (no pybind11 / pip in this image), same build-on-
demand pattern as ``object_store/native/shm_store.cc``. The libraries land
in ``ray_tpu_torch/_build/``, built into a temporary file that replaces the
target, so two workers building at once are safe.
"""

from __future__ import annotations

import importlib.util
import os
import struct
import subprocess
import sysconfig
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
_SO = os.path.join(BUILD_DIR, "_fastspec.so")
_SRC = os.path.join(_DIR, "fastspec.c")
_HDR = os.path.join(_DIR, "fastframe.h")  # shared wire layer (both .so's)
_lock = threading.Lock()
_mod = None
_FAILED = object()  # build attempted and lost — don't re-run gcc per call


def _src_mtime(src: str) -> float:
    """Staleness anchor for a native source: the newest of the .c file and
    the shared fastframe.h it includes — editing the header alone must
    trigger a rebuild or tests measure the wrong code."""
    m = os.path.getmtime(src)
    try:
        m = max(m, os.path.getmtime(_HDR))
    except OSError:
        pass
    return m


def load_fastspec():
    """Returns the _fastspec extension module (building it if stale), or
    None when no compiler is available (pure-pickle fallback). A failed
    build is cached: the hot path must not re-spawn gcc per call."""
    global _mod
    if _mod is not None:
        return None if _mod is _FAILED else _mod
    with _lock:
        if _mod is not None:
            return None if _mod is _FAILED else _mod
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < _src_mtime(_SRC)):
                include = sysconfig.get_paths()["include"]
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = _SO + f".tmp.{os.getpid()}"
                subprocess.run(
                    ["gcc", "-O2", "-fPIC", "-shared", f"-I{include}",
                     "-o", tmp, _SRC],
                    check=True, capture_output=True)
                os.replace(tmp, _SO)
            spec = importlib.util.spec_from_file_location("_fastspec", _SO)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _mod = mod
        except Exception:  # noqa: BLE001 - no compiler / arch mismatch
            _mod = _FAILED
        return None if _mod is _FAILED else _mod


_FL_SO = os.path.join(BUILD_DIR, "_fastloop.so")
_FL_SRC = os.path.join(_DIR, "fastloop.c")
_fl_lock = threading.Lock()
_fl_mod = None


def load_fastloop():
    """Returns the _fastloop extension (C dispatch loop for the actor-call
    hot path — see fastloop.c), or None when it can't be built; a failed
    build is cached so callers fall back to the asyncio path for good."""
    global _fl_mod
    if _fl_mod is not None:
        return None if _fl_mod is _FAILED else _fl_mod
    with _fl_lock:
        if _fl_mod is not None:
            return None if _fl_mod is _FAILED else _fl_mod
        try:
            if (not os.path.exists(_FL_SO)
                    or os.path.getmtime(_FL_SO) < _src_mtime(_FL_SRC)):
                include = sysconfig.get_paths()["include"]
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = _FL_SO + f".tmp.{os.getpid()}"
                subprocess.run(
                    ["gcc", "-O2", "-fPIC", "-shared", "-pthread",
                     f"-I{include}", "-o", tmp, _FL_SRC],
                    check=True, capture_output=True)
                os.replace(tmp, _FL_SO)
            spec = importlib.util.spec_from_file_location("_fastloop",
                                                          _FL_SO)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _fl_mod = mod
        except Exception:  # noqa: BLE001 - no compiler / arch mismatch
            _fl_mod = _FAILED
        return None if _fl_mod is _FAILED else _fl_mod


def _read_blobs(blob: bytes, off: int, n: int):
    blobs = []
    for _ in range(n):
        if off + 4 > len(blob):
            raise ValueError("truncated fastspec buffer")
        (ln,) = struct.unpack_from("<I", blob, off)
        off += 4
        if off + ln > len(blob):
            raise ValueError("truncated fastspec buffer")
        blobs.append(blob[off:off + ln])
        off += ln
    return blobs


def unpack_fastspec(blob: bytes):
    """Decode a v1 (actor-call) fastspec buffer with the C codec when
    available, else a pure-Python reader — a receiver without a compiler
    must still accept fast-path pushes from nodes that have one."""
    mod = load_fastspec()
    if mod is not None:
        return mod.unpack(blob)
    if len(blob) < 21 or blob[:4] != b"RTFS" or blob[4] != 1:
        raise ValueError("not a fastspec v1 buffer")
    seq, num_returns, port = struct.unpack_from("<QII", blob, 5)
    blobs = _read_blobs(blob, 21, 7)
    return (*blobs, seq, num_returns, port)


def unpack_fasttask(blob: bytes):
    """Decode a v2 (normal-task) fastspec buffer, C codec or pure-Python
    fallback (same compiler-less receiver contract as unpack_fastspec)."""
    mod = load_fastspec()
    if mod is not None:
        return mod.unpack_task(blob)
    if len(blob) < 13 or blob[:4] != b"RTFS" or blob[4] != 2:
        raise ValueError("not a fastspec v2 buffer")
    num_returns, port = struct.unpack_from("<II", blob, 5)
    blobs = _read_blobs(blob, 13, 8)
    return (*blobs, num_returns, port)
