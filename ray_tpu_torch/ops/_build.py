"""Build and load the package's CUDA kernels.

Each source ``ray_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface,
``ray_tpu_torch/_build/lib<name>.so``, and loaded with ``ctypes``. A
library is (re)built at first use in a process whenever it is missing or
older than its source, so a fresh checkout builds itself. Nothing here
runs at import time: the CPU-only tests import every module. ``ptxas``
reports each kernel's registers and spills (``-Xptxas=-v``); the report of
the last build in this process is kept in ``LOGS`` and read with
:func:`kernel_resources`.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of ray_tpu_torch "
                       "are compiled at first use and need the CUDA toolkit")


def _paths(name: str):
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return (not os.path.exists(lib)
            or os.path.getmtime(lib) < os.path.getmtime(src))


def _start(name: str):
    """Start nvcc on one source, writing to a temporary file that replaces
    the library atomically once the build succeeds."""
    src, lib = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp.{os.getpid()}"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, lib


def build(names: Iterable[str]) -> List[str]:
    """Compile every stale library among ``names``, all nvcc processes
    started together. Returns the names that were rebuilt; raises with the
    compiler's output if any build fails."""
    started = [(n, *_start(n)) for n in names if _stale(n)]
    errors = []
    for name, proc, tmp, lib in started:
        out, _ = proc.communicate()
        LOGS[name] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
            if os.path.exists(tmp):
                os.unlink(tmp)
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [s[0] for s in started]


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            _libs[name] = lib
        return lib


def kernel_resources(log: str) -> Dict[str, dict]:
    """Per compiled kernel (mangled name) of a ptxas ``-v`` report:
    registers per thread, spill stores and loads in bytes."""
    res: Dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            res[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            res[name]["spill_stores"] = int(m.group(1))
            res[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            res[name]["registers"] = int(m.group(1))
    return res
