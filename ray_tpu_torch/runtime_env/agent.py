"""RuntimeEnvAgent — materializes runtime envs on a node.

Reference: ``python/ray/_private/runtime_env/agent/runtime_env_agent.py:165``
(GetOrCreateRuntimeEnv / DeleteRuntimeEnvIfPossible with per-env refcounts
and a URI cache). Here the agent lives inside the raylet process (no
separate daemon needed — setup is file staging, not package downloads) and
returns a :class:`WorkerEnvContext` the worker pool applies at fork time.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import shutil
import threading
import zipfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .runtime_env import RuntimeEnvError, env_hash, validate

logger = logging.getLogger(__name__)


@dataclass
class WorkerEnvContext:
    """Everything the worker fork needs to run inside the env."""

    env_key: Optional[str] = None
    env_vars: Dict[str, str] = field(default_factory=dict)
    cwd: Optional[str] = None
    pythonpath_prepend: List[str] = field(default_factory=list)

    def apply(self, base_env: Dict[str, str]) -> Dict[str, str]:
        out = dict(base_env)
        out.update(self.env_vars)
        if self.pythonpath_prepend:
            existing = out.get("PYTHONPATH", "")
            parts = list(self.pythonpath_prepend)
            if existing:
                parts.append(existing)
            out["PYTHONPATH"] = os.pathsep.join(parts)
        return out


class RuntimeEnvAgent:
    def __init__(self, session_dir: str):
        self._root = os.path.join(session_dir, "runtime_envs")
        os.makedirs(self._root, exist_ok=True)
        self._lock = threading.Lock()
        self._cache: Dict[str, WorkerEnvContext] = {}
        self._refs: Dict[str, int] = {}

    def get_or_create(self, env: Optional[dict]) -> WorkerEnvContext:
        """Materialize (or fetch cached) the env. Raises RuntimeEnvError on
        anything that cannot be satisfied — the caller fails the lease, not
        the node. References are NOT taken here: a holder (worker process,
        job driver) calls :meth:`acquire` when it starts using the env and
        :meth:`release` when it exits."""
        if not env:
            return WorkerEnvContext()
        validate(env)
        key = env_hash(env)
        with self._lock:
            ctx = self._cache.get(key)
            if ctx is not None:
                return ctx
        ctx = self._materialize(key, env)
        with self._lock:
            self._cache[key] = ctx
            self._refs.setdefault(key, 0)
        return ctx

    def acquire(self, key: Optional[str]) -> None:
        """One live holder (a forked worker / running job driver)."""
        if key is None:
            return
        with self._lock:
            self._refs[key] = self._refs.get(key, 0) + 1

    def release(self, key: Optional[str]) -> None:
        """Drop one holder; unreferenced envs stay cached (cheap disk)
        until evict_unused() — matching the reference's soft URI cache."""
        if key is None:
            return
        with self._lock:
            if key in self._refs:
                self._refs[key] = max(0, self._refs[key] - 1)

    def evict_unused(self) -> int:
        """Delete staged files of envs with zero references. Returns count."""
        n = 0
        with self._lock:
            for key in [k for k, r in self._refs.items() if r == 0]:
                self._cache.pop(key, None)
                self._refs.pop(key, None)
                shutil.rmtree(os.path.join(self._root, key),
                              ignore_errors=True)
                n += 1
        return n

    # ------------------------------------------------------------- internals
    def _materialize(self, key: str, env: dict) -> WorkerEnvContext:
        """Stage-then-rename: the env is built in a private tmp dir and
        atomically renamed to its content-addressed location. The key hashes
        every file's (size, mtime) — same key ⇒ same content — so an
        existing staged dir is ALWAYS safe to reuse, never deleted/rebuilt:
        concurrent materializations (two threads, or the raylet's and the
        job manager's agent sharing one session dir) race benignly on the
        rename, and live workers whose cwd is inside a staged dir never
        have it pulled out from under them."""
        reqs = env.get("pip") or []
        find_links = env.get("pip_find_links") or []
        if reqs and not find_links:
            # no package source (zero-egress image): gate on importability
            self._check_pip(reqs)
        stage = os.path.join(self._root, key)
        ready = os.path.join(stage, ".ready")
        if not os.path.exists(ready):
            tmp = f"{stage}.tmp.{os.getpid()}.{threading.get_ident()}"
            os.makedirs(tmp, exist_ok=True)
            try:
                wd = env.get("working_dir")
                if wd is not None:
                    self._stage_path(wd, os.path.join(tmp, "working_dir"))
                for i, mod in enumerate(env.get("py_modules") or []):
                    self._stage_path(mod, os.path.join(tmp, f"py_module_{i}"))
                if reqs and find_links:
                    self._pip_install(env, reqs, find_links,
                                      os.path.join(tmp, "pylibs"))
                with open(os.path.join(tmp, ".ready"), "w") as f:
                    f.write(key)
                try:
                    os.rename(tmp, stage)
                    logger.info("runtime env %s staged at %s", key, stage)
                except OSError:
                    # another materializer won the rename: reuse theirs
                    shutil.rmtree(tmp, ignore_errors=True)
            except Exception:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
        ctx = WorkerEnvContext(env_key=key,
                               env_vars=dict(env.get("env_vars") or {}))
        if reqs and find_links:
            # pylibs FIRST: installed requirement versions must shadow
            # system site-packages (the version-isolation guarantee)
            ctx.pythonpath_prepend.append(os.path.join(stage, "pylibs"))
        if env.get("working_dir") is not None:
            target = os.path.join(stage, "working_dir")
            ctx.cwd = target
            ctx.pythonpath_prepend.append(target)
        for i in range(len(env.get("py_modules") or [])):
            # a module DIRECTORY is importable from its parent; a staged
            # tree of plain files is importable from the target itself
            ctx.pythonpath_prepend.append(
                os.path.join(stage, f"py_module_{i}"))
        return ctx

    @staticmethod
    def _stage_path(src: str, target: str):
        if not os.path.exists(src):
            raise RuntimeEnvError(f"runtime_env path does not exist: {src}")
        if src.endswith(".zip") and os.path.isfile(src):
            os.makedirs(target, exist_ok=True)
            with zipfile.ZipFile(src) as zf:
                zf.extractall(target)
        elif os.path.isdir(src):
            shutil.copytree(src, target)
        else:
            raise RuntimeEnvError(
                f"runtime_env path must be a directory or .zip: {src}")

    @staticmethod
    def _pip_install(env: dict, reqs: List[str], find_links: List[str],
                     target: str):
        """Offline dependency isolation (reference plugin:
        python/ray/_private/runtime_env/pip.py): install from LOCAL
        wheel/sdist directories into a per-env --target tree that the
        worker's PYTHONPATH prepends ahead of system site-packages.
        Version conflicts between envs cannot collide — each env reads
        its own tree. No venv on purpose (see runtime_env.py docstring)."""
        import subprocess
        import sys

        for fl in find_links:
            if not os.path.isdir(fl):
                raise RuntimeEnvError(
                    f"pip_find_links dir does not exist: {fl}")
        timeout = float((env.get("config") or {})
                        .get("setup_timeout_seconds", 300.0))
        cmd = [sys.executable, "-m", "pip", "install", "--no-index",
               "--disable-pip-version-check", "--quiet",
               "--target", target]
        for fl in find_links:
            cmd += ["--find-links", fl]
        cmd += list(reqs)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout)
        except subprocess.TimeoutExpired as e:
            raise RuntimeEnvError(
                f"pip install timed out after {timeout:.0f}s") from e
        if proc.returncode != 0:
            raise RuntimeEnvError(
                "pip install failed (offline --no-index install from "
                f"{find_links}): {proc.stderr.strip()[-800:]}")

    @staticmethod
    def _check_pip(reqs: List[str]):
        """No network egress on this image: a requirement is satisfiable only
        if the distribution is already importable. Anything else must fail
        the env (reference: RuntimeEnvSetupError), never silently run without
        the dependency."""
        for req in reqs:
            name = (req.split(";")[0].split("==")[0].split(">=")[0]
                    .split("<=")[0].split("[")[0].strip())
            mod = name.replace("-", "_")
            if importlib.util.find_spec(mod) is None:
                raise RuntimeEnvError(
                    f"pip requirement {req!r} is not installed and this "
                    "environment has no package index access")
