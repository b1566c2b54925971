"""RuntimeEnv spec — validated, hashable description of a worker environment.

Reference: ``python/ray/runtime_env/runtime_env.py`` (the ``RuntimeEnv``
dict-like with known fields) and the plugin field semantics from
``python/ray/_private/runtime_env/``. Supported fields:

- ``env_vars``: {str: str} merged into the worker process environment.
- ``working_dir``: local directory (or ``.zip``) copied into the session and
  used as the worker's cwd; also prepended to ``PYTHONPATH`` so task code
  can import modules shipped alongside the driver.
- ``py_modules``: list of local module directories / zips, each staged and
  prepended to ``PYTHONPATH``.
- ``pip``: list of requirement strings (reference plugin:
  ``python/ray/_private/runtime_env/pip.py``). With ``pip_find_links``
  set, requirements are REALLY installed — ``pip install --no-index
  --find-links <dirs> --target <staged pylibs>`` — and the staged tree is
  prepended to the worker's ``PYTHONPATH`` ahead of system site-packages,
  so two jobs can run CONFLICTING versions of the same package
  concurrently. Dependency isolation without a per-env virtualenv is a
  deliberate redesign: a venv swaps the interpreter and forfeits the
  forkserver warm boot; path-precedence isolation gives the same
  version-conflict guarantee while env-keyed workers exec a fresh
  interpreter anyway. Without ``pip_find_links`` (no package source — this
  image has no network egress), requirements that are already importable
  are accepted, anything else raises :class:`RuntimeEnvError` — matching
  the reference's RuntimeEnvSetupError contract.
- ``pip_find_links``: list of local directories holding wheels/sdists
  (the offline package source for ``pip``).
- ``config``: {"setup_timeout_seconds": float} (validation only).

The env hash keys worker pools (reference: worker_pool.h keyed by runtime
env hash) — two tasks share idle workers only when their materialized
environment is byte-identical.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


class RuntimeEnvError(Exception):
    """Environment could not be validated or materialized; tasks using it
    fail with this error rather than running in the wrong env."""


_KNOWN_FIELDS = {"env_vars", "working_dir", "py_modules", "pip",
                 "pip_find_links", "config"}


class RuntimeEnv(dict):
    """Dict subclass so user code can pass a plain dict anywhere."""

    def __init__(self, *, env_vars: Optional[Dict[str, str]] = None,
                 working_dir: Optional[str] = None,
                 py_modules: Optional[List[str]] = None,
                 pip: Optional[List[str]] = None,
                 pip_find_links: Optional[List[str]] = None,
                 config: Optional[Dict[str, Any]] = None):
        super().__init__()
        if env_vars:
            self["env_vars"] = dict(env_vars)
        if working_dir is not None:
            self["working_dir"] = working_dir
        if py_modules:
            self["py_modules"] = list(py_modules)
        if pip:
            self["pip"] = list(pip)
        if pip_find_links:
            self["pip_find_links"] = list(pip_find_links)
        if config:
            self["config"] = dict(config)
        validate(self)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["RuntimeEnv"]:
        if not d:
            return None
        return cls(env_vars=d.get("env_vars"), working_dir=d.get("working_dir"),
                   py_modules=d.get("py_modules"), pip=d.get("pip"),
                   pip_find_links=d.get("pip_find_links"),
                   config=d.get("config"))


def validate(env: dict) -> None:
    unknown = set(env) - _KNOWN_FIELDS
    if unknown:
        raise RuntimeEnvError(f"unknown runtime_env fields: {sorted(unknown)}")
    ev = env.get("env_vars") or {}
    if not all(isinstance(k, str) and isinstance(v, str) for k, v in ev.items()):
        raise RuntimeEnvError("env_vars must be {str: str}")
    wd = env.get("working_dir")
    if wd is not None and not isinstance(wd, str):
        raise RuntimeEnvError("working_dir must be a path string")
    for mod in env.get("py_modules") or []:
        if not isinstance(mod, str):
            raise RuntimeEnvError("py_modules entries must be path strings")
    for req in env.get("pip") or []:
        if not isinstance(req, str):
            raise RuntimeEnvError("pip entries must be requirement strings")
    for fl in env.get("pip_find_links") or []:
        if not isinstance(fl, str):
            raise RuntimeEnvError("pip_find_links entries must be path strings")
    if env.get("pip_find_links") and not env.get("pip"):
        raise RuntimeEnvError("pip_find_links requires pip requirements")


def merge(base: Optional[dict], override: Optional[dict]) -> Optional[dict]:
    """Job-default env + per-task override (reference semantics: child
    env_vars update the parent's; other fields replace wholesale)."""
    if not base:
        return dict(override) if override else None
    if not override:
        return dict(base)
    out = dict(base)
    for k, v in override.items():
        if k == "env_vars":
            ev = dict(base.get("env_vars") or {})
            ev.update(v or {})
            out["env_vars"] = ev
        else:
            out[k] = v
    return out


_HASH_TTL_S = 2.0
_hash_cache: Dict[str, tuple] = {}
_hash_lock = threading.Lock()


def env_hash(env: Optional[dict]) -> Optional[str]:
    """Stable content hash used as the worker-pool key. Local paths are
    hashed by their resolved path + mtime tree signature so an edited
    working_dir yields a fresh environment.

    Tree-walking every file is too hot for per-task submission (a 10k-task
    storm over one env must not stat the tree 10k times), so results are
    memoized for a short TTL — an edit is picked up within _HASH_TTL_S, and
    a task storm pays one walk per window."""
    if not env:
        return None
    cache_key = json.dumps(env, sort_keys=True, default=str)
    now = time.monotonic()
    with _hash_lock:
        hit = _hash_cache.get(cache_key)
        if hit is not None and now - hit[1] < _HASH_TTL_S:
            return hit[0]
    canon: Dict[str, Any] = {}
    for k in sorted(env):
        v = env[k]
        if k in ("working_dir",) and isinstance(v, str):
            canon[k] = [v, _tree_signature(v)]
        elif k in ("py_modules", "pip_find_links"):
            # a wheel dropped into a find-links dir must yield a fresh env
            canon[k] = [[m, _tree_signature(m)] for m in v]
        else:
            canon[k] = v
    blob = json.dumps(canon, sort_keys=True, default=str).encode()
    out = hashlib.sha1(blob).hexdigest()[:16]
    with _hash_lock:
        _hash_cache[cache_key] = (out, now)
        if len(_hash_cache) > 1024:
            _hash_cache.clear()
    return out


def _tree_signature(path: str) -> str:
    """Cheap change-detection: (relpath, size, mtime_ns) of every file."""
    if not os.path.exists(path):
        return "missing"
    if os.path.isfile(path):
        st = os.stat(path)
        return f"{st.st_size}:{st.st_mtime_ns}"
    items = []
    for root, _dirs, files in os.walk(path):
        for f in sorted(files):
            fp = os.path.join(root, f)
            try:
                st = os.stat(fp)
            except OSError:
                continue
            items.append(f"{os.path.relpath(fp, path)}:{st.st_size}:{st.st_mtime_ns}")
    return hashlib.sha1("|".join(items).encode()).hexdigest()[:16]
