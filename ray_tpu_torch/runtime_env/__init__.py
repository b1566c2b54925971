"""Runtime environments: per-task/actor/job process environments.

Reference: ``python/ray/_private/runtime_env/`` (plugins + agent) — here a
spec (:class:`RuntimeEnv`), a per-raylet materializer (:class:`RuntimeEnvAgent`)
and worker-pool keying by env hash.
"""

from .runtime_env import RuntimeEnv, RuntimeEnvError, env_hash
from .agent import RuntimeEnvAgent, WorkerEnvContext

__all__ = [
    "RuntimeEnv", "RuntimeEnvError", "env_hash",
    "RuntimeEnvAgent", "WorkerEnvContext",
]
