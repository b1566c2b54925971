"""Utilities: state API, metrics, queue/actor-pool helpers, tracing,
export events, usage, profiling."""

from ray_tpu_torch.util import state  # noqa: F401
from ray_tpu_torch.util.actor_pool import ActorPool  # noqa: F401
from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram  # noqa: F401
from ray_tpu_torch.util.queue import Empty, Full, Queue  # noqa: F401
