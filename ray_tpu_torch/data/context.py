"""DataContext — per-driver execution configuration for Datasets (port of
``ray_tpu/data/context.py``: the same flags and env names).

Reference: ``python/ray/data/context.py`` (``DataContext.get_current()``):
the knobs the streaming executor and operators consult. The port keeps
the same access pattern (a process-wide current context, overridable per
dataset) with the knobs that exist in this executor:

- ``max_inflight_blocks`` — the streaming window: how many block chains
  may be in flight at once (driver-side backpressure).
- ``op_concurrency_cap`` — per-operator budget: at most this many
  concurrent tasks per map stage (None = bounded only by the window).
  This is the reference's per-operator resource-budget/backpressure
  policy reduced to its operative effect in a ref-chaining executor.
- ``default_batch_size`` — ``iter_batches``/``map_batches`` default.
- ``actor_pool_size`` / ``max_tasks_in_flight_per_actor`` — defaults for
  ``ActorPoolStrategy`` stages.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional


def _env_flag(name: str, default: bool) -> bool:
    import os

    v = os.environ.get(name)
    return default if v is None else v not in ("0", "false", "off", "")


@dataclasses.dataclass
class DataContext:
    max_inflight_blocks: int = 16
    op_concurrency_cap: Optional[int] = None
    # --- streaming shuffle engine (data/shuffle.py) ---
    # output partitions for hash-shuffled groupbys (the input block count
    # is unknown when the upstream is consumed as a stream)
    shuffle_partitions: int = 8
    # reducer actors each multiplex partitions p % actors == index — n
    # output partitions must not cost n processes
    shuffle_reducer_actors: int = 4
    # map-stage admission window (None = max_inflight_blocks): bounds
    # how many fused partition objects are in flight, which is what
    # bounds the shuffle's object-plane footprint (and so its spill)
    shuffle_map_window: Optional[int] = None
    # inputs with fewer blocks than this take the legacy task engine
    # even when streaming is on: reducer ACTORS pay ~100ms of spawn +
    # reap per shuffle, which dwarfs a small shuffle's entire runtime
    # (and unit-test suites run hundreds of tiny shuffles) — the
    # streaming engine's wins are object-count, overlap, and windowed
    # memory, all properties of LARGE inputs.  Outputs are bit-identical
    # either way (parity-tested).
    streaming_shuffle_min_blocks: int = 12
    # False (or env RT_streaming_shuffle=0) falls back to the legacy
    # two-barrier task engine — bit-identical outputs, kept for parity
    use_streaming_shuffle: bool = dataclasses.field(
        default_factory=lambda: _env_flag("RT_streaming_shuffle", True))
    # reads split files bigger than this into multiple blocks (parquet:
    # one read task per row-group chunk — reference dynamic block
    # splitting / ParquetDatasource row-group planning)
    target_max_block_size: int = 16 * 1024 * 1024
    default_batch_size: int = 256
    actor_pool_size: int = 2
    max_tasks_in_flight_per_actor: int = 2
    # collect per-stage wall/rows stats into Dataset.stats()
    enable_stats: bool = True

    _current: "Optional[DataContext]" = None
    _lock = threading.Lock()

    @classmethod
    def get_current(cls) -> "DataContext":
        with cls._lock:
            if cls._current is None:
                cls._current = cls()
            return cls._current

    @classmethod
    def set_current(cls, ctx: "DataContext") -> None:
        with cls._lock:
            cls._current = ctx
