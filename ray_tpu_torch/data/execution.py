"""Streaming execution for Datasets (port of ``ray_tpu/data/execution.py``).

Reference: ``python/ray/data/_internal/execution/streaming_executor.py:53``
(pull-based operator topology with per-operator resource budgets and
backpressure), ``operators/actor_pool_map_operator.py`` (stateful UDFs on an
actor pool), ``operators/hash_shuffle.py`` (distributed shuffle).

Design:

- :class:`StreamingExecutor` drives a block-granular pipeline: source blocks
  are read and pushed through the chained map stages as independent task
  chains; at most ``max_inflight`` block-chains are outstanding, and results
  are yielded as soon as any chain completes. Consumption is a generator —
  a dataset larger than driver memory streams through, one bounded window
  of blocks at a time (blocks live in the object plane, not the driver).
- :class:`ActorPool` executes map stages marked with
  :class:`ActorPoolStrategy`: the UDF (often a class with expensive
  ``__init__``, e.g. a model) is constructed ONCE per pool actor and blocks
  are routed to the least-loaded actor.
- Shuffles are distributed map/reduce: every input block is hash/random/
  range-partitioned into ``n`` sub-blocks (one task per block,
  ``num_returns=n``), and one reduce task per output partition concatenates
  its column slices — no single-task materialization of the whole dataset
  (the round-1 ``_AllToAll`` weakness).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.data import block as B


@dataclasses.dataclass
class ActorPoolStrategy:
    """compute= argument for map_batches (reference ActorPoolStrategy).
    Defaults come from :class:`~ray_tpu_torch.data.context.DataContext`."""

    size: Optional[int] = None
    max_tasks_in_flight_per_actor: Optional[int] = None

    def __post_init__(self):
        from ray_tpu_torch.data.context import DataContext

        ctx = DataContext.get_current()
        if self.size is None:
            self.size = ctx.actor_pool_size
        if self.max_tasks_in_flight_per_actor is None:
            self.max_tasks_in_flight_per_actor = \
                ctx.max_tasks_in_flight_per_actor


class ActorPool:
    """Least-loaded routing over UDF actors (reference
    actor_pool_map_operator.py). ``ray_remote_args`` are the actors'
    options: ``{"num_gpus": 1}`` gives each pool actor a GPU lease (a fresh
    worker that sees its grant as ``CUDA_VISIBLE_DEVICES``), where the JAX
    package's pool takes ``num_tpus``."""

    def __init__(self, fn: Callable, strategy: ActorPoolStrategy,
                 ray_remote_args: Optional[dict] = None):
        import cloudpickle

        import ray_tpu_torch as rt

        self._strategy = strategy
        remote_cls = rt.remote(_UdfActor)
        opts = dict(ray_remote_args or {})
        opts.setdefault("num_cpus", 0)
        # serial execution per actor: stateful UDFs are not thread-safe;
        # max_tasks_in_flight_per_actor bounds QUEUED work (routing),
        # never concurrent threads inside the UDF
        opts.setdefault("max_concurrency", 1)
        blob = cloudpickle.dumps(fn)
        self._actors = [remote_cls.options(**opts).remote(blob)
                        for _ in range(strategy.size)]
        self._load = [0] * len(self._actors)

    def submit(self, block_ref):
        import ray_tpu_torch as rt
        from ray_tpu_torch.core_worker.worker import CoreWorker

        idx = min(range(len(self._actors)), key=lambda i: self._load[i])
        self._load[idx] += 1
        ref = self._actors[idx].run.remote(block_ref)

        def done(i=idx):
            self._load[i] = max(0, self._load[i] - 1)

        try:
            CoreWorker.current_or_raise().memory_store.add_done_callback(
                ref.object_id, done)
        except Exception:  # noqa: BLE001
            done()
        return ref

    def shutdown(self):
        import ray_tpu_torch as rt

        for a in self._actors:
            try:
                rt.kill(a)
            except Exception:  # noqa: BLE001
                pass


class _UdfActor:
    """Holds one constructed UDF instance per pool actor."""

    def __init__(self, fn_blob: bytes):
        import cloudpickle

        fn = cloudpickle.loads(fn_blob)
        # class UDFs construct once here (the expensive part); plain
        # functions pass through
        self._fn = fn() if isinstance(fn, type) else fn

    def run(self, block):
        return self._fn(block)

    def ping(self):
        return True


class StreamingExecutor:
    """Bounded-window streaming over (source, map-stage...) segments."""

    def __init__(self, max_inflight: int = 8):
        self.max_inflight = max_inflight

    def iter_block_refs(self, source_refs_or_tasks: List[Any], *,
                        is_read_tasks: bool,
                        stages: List[Any],
                        stats: Optional[dict] = None) -> Iterator[Any]:
        """stages: callables `stage(block_ref) -> block_ref` (each submits
        one task/actor call). Yields final block refs in completion order
        with at most max_inflight chains outstanding (backpressure).

        Per-operator budget (reference backpressure_policy/
        ConcurrencyCapBackpressurePolicy): when DataContext's
        ``op_concurrency_cap`` is set, a new chain is admitted only while
        every stage has fewer than that many un-finished tasks — bounding
        each operator's concurrent footprint, not just the global window.
        """
        import threading
        import time as _time

        import ray_tpu_torch as rt
        from ray_tpu_torch.data.context import DataContext
        from ray_tpu_torch.core_worker.worker import CoreWorker

        @rt.remote
        def _run_read(task):
            return task()

        cap = DataContext.get_current().op_concurrency_cap
        outstanding = [0] * len(stages)
        out_lock = threading.Lock()

        def track(k, ref):
            with out_lock:
                outstanding[k] += 1

            def done(_k=k):
                with out_lock:
                    outstanding[_k] = max(0, outstanding[_k] - 1)

            try:
                CoreWorker.current_or_raise().memory_store \
                    .add_done_callback(ref.object_id, done)
            except Exception:  # noqa: BLE001
                done()

        def admit_ok() -> bool:
            if not cap:
                return True
            with out_lock:
                return all(o < cap for o in outstanding)

        t0 = _time.perf_counter()
        pending: Dict[Any, int] = {}
        completed: Dict[int, Any] = {}
        source_iter = iter(source_refs_or_tasks)
        exhausted = False
        order = 0
        next_emit = 0
        while True:
            while (not exhausted
                   and len(pending) + len(completed) < self.max_inflight
                   and admit_ok()):
                try:
                    src = next(source_iter)
                except StopIteration:
                    exhausted = True
                    break
                ref = _run_read.remote(src) if is_read_tasks else src
                for k, stage in enumerate(stages):
                    ref = stage(ref)
                    track(k, ref)
                pending[ref] = order
                order += 1
            if not pending and not completed:
                if stats is not None:
                    stats["wall_s"] = _time.perf_counter() - t0
                return
            if pending:
                # short timeout when capped: admission may reopen on a
                # done-callback rather than a head-of-line completion
                ready, _ = rt.wait(list(pending), num_returns=1,
                                        timeout=0.5 if cap else None)
                for ref in ready:
                    completed[pending.pop(ref)] = ref
            # Emit in PLAN order (Dataset semantics are ordered); the
            # out-of-order buffer is bounded by the in-flight window.
            while next_emit in completed:
                if stats is not None:
                    stats["blocks"] += 1
                    stats["wall_s"] = _time.perf_counter() - t0
                yield completed.pop(next_emit)
                next_emit += 1


# --------------------------------------------------------------- shuffle

def shuffle_blocks(block_refs, num_output_blocks: int, *,
                   mode: str, key: Optional[str] = None,
                   seed: Optional[int] = None,
                   descending: bool = False) -> List[Any]:
    """Distributed map/reduce shuffle (reference hash_shuffle.py):
    mode ∈ {"repartition", "random", "hash", "sort"}. Returns reduce-output
    block refs; every stage is a task, nothing materializes centrally.

    Default engine: the streaming shuffle (``data/shuffle.py``) — fused
    partition objects, windowed map submission, per-arrival reducer
    merge.  ``block_refs`` may be a lazy iterator there (hash/random
    consume it incrementally; a LIST is drained so inputs free as the
    window advances).  ``DataContext.use_streaming_shuffle = False``
    (or env ``RT_streaming_shuffle=0``) selects the legacy two-barrier
    task engine — bit-identical outputs, kept for parity testing."""
    from ray_tpu_torch.data.context import DataContext

    ctx = DataContext.get_current()
    if ctx.use_streaming_shuffle:
        block_refs = list(block_refs)
        # small inputs: reducer-actor spawn/reap costs more than the
        # whole shuffle — take the task engine (bit-identical outputs)
        if len(block_refs) >= ctx.streaming_shuffle_min_blocks:
            from ray_tpu_torch.data.shuffle import streaming_shuffle

            return streaming_shuffle(block_refs, num_output_blocks,
                                     mode=mode, key=key, seed=seed,
                                     descending=descending)
    return shuffle_blocks_barrier(list(block_refs), num_output_blocks,
                                  mode=mode, key=key, seed=seed,
                                  descending=descending)


def shuffle_blocks_barrier(block_refs: List[Any], num_output_blocks: int, *,
                           mode: str, key: Optional[str] = None,
                           seed: Optional[int] = None,
                           descending: bool = False) -> List[Any]:
    """Legacy two-barrier engine: one task per block returns N separate
    partition objects (``num_returns=n`` — M×N store entries), one
    reduce task per output partition takes all M parts as args.  The
    streaming engine is the default; this stays as the parity oracle."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.data import shuffle as S

    n = max(1, num_output_blocks)

    boundaries = None
    offsets = None
    if mode == "repartition":
        offsets = S.compute_repartition_offsets(block_refs)
    if mode == "sort":
        boundaries = S.compute_sort_boundaries(block_refs, key, n)

    @rt.remote
    def _partition(block, part_seed, block_index):
        rows = B.block_num_rows(block)
        batch = B.block_to_batch(block)
        assign = S.assign_partitions(
            batch, rows, mode=mode, n=n, key=key, part_seed=part_seed,
            block_offset=None if offsets is None else offsets[block_index],
            boundaries=boundaries, descending=descending)
        parts = []
        for p in range(n):
            mask = assign == p
            parts.append(B.block_from_batch(
                {c: np.asarray(v)[mask] for c, v in batch.items()}))
        # num_returns=1 delivers the value itself, not a 1-tuple
        return parts[0] if n == 1 else tuple(parts)

    @rt.remote
    def _reduce(reduce_seed, *parts):
        merged_tbl = B.concat_blocks(parts)
        batch = B.block_to_batch(merged_tbl)
        if mode == "sort" and key in batch:
            order = np.argsort(batch[key], kind="stable")
            if descending:
                order = order[::-1]
            return B.block_from_batch({c: v[order] for c, v in batch.items()})
        rows = B.block_num_rows(merged_tbl)
        if mode == "random" and rows:
            rng = np.random.default_rng(reduce_seed)
            order = rng.permutation(rows)
            return B.block_from_batch(
                {c: np.asarray(v)[order] for c, v in batch.items()})
        return merged_tbl

    part_lists = [
        _partition.options(num_returns=n).remote(
            r, seed + i if seed is not None else None, i)
        for i, r in enumerate(block_refs)]
    # normalize: num_returns=1 returns a single ref
    part_lists = [p if isinstance(p, list) else [p] for p in part_lists]
    return [
        _reduce.remote(seed * 1000 + p if seed is not None else None,
                       *[parts[p] for parts in part_lists])
        for p in range(n)]


# ------------------------------------------------------------------ join

def _stable_hash(x) -> int:
    """Back-compat alias: the one implementation lives in
    ``data/shuffle.py`` (both the shuffle router and the join
    partitioner must agree byte-for-byte)."""
    from ray_tpu_torch.data.shuffle import _stable_hash as impl

    return impl(x)


def hash_join(left_refs: List[Any], right_refs: List[Any], on: str,
              right_on: str, how: str, n: int, suffix: str) -> List[Any]:
    """Distributed hash join (reference
    ``_internal/execution/operators/join.py``): hash-partition both sides
    on the key — one FUSED partition object per input block (all n
    slices + offset index; the M×N object explosion of one-object-per-
    partition is gone) — then one join task per partition decodes ONLY
    its slice of each fused object, builds a dict index on its right
    rows and probes with the left.  Returns joined block refs; nothing
    materializes centrally."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.data import shuffle as S

    n = max(1, n)

    @rt.remote
    def _partition(block, key_col, block_index):
        batch = B.block_to_batch(block)
        rows = B.block_num_rows(block)
        if key_col not in batch or rows == 0:
            # rows without the key column can't match anything: route an
            # empty (schema-preserving) slice set
            empty = {c: np.asarray(v)[:0] for c, v in batch.items()}
            return S.make_fused(empty, np.zeros(0, np.int64), n,
                                block_index)
        assign = np.array([_stable_hash(x) % n for x in batch[key_col]],
                          np.int64)
        return S.make_fused(batch, assign, n, block_index)

    @rt.remote
    def _join(p, n_left, fused_refs):
        # refs ride INSIDE a list (borrowed refs, not task args): each
        # join task resolves them ONE AT A TIME and keeps only its own
        # partition's rows — arg-fetching all M+N fused objects would
        # pin the entire both-side dataset in every join task for the
        # task's whole lifetime (n× the working set under a capped
        # arena; the old per-partition objects pinned ~dataset/n).
        def rows_of(ref):
            fp = rt.get([ref])[0]
            if fp.rows_in(p) == 0:
                return []
            return B.block_to_rows(B.block_from_batch(fp.decode_copy(p)))

        left_rows = []
        for ref in fused_refs[:n_left]:
            left_rows.extend(rows_of(ref))
        right_rows = []
        for ref in fused_refs[n_left:]:
            right_rows.extend(rows_of(ref))
        left_cols = list(left_rows[0].keys()) if left_rows else []
        right_cols = list(right_rows[0].keys()) if right_rows else []

        def out_row(lr, rr):
            row = (dict(lr) if lr is not None
                   else {c: None for c in left_cols})
            rsrc = rr if rr is not None else {c: None for c in right_cols}
            for c, v in rsrc.items():
                if c == right_on and (rr is None or c == on):
                    continue  # the key survives via the left side
                row[c + suffix if c in row else c] = v
            if lr is None and rr is not None:
                row[on] = rr[right_on]  # key from the right side
            return row

        index: Dict[Any, list] = {}
        for r in right_rows:
            index.setdefault(r[right_on], []).append(r)
        out, matched = [], set()
        for lr in left_rows:
            ms = index.get(lr[on])
            if ms:
                for m in ms:
                    out.append(out_row(lr, m))
                    matched.add(id(m))
            elif how in ("left_outer", "full_outer"):
                out.append(out_row(lr, None))
        if how in ("right_outer", "full_outer"):
            for r in right_rows:
                if id(r) not in matched:
                    out.append(out_row(None, r))
        return B.block_from_rows(out)

    lfused = [_partition.remote(r, on, i)
              for i, r in enumerate(left_refs)]
    rfused = [_partition.remote(r, right_on, i)
              for i, r in enumerate(right_refs)]
    return [_join.remote(p, len(lfused), lfused + rfused)
            for p in range(n)]


# ------------------------------------------------------------ split feed

class _SplitCoordinator:
    """Actor behind :meth:`Dataset.streaming_split`: executes the plan ONCE
    per epoch and round-robins block refs into one bounded queue per
    consumer; each consumer pulls its queue through a streaming-generator
    method (``num_returns="streaming"``), so consumer backpressure reaches
    the executor through the queue bound (reference output_splitter.py)."""

    _DONE = "__rt_split_done__"

    def __init__(self, ds_blob: bytes, n: int, queue_depth: int = 4):
        import cloudpickle

        self._ds = cloudpickle.loads(ds_blob)
        self._n = n
        self._depth = max(1, queue_depth)
        self._epochs: Dict[int, list] = {}
        import threading

        self._lock = threading.Lock()

    def _ensure_epoch(self, epoch: int):
        import queue as _q
        import threading

        with self._lock:
            if epoch in self._epochs:
                return
            queues = [_q.Queue(maxsize=self._depth) for _ in range(self._n)]
            self._epochs[epoch] = queues
            # drop finished epochs so their refs (and blocks) free up
            for old in [e for e in self._epochs if e < epoch - 1]:
                del self._epochs[old]

        def pump():
            try:
                for j, ref in enumerate(self._ds._stream_refs()):
                    queues[j % self._n].put(ref)
            finally:
                for q in queues:
                    q.put(self._DONE)

        threading.Thread(target=pump, daemon=True,
                         name=f"split-pump-{epoch}").start()

    def stream(self, index: int, epoch: int = 0):
        """Streaming-generator method: yields block refs for one consumer."""
        self._ensure_epoch(epoch)
        q = self._epochs[epoch][index]
        while True:
            item = q.get()
            if item == self._DONE:
                return
            yield item
