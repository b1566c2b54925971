"""Dataset: lazy logical plan over distributed blocks (port of
``ray_tpu/data/dataset.py``, over ``ray_tpu_torch``'s runtime).

Reference: ``python/ray/data/dataset.py`` (lazy plan → physical operators,
``_internal/execution/streaming_executor.py`` pull-based streaming with
backpressure). This executor gets pipelining from ownership/ref-chaining:
each stage's task takes the upstream block *ref* as an argument, so
stage k+1 of block i runs as soon as that block exists while block i+1 is
still in stage k — no driver-side barriers. Driver-side backpressure caps
how many block chains are in flight at once.
"""

from __future__ import annotations

import builtins
import functools
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np

from ray_tpu_torch.data import block as B

# --------------------------------------------------------------- plan ops


class _Op:
    pass


class _Read(_Op):
    def __init__(self, read_tasks: List[Callable[[], Any]]):
        self.read_tasks = read_tasks      # each returns a block


class _FromRefs(_Op):
    """Source op over already-materialized block refs (union/split)."""

    def __init__(self, refs: List):
        self.refs = refs


class _MapBlock(_Op):
    actor_pool = None  # (udf, ActorPoolStrategy, ray_remote_args) or None

    """Any block→block transform (map/map_batches/filter/flat_map)."""

    def __init__(self, fn: Callable, name: str):
        self.fn = fn
        self.name = name


class _Shuffle(_Op):
    """Distributed map/reduce shuffle barrier (execution.shuffle_blocks)."""

    def __init__(self, mode: str, num_blocks_fn, key=None, seed=None,
                 descending=False):
        self.mode = mode
        self.num_blocks_fn = num_blocks_fn  # (n_input_blocks) -> n_output
        self.key = key
        self.seed = seed
        self.descending = descending
        self.name = f"shuffle:{mode}"


class _AllToAll(_Op):
    """Barrier op (repartition/shuffle/sort): needs all upstream blocks."""

    def __init__(self, fn: Callable[[List], List], name: str):
        self.fn = fn                      # List[block_ref] -> List[block]
        self.name = name


def _fuse_maps(ops: List[_Op]) -> List[_Op]:
    """Back-compat alias: the rule-based optimizer supersedes this
    (``data/optimizer.py``, reference logical/optimizers.py)."""
    from ray_tpu_torch.data.optimizer import optimize

    return optimize(ops)


class Dataset:
    """Lazy, immutable; every transform returns a new Dataset
    (reference ``Dataset`` semantics)."""

    def __init__(self, ops: List[_Op], max_inflight: Optional[int] = None):
        from ray_tpu_torch.data.context import DataContext

        self._ops = ops
        self._max_inflight = (max_inflight if max_inflight is not None
                              else DataContext.get_current()
                              .max_inflight_blocks)
        self._cached_refs: Optional[List] = None
        self._stats: List[dict] = []  # per-executed-segment stage stats

    # ------------------------------------------------------------ lineage
    def _with(self, op: _Op) -> "Dataset":
        return Dataset(self._ops + [op], self._max_inflight)

    # -------------------------------------------------------------- stats
    def stats(self) -> str:
        """Human-readable per-stage execution stats (reference
        ``Dataset.stats()``): blocks processed and wall time per stage of
        each executed segment. Populated by execution; empty before."""
        if not self._stats:
            return "(not executed yet)"
        lines = []
        for seg in self._stats:
            lines.append(
                f"segment[{seg['segment']}] stages={seg['stages'] or '-'} "
                f"blocks={seg['blocks']} wall={seg['wall_s']:.3f}s "
                f"window={seg['window']}")
        return "\n".join(lines)

    # --------------------------------------------------------- transforms
    def map(self, fn: Callable[[Dict], Dict]) -> "Dataset":
        def do(block):
            return B.block_from_rows([fn(r) for r in B.block_to_rows(block)])

        return self._with(_MapBlock(do, "map"))

    def filter(self, fn: Callable[[Dict], bool]) -> "Dataset":
        def do(block):
            return B.block_from_rows(
                [r for r in B.block_to_rows(block) if fn(r)])

        return self._with(_MapBlock(do, "filter"))

    def flat_map(self, fn: Callable[[Dict], List[Dict]]) -> "Dataset":
        def do(block):
            out: List[Dict] = []
            for r in B.block_to_rows(block):
                out.extend(fn(r))
            return B.block_from_rows(out)

        return self._with(_MapBlock(do, "flat_map"))

    def map_batches(self, fn,
                    batch_size: Optional[int] = None,
                    compute=None,
                    fn_constructor_args: tuple = (),
                    ray_remote_args: Optional[dict] = None,
                    **unknown) -> "Dataset":
        """``fn``: callable batch→batch, or a CLASS (stateful UDF) when
        ``compute=ActorPoolStrategy(...)`` — constructed once per pool
        actor (reference actor_pool_map_operator.py)."""
        if unknown:
            import warnings

            warnings.warn(f"map_batches: ignoring unsupported options "
                          f"{sorted(unknown)}", stacklevel=2)

        is_class = isinstance(fn, type)

        def make_do(callable_fn):
            def do(block):
                batch = B.block_to_batch(block)
                if not batch:
                    return block
                n = len(next(iter(batch.values())))
                size = batch_size or n
                outs = []
                for lo in builtins.range(0, n, size):
                    sub = {k: v[lo:lo + size] for k, v in batch.items()}
                    outs.append(B.block_from_batch(callable_fn(sub)))
                return B.concat_blocks(outs)
            return do

        if compute is not None:
            from ray_tpu_torch.data.execution import ActorPoolStrategy

            if not isinstance(compute, ActorPoolStrategy):
                raise TypeError("compute= must be an ActorPoolStrategy")
            if is_class:
                ctor_args = tuple(fn_constructor_args)

                class _Wrapped:  # constructed inside each pool actor
                    def __init__(self, _cls=fn, _args=ctor_args):
                        self._inner = _cls(*_args)
                        self._do = make_do(self._inner)

                    def __call__(self, block):
                        return self._do(block)

                udf = _Wrapped
            else:
                do = make_do(fn)

                def udf(block, _do=do):
                    return _do(block)
            op = _MapBlock(None, "map_batches(actors)")
            op.actor_pool = (udf, compute, ray_remote_args)
            return self._with(op)

        if is_class:
            raise TypeError("class UDFs require compute=ActorPoolStrategy")
        op = _MapBlock(make_do(fn), "map_batches")
        return self._with(op)

    def add_column(self, name: str, fn: Callable[[Dict[str, np.ndarray]],
                                                 np.ndarray]) -> "Dataset":
        def do(batch):
            batch = dict(batch)
            batch[name] = fn(batch)
            return batch

        return self.map_batches(do)

    def select_columns(self, cols: List[str]) -> "Dataset":
        """Keep only ``cols`` (reference ``Dataset.select_columns``)."""
        cols = list(cols)

        def do(batch):
            missing = [c for c in cols if c not in batch]
            if missing:
                raise KeyError(f"select_columns: missing {missing}")
            return {c: batch[c] for c in cols}

        return self.map_batches(do)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        dropped = set(cols)

        def do(batch):
            return {c: v for c, v in batch.items() if c not in dropped}

        return self.map_batches(do)

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        mapping = dict(mapping)

        def do(batch):
            return {mapping.get(c, c): v for c, v in batch.items()}

        return self.map_batches(do)

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with(_Shuffle("repartition",
                                   lambda _n_in: num_blocks))

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        # seed=None stays None all the way down: each execution draws fresh
        # OS entropy (per-epoch reshuffling must differ across epochs).
        return self._with(_Shuffle("random", lambda n_in: builtins.max(n_in, 1),
                                   seed=seed))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._with(_Shuffle("sort", lambda n_in: builtins.max(n_in, 1),
                                   key=key, descending=descending))

    def union(self, other: "Dataset") -> "Dataset":
        # executes both sides; downstream transforms chain off the refs
        refs = self._execute() + other._execute()
        return Dataset([_FromRefs(refs)], self._max_inflight)

    def limit(self, n: int) -> "Dataset":
        def do(blocks: List):
            out, taken = [], 0
            for b in blocks:
                if taken >= n:
                    break
                take = builtins.min(B.block_num_rows(b), n - taken)
                out.append(B.slice_block(b, 0, take))
                taken += take
            return out or [B.block_from_rows([])]

        return self._with(_AllToAll(do, "limit"))

    # --------------------------------------------------------- execution
    def _execute(self) -> List:
        """Materialize the full plan; returns block refs (cached)."""
        if self._cached_refs is None:
            self._cached_refs = list(self._stream_refs())
        return self._cached_refs

    def _stream_refs(self) -> Iterator:
        """Streaming execution (reference streaming_executor.py:53): final
        block refs are yielded as chains complete under a bounded in-flight
        window; shuffle barriers run as distributed map/reduce stages."""
        import ray_tpu_torch as rt
        from ray_tpu_torch.data.execution import (
            ActorPool, StreamingExecutor, shuffle_blocks)

        if self._cached_refs is not None:
            yield from self._cached_refs
            return

        @rt.remote
        def _run_map(fn, block):
            return fn(block)

        @rt.remote
        def _run_all(fn, *blocks):
            return fn(list(blocks))

        ops = _fuse_maps(self._ops)
        assert isinstance(ops[0], (_Read, _FromRefs))
        if isinstance(ops[0], _FromRefs):
            sources, is_read = list(ops[0].refs), False
        else:
            sources, is_read = list(ops[0].read_tasks), True

        pools: List = []

        def make_stage(op):
            if op.actor_pool is not None:
                udf, strategy, remote_args = op.actor_pool
                pool = ActorPool(udf, strategy, remote_args)
                pools.append(pool)
                return pool.submit
            return lambda ref, fn=op.fn: _run_map.remote(fn, ref)

        try:
            i = 1
            seg_no = 0
            while True:
                segment = []
                while i < len(ops) and isinstance(ops[i], _MapBlock):
                    segment.append(ops[i])
                    i += 1
                stages = [make_stage(op) for op in segment]
                ex = StreamingExecutor(self._max_inflight)
                seg_stat = {"segment": seg_no,
                            "stages": "->".join(op.name for op in segment),
                            "blocks": 0, "wall_s": 0.0,
                            "window": self._max_inflight}
                self._stats.append(seg_stat)
                seg_no += 1
                gen = ex.iter_block_refs(sources, is_read_tasks=is_read,
                                         stages=stages, stats=seg_stat)
                if i >= len(ops):
                    yield from gen
                    return
                upstream = list(gen)  # barrier: shuffle needs all inputs
                op = ops[i]
                i += 1
                if isinstance(op, _Shuffle):
                    sources = shuffle_blocks(
                        upstream, op.num_blocks_fn(len(upstream)),
                        mode=op.mode, key=op.key, seed=op.seed,
                        descending=op.descending)
                else:  # legacy whole-plan ops (limit, union glue)
                    out = rt.get(
                        [_run_all.remote(_wrap_list(op.fn), *upstream)])[0]
                    sources = [rt.put(b) for b in out]
                is_read = False
        finally:
            for p in pools:
                p.shutdown()

    # -------------------------------------------------------- consumption
    def materialize(self) -> "Dataset":
        self._execute()
        return self

    def take(self, n: int = 20) -> List[Dict]:
        import ray_tpu_torch as rt

        out: List[Dict] = []
        for ref in self._stream_refs():
            block = rt.get([ref])[0]
            out.extend(B.block_to_rows(block))
            if len(out) >= n:
                return out[:n]
        return out

    def take_all(self) -> List[Dict]:
        import ray_tpu_torch as rt

        out: List[Dict] = []
        for ref in self._execute():
            out.extend(B.block_to_rows(rt.get([ref])[0]))
        return out

    def count(self) -> int:
        import ray_tpu_torch as rt

        blocks = rt.get(self._execute())
        return sum(B.block_num_rows(b) for b in blocks)

    def schema(self) -> Optional[List[str]]:
        import ray_tpu_torch as rt

        for ref in self._execute():
            block = rt.get([ref])[0]
            if B.block_num_rows(block):
                return B.block_column_names(block)
        return None

    def num_blocks(self) -> int:
        return len(self._execute())

    def size_bytes(self) -> int:
        import ray_tpu_torch as rt

        return sum(B.block_size_bytes(b)
                   for b in rt.get(self._execute()))

    # aggregations
    def sum(self, on: str) -> float:
        return float(builtins.sum(
            b[on].sum() for b in self._batches() if on in b and len(b[on])))

    def min(self, on: str) -> float:
        return float(builtins.min(b[on].min() for b in self._batches()
                                  if on in b and len(b[on])))

    def max(self, on: str) -> float:
        return float(builtins.max(b[on].max() for b in self._batches()
                                  if on in b and len(b[on])))

    def mean(self, on: str) -> float:
        total, count = 0.0, 0
        for b in self._batches():
            if on in b and len(b[on]):
                total += float(b[on].sum())
                count += len(b[on])
        return total / builtins.max(count, 1)

    def groupby(self, key: str) -> "GroupedDataset":
        return GroupedDataset(self, key)

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        import ray_tpu_torch as rt

        for ref in self._stream_refs():
            yield B.block_to_batch(rt.get([ref])[0])

    def iter_rows(self) -> Iterator[Dict]:
        import ray_tpu_torch as rt

        for ref in self._stream_refs():
            yield from B.block_to_rows(rt.get([ref])[0])

    def iter_batches(self, *, batch_size: int = 256,
                     drop_last: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        """Re-batch across block boundaries into fixed-size numpy dicts —
        the training-ingest path (feeds JaxTrainer data loaders). Streams:
        at most the executor's in-flight window of blocks is live at once,
        so datasets larger than driver memory iterate fine."""
        import ray_tpu_torch as rt

        carry: Optional[Dict[str, np.ndarray]] = None
        for ref in self._stream_refs():
            batch = B.block_to_batch(rt.get([ref])[0])
            if not batch:
                continue
            if carry:
                batch = {k: np.concatenate([carry[k], batch[k]])
                         for k in batch}
            n = len(next(iter(batch.values())))
            lo = 0
            while n - lo >= batch_size:
                yield {k: v[lo:lo + batch_size] for k, v in batch.items()}
                lo += batch_size
            carry = ({k: v[lo:] for k, v in batch.items()}
                     if lo < n else None)
        if carry and not drop_last:
            yield carry

    def iter_jax_batches(self, *, batch_size: int = 256,
                         drop_last: bool = False, device=None,
                         sharding=None) -> Iterator[Dict]:
        """``iter_batches`` with leaves placed on a device (the JAX
        package's name for its ``jax.device_put`` ingest path, kept):
        ``sharding=(mesh, placements)`` lands each leaf as a DTensor through
        ``distribute_tensor`` on ``parallel.sharding.compute_mesh(mesh)``
        (the placements as ``parallel.sharding.logical_sharding`` returns
        them: the counterpart of a NamedSharding); otherwise as
        :meth:`iter_torch_batches` on ``device``."""
        return _device_batches(
            self.iter_batches(batch_size=batch_size, drop_last=drop_last),
            device, sharding)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = False,
                           device=None) -> Iterator[Dict]:
        """``iter_batches`` with leaves as torch tensors on
        ``resolve_device(device)`` (reference
        ``Dataset.iter_torch_batches``): ``None`` means the CUDA card, and
        raises where there is none; the JAX package's version yields CPU
        tensors. The copy to the card goes through pinned host memory,
        queued on the current stream (``non_blocking``)."""
        return _device_batches(
            self.iter_batches(batch_size=batch_size, drop_last=drop_last),
            device, None)

    def split(self, n: int) -> List["Dataset"]:
        """Split block refs into n datasets (per-worker shards)."""
        refs = self._execute()
        return [Dataset([_FromRefs(refs[i::n])], self._max_inflight)
                for i in range(n)]

    def streaming_split(self, n: int, *,
                        queue_depth: int = 4) -> List["DataIterator"]:
        """n per-consumer iterators fed by ONE streaming execution of the
        plan (reference ``dataset.py:1771 streaming_split`` +
        output_splitter.py): blocks are round-robined to consumers as they
        are produced — nothing materializes, and a slow consumer
        backpressures the pipeline through its bounded queue. Each
        ``iter_batches()`` call on the iterators is one epoch; consumers
        must iterate epochs in lockstep (the trainer-ingest contract)."""
        import cloudpickle

        import ray_tpu_torch as rt
        from ray_tpu_torch.data.execution import _SplitCoordinator

        coord = rt.remote(_SplitCoordinator).options(
            max_concurrency=max(2, 2 * n)).remote(
            cloudpickle.dumps(self), n, queue_depth)
        return [DataIterator(coord, i) for i in range(n)]

    def zip(self, other: "Dataset") -> "Dataset":  # noqa: A003
        """Row-aligned column concatenation (reference ``Dataset.zip`` /
        zip operator): equal row counts required; overlapping column names
        from ``other`` get an ``_1`` suffix. Both sides are repartitioned
        by global row position into identical contiguous ranges (the
        order-preserving shuffle), so block pairs align without any
        central materialization."""
        import ray_tpu_torch as rt

        n_l, n_r = self.count(), other.count()
        if n_l != n_r:
            raise ValueError(
                f"zip needs equal row counts: {n_l} vs {n_r}")
        nb = builtins.max(1, builtins.min(self.num_blocks(),
                                          other.num_blocks()))
        left = self.repartition(nb)._execute()
        right = other.repartition(nb)._execute()

        @rt.remote
        def _zip_blocks(bl, br):
            rows_l = B.block_to_rows(bl)
            rows_r = B.block_to_rows(br)
            out = []
            for lr, rr in builtins.zip(rows_l, rows_r):
                row = dict(lr)
                for k, v in rr.items():
                    row[k + "_1" if k in row else k] = v
                out.append(row)
            return B.block_from_rows(out)

        refs = [_zip_blocks.remote(lref, rref)
                for lref, rref in builtins.zip(left, right)]
        return Dataset([_FromRefs(refs)], self._max_inflight)

    # --------------------------------------------------------------- joins
    def join(self, other: "Dataset", on: str, how: str = "inner", *,
             right_on: Optional[str] = None,
             num_partitions: Optional[int] = None,
             suffix: str = "_right") -> "Dataset":
        """Distributed hash join (reference
        ``data/_internal/execution/operators/join.py``): both sides are
        hash-partitioned on the key, one join task per partition builds a
        hash table on the right side. ``how`` ∈ {"inner", "left_outer",
        "right_outer", "full_outer"}. Overlapping non-key columns from the
        right side get ``suffix``."""
        from ray_tpu_torch.data.execution import hash_join

        if how not in ("inner", "left_outer", "right_outer", "full_outer"):
            raise ValueError(f"unsupported join type {how!r}")
        left_refs = self._execute()
        right_refs = other._execute()
        nparts = num_partitions or builtins.max(
            1, builtins.min(len(left_refs), 16))
        refs = hash_join(left_refs, right_refs, on, right_on or on, how,
                         nparts, suffix)
        return Dataset([_FromRefs(refs)], self._max_inflight)

    # --------------------------------------------------------------- writes
    def _write_blocks(self, path: str, ext: str, writer,
                      filesystem=None) -> List[str]:
        """Block-parallel write: one task per block writes one file
        (reference: Datasink write tasks). Returns the written paths."""
        import os as _os

        import ray_tpu_torch as rt

        _os.makedirs(path, exist_ok=True)

        @rt.remote
        def _write_one(block, fname, _writer):
            _writer(block, fname)
            return fname

        out_refs = []
        for idx, ref in enumerate(self._stream_refs()):
            fname = _os.path.join(path, f"part-{idx:05d}.{ext}")
            out_refs.append(_write_one.remote(ref, fname, writer))
        return rt.get(out_refs)

    def write_parquet(self, path: str) -> List[str]:
        from ray_tpu_torch.data.datasource import _parquet_writer

        return self._write_blocks(path, "parquet", _parquet_writer)

    def write_csv(self, path: str) -> List[str]:
        from ray_tpu_torch.data.datasource import _csv_writer

        return self._write_blocks(path, "csv", _csv_writer)

    def write_json(self, path: str) -> List[str]:
        from ray_tpu_torch.data.datasource import _json_writer

        return self._write_blocks(path, "json", _json_writer)

    def write_numpy(self, path: str, column: str) -> List[str]:
        import functools as _ft

        from ray_tpu_torch.data.datasource import _numpy_writer

        return self._write_blocks(
            path, "npy", _ft.partial(_numpy_writer, column=column))

    def write_tfrecords(self, path: str, *, column: str = "data") -> List[str]:
        import functools as _ft

        from ray_tpu_torch.data.datasource import _tfrecord_writer

        return self._write_blocks(
            path, "tfrecord", _ft.partial(_tfrecord_writer, column=column))


class DataIterator:
    """Per-consumer handle from :meth:`Dataset.streaming_split` (reference
    ``DataIterator``): re-iterable; each pass pulls a fresh epoch from the
    split coordinator via a streaming-generator actor call."""

    def __init__(self, coordinator, index: int):
        self._coord = coordinator
        self._index = index
        self._epoch = 0

    def _iter_block_refs(self) -> Iterator:
        import ray_tpu_torch as rt

        epoch = self._epoch
        self._epoch += 1
        gen = self._coord.stream.options(num_returns="streaming").remote(
            self._index, epoch)
        for item_ref in gen:
            yield rt.get(item_ref)  # a borrowed block ref

    def iter_blocks(self) -> Iterator:
        import ray_tpu_torch as rt

        for block_ref in self._iter_block_refs():
            yield rt.get([block_ref])[0]

    def iter_rows(self) -> Iterator[Dict]:
        for block in self.iter_blocks():
            yield from B.block_to_rows(block)

    def iter_batches(self, *, batch_size: int = 256,
                     drop_last: bool = False
                     ) -> Iterator[Dict[str, np.ndarray]]:
        carry: Optional[Dict[str, np.ndarray]] = None
        for block in self.iter_blocks():
            batch = B.block_to_batch(block)
            if not batch:
                continue
            if carry:
                batch = {k: np.concatenate([carry[k], batch[k]])
                         for k in batch}
            n = len(next(iter(batch.values())))
            lo = 0
            while n - lo >= batch_size:
                yield {k: v[lo:lo + batch_size] for k, v in batch.items()}
                lo += batch_size
            carry = ({k: v[lo:] for k, v in batch.items()}
                     if lo < n else None)
        if carry and not drop_last:
            yield carry


    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = False,
                           device=None) -> Iterator[Dict]:
        """:meth:`iter_batches` on ``resolve_device(device)``, as
        :meth:`Dataset.iter_torch_batches` (``None`` means CUDA)."""
        return _device_batches(
            self.iter_batches(batch_size=batch_size, drop_last=drop_last),
            device, None)


class GroupedDataset:
    """Distributed hash groupby (reference
    ``data/_internal/execution/operators/hash_shuffle.py`` aggregations):
    blocks are hash-partitioned on the key — every key lands in exactly
    one partition — then ONE aggregation task per partition computes its
    keys' results. Only the final (small) aggregate rows reach the
    driver; ``map_groups`` output stays distributed as blocks."""

    _AGG_FNS = {"sum": np.sum, "mean": np.mean, "min": np.min,
                "max": np.max, "std": np.std}

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _stream_source(self):
        """``("stream", iterator)`` when the upstream is big enough for
        the streaming engine, else ``("small", refs)``.  Streaming
        consumes the plan as a STREAM (blocks free as the shuffle window
        advances — a GB-scale groupby never holds the whole dataset in
        the object plane); small inputs take the legacy task path, where
        reducer-actor spawn/reap would dominate (outputs agree either
        way — parity-tested)."""
        from ray_tpu_torch.data.context import DataContext

        ctx = DataContext.get_current()
        if not ctx.use_streaming_shuffle:
            return "small", self._ds._execute()
        import itertools

        it = iter(self._ds._stream_refs())
        head = list(itertools.islice(it,
                                     ctx.streaming_shuffle_min_blocks))
        try:
            nxt = next(it)
        except StopIteration:
            # the head IS the full materialization: cache it so repeated
            # aggregations over one GroupedDataset (g.min(); g.max(); …)
            # don't re-execute the upstream plan (legacy _execute()
            # semantics for small inputs)
            if self._ds._cached_refs is None:
                self._ds._cached_refs = head
            return "small", head
        return "stream", itertools.chain(head, [nxt], it)

    def _partitions(self, source=None) -> List[Any]:
        """Hash-partitioned refs via the legacy task engine (small
        inputs / streaming disabled)."""
        from ray_tpu_torch.data.execution import shuffle_blocks_barrier

        refs = self._ds._execute() if source is None else list(source)
        if not refs:
            return []
        n = builtins.max(1, builtins.min(len(refs), 8))
        return shuffle_blocks_barrier(refs, n, mode="hash", key=self._key)

    def _stream_partitions(self, source, reduce_spec) -> List[Any]:
        """Streaming engine with the aggregation / group-map pushed INTO
        the reducers, so only their (small) outputs re-enter the
        store."""
        from ray_tpu_torch.data.context import DataContext
        from ray_tpu_torch.data.shuffle import streaming_shuffle

        n = DataContext.get_current().shuffle_partitions
        return streaming_shuffle(source, n, mode="hash", key=self._key,
                                 reduce_spec=reduce_spec)

    def _agg(self, aggs: List[tuple]) -> Dataset:
        """aggs: [(out_col, in_col_or_None, kind)] — one pass over each
        hash partition computes every requested aggregate per key.  On
        the streaming engine the fold is ALGEBRAIC and per-arrival
        (sum/count/min/max/sumsq partials inside the reducer actors):
        reducer memory is O(distinct keys), and no merged partition ever
        materializes."""
        import ray_tpu_torch as rt

        key = self._key
        fns = self._AGG_FNS

        kind, source = self._stream_source()
        if kind == "stream":
            parts = self._stream_partitions(source, ("agg", list(aggs)))
            out = []
            for blk in rt.get(parts):
                out.extend(B.block_to_rows(blk))
            out.sort(key=lambda r: r[key])
            return from_items_rows(out)

        @rt.remote
        def _agg_partition(block):
            batch = B.block_to_batch(block)
            if not batch or key not in batch or \
                    len(next(iter(batch.values()))) == 0:
                return B.block_from_rows([])
            keys = np.asarray(batch[key])
            uniq, inv = np.unique(keys, return_inverse=True)
            rows = []
            for i, k in enumerate(uniq):
                sel = inv == i
                row = {key: k.item() if hasattr(k, "item") else k}
                for out, col, kind in aggs:
                    if kind == "count":
                        row[out] = int(sel.sum())
                    else:
                        v = fns[kind](np.asarray(batch[col])[sel])
                        row[out] = v.item() if hasattr(v, "item") else v
                rows.append(row)
            return B.block_from_rows(rows)

        out = []
        for blk in rt.get(
                [_agg_partition.remote(p)
                 for p in self._partitions(source)]):
            out.extend(B.block_to_rows(blk))
        out.sort(key=lambda r: r[self._key])
        return from_items_rows(out)

    def count(self) -> Dataset:
        return self._agg([("count()", None, "count")])

    def sum(self, on: str) -> Dataset:
        return self._agg([(f"sum({on})", on, "sum")])

    def mean(self, on: str) -> Dataset:
        return self._agg([(f"mean({on})", on, "mean")])

    def min(self, on: str) -> Dataset:
        return self._agg([(f"min({on})", on, "min")])

    def max(self, on: str) -> Dataset:
        return self._agg([(f"max({on})", on, "max")])

    def std(self, on: str) -> Dataset:
        return self._agg([(f"std({on})", on, "std")])

    def aggregate(self, **named) -> Dataset:
        """Multiple aggregates in one shuffle+pass:
        ``ds.groupby("k").aggregate(total=("v", "sum"), n=(None, "count"))``
        """
        aggs = []
        for out, (col, kind) in named.items():
            if kind != "count" and kind not in self._AGG_FNS:
                raise ValueError(f"unknown aggregation {kind!r}")
            aggs.append((out, col, kind))
        return self._agg(aggs)

    def map_groups(self, fn) -> Dataset:
        """Apply ``fn(rows: List[dict]) -> List[dict]`` to each key group
        (reference ``GroupedData.map_groups``). Runs one task per hash
        partition; output blocks stay distributed.

        Grouping is columnar: one stable argsort on the key column, then
        row views sliced out of numpy columns — never per-cell Arrow
        ``as_py`` conversion, which made GB-scale groupbys ~20x slower
        than the shuffle that feeds them.

        On the streaming engine the group function runs INSIDE the
        shuffle reducers (``reduce_spec=("groups", fn)``): the merged
        partitions — which together are the whole dataset — never
        re-enter the object plane; only ``fn``'s output does."""
        import ray_tpu_torch as rt

        key = self._key

        kind, source = self._stream_source()
        if kind == "stream":
            import cloudpickle

            refs = self._stream_partitions(
                source, ("groups", cloudpickle.dumps(fn)))
            return Dataset([_FromRefs(refs)])

        @rt.remote
        def _map_partition(block):
            batch = B.block_to_batch(block)
            if batch and key not in batch:
                raise KeyError(
                    f"groupby key {key!r} not in columns {sorted(batch)}")
            out: List[Dict] = []
            if batch and key in batch:
                keys = np.asarray(batch[key])
                order = np.argsort(keys, kind="stable")
                cols = {c: np.asarray(v)[order] for c, v in batch.items()}
                sorted_keys = cols[key]
                uniq, starts = np.unique(sorted_keys, return_index=True)
                bounds = list(starts) + [len(sorted_keys)]
                names = list(cols)
                for i in range(len(uniq)):
                    lo, hi = bounds[i], bounds[i + 1]
                    rows = [{c: cols[c][j] for c in names}
                            for j in range(lo, hi)]
                    res = fn(rows)
                    if isinstance(res, dict):
                        res = [res]
                    out.extend(res)
            return B.block_from_rows(out)

        refs = [_map_partition.remote(p) for p in self._partitions(source)]
        return Dataset([_FromRefs(refs)])


def _device_batches(batches, device, sharding) -> Iterator[Dict]:
    """numpy batches -> torch tensors on ``resolve_device(device)``, or as
    DTensors on ``sharding = (mesh, placements)``. The device resolves
    here, at the call: without CUDA, ``device=None`` raises before any
    batch is read. The host side is pinned before a copy to CUDA so the
    copy is queued without a host wait."""
    import torch

    from ray_tpu_torch import resolve_device

    if sharding is not None:
        from ray_tpu_torch.parallel.sharding import compute_mesh

        mesh, placements = sharding
        return _sharded(batches, compute_mesh(mesh), placements,
                        torch.device(mesh.device_type))
    return _placed(batches, resolve_device(device))


def _placed(batches, dev) -> Iterator[Dict]:
    import warnings

    import torch

    for batch in batches:
        out = {}
        for k, v in batch.items():
            if dev.type == "cuda":
                # a read-only view of the block is only read here, by the
                # copy into pinned memory
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    host = torch.as_tensor(v)
                out[k] = host.pin_memory().to(dev, non_blocking=True)
            else:
                if isinstance(v, np.ndarray) and not v.flags.writeable:
                    v = v.copy()
                out[k] = torch.as_tensor(v).to(dev)
        yield out


def _sharded(batches, mesh, placements, dev) -> Iterator[Dict]:
    import torch
    from torch.distributed.tensor import distribute_tensor

    for batch in batches:
        yield {k: distribute_tensor(torch.as_tensor(np.array(v)).to(dev),
                                    mesh, placements)
               for k, v in batch.items()}


def _is_ready(ref) -> bool:
    from ray_tpu_torch.core_worker.worker import CoreWorker

    cw = CoreWorker.current_or_raise()
    return cw.memory_store.contains(ref.object_id)


def _wrap_list(fn):
    @functools.wraps(fn)
    def inner(blocks):
        out = fn(blocks)
        return out if isinstance(out, list) else [out]

    return inner


def from_items_rows(rows: List[Dict]) -> Dataset:
    ds = Dataset([_Read([lambda rows=rows: B.block_from_rows(rows)])])
    return ds
