"""Streaming shuffle engine: fused partition objects + pipelined reduce
(port of ``ray_tpu/data/shuffle.py``).

Reference: ``python/ray/data/_internal/execution/operators/hash_shuffle.py``
— the dedicated streaming hash-shuffle operator family that exists because
the naive M-map × N-reduce object explosion doesn't scale.  Three ideas,
composed:

- **Fused partition objects** (:class:`FusedPartitions`): each map task
  seals ONE object per input block containing all ``n`` partition slices
  plus an offset index — instead of ``n`` separate return objects
  (``M × N`` store entries total).  The gathered columns ARE the
  object's out-of-band buffers, so it rides the arena-direct task-return
  path (one memcpy into shared pages) and consumers map it zero-copy; a
  reducer touches ONLY its ``[starts[p], ends[p])`` window of each
  column — a ``memoryview`` slice of the pinned view, never a parse or
  copy of the whole object.
- **Pipelined streaming reduce**: reducer ACTORS consume partition
  slices incrementally as map tasks finish, under a bounded in-flight
  window (the :class:`~ray_tpu_torch.data.execution.StreamingExecutor`
  admission pattern applied to the shuffle's map stage).  Merging — and
  for group-by aggregations, the aggregation itself — happens per
  arrival, so map, spill, and reduce wall-clock overlap instead of
  meeting at the two global barriers of the old task-per-reducer shape.
  Consumed inputs and fused objects are released as the window advances,
  which is what collapses spill amplification: the object plane holds
  one window of blocks, not the whole dataset.
- **Announced restore order**: each consume call carries the object ids
  the reducer will need next; the shm spill engine prefetches those
  spill files into its readahead cache (``prefetch_spilled``) so
  restores of demoted fused objects come off a warm cache, not a cold
  ``open+read`` on the critical path.

Ordering contract: reducers reassemble each partition's chunks in BLOCK
INDEX order (not arrival order), so every mode is bit-identical to the
legacy two-barrier engine (``execution.shuffle_blocks_barrier``) —
repartition stays globally ordered, sort ties keep input order, and a
seeded random shuffle permutes the same row order.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.core_worker import serialization as _ser
from ray_tpu_torch.data import block as B


class FusedPartitions:
    """All ``n`` partition slices of one input block in ONE object.

    ``columns`` holds each column ONCE, gathered into partition order
    (rows of partition ``p`` occupy ``[starts[p], ends[p])`` in every
    column) — the offset index that replaces ``n`` separate partition
    objects.  Each column is an out-of-band pickle-5 buffer, so task
    returns write the whole object straight into the shm arena (one
    memcpy) and readers alias the shared pages: a reducer's slice of
    partition ``p`` is a zero-copy ``memoryview`` window over the
    pinned view — no per-slice parse, no intermediate framing copy.
    """

    __slots__ = ("columns", "starts", "ends", "block_index")

    def __init__(self, columns: Dict[str, np.ndarray],
                 starts: Tuple[int, ...], ends: Tuple[int, ...],
                 block_index: int):
        self.columns = columns
        self.starts = starts
        self.ends = ends
        self.block_index = block_index

    @property
    def num_partitions(self) -> int:
        return len(self.starts)

    def rows_in(self, p: int) -> int:
        return self.ends[p] - self.starts[p]

    def decode(self, p: int) -> Dict[str, np.ndarray]:
        """Partition ``p``'s columns as VIEWS aliasing the fused payload
        (and through it the shm pages) — read-only; copy to keep."""
        lo, hi = self.starts[p], self.ends[p]
        if lo == hi:
            return {c: v[:0] for c, v in self.columns.items()}
        return {c: v[lo:hi] for c, v in self.columns.items()}

    def decode_copy(self, p: int) -> Dict[str, np.ndarray]:
        """Partition ``p`` with its OWN memory: the one bulk copy a
        reducer takes of its slice (a retained alias would pin the
        fused object's arena span for the life of the reduce)."""
        lo, hi = self.starts[p], self.ends[p]
        return {c: np.array(v[lo:hi]) for c, v in self.columns.items()}

    def __reduce__(self):
        return (FusedPartitions,
                (self.columns, self.starts, self.ends, self.block_index))


def _fused_safe(v, budget) -> bool:
    # starts/ends can exceed the generic 256-container cap (one entry
    # per output partition); plain int tuples of any length are
    # C-pickler safe, so validate directly instead of delegating to
    # _plain_safe.  Object-dtype columns make the whole value fall back
    # to the cloudpickle meta path — correct, just not zero-copy.
    return (isinstance(v.columns, dict)
            and all(isinstance(a, np.ndarray) and not a.dtype.hasobject
                    for a in v.columns.values())
            and isinstance(v.starts, tuple)
            and isinstance(v.ends, tuple)
            and type(v.block_index) is int)


_ser.register_plain_safe(FusedPartitions, _fused_safe)


def make_fused(batch: Dict[str, Any], assign: np.ndarray, n: int,
               block_index: int) -> FusedPartitions:
    """Build the fused object: one stable argsort on the assignment
    vector and one gather per column — partition ``p`` then IS the
    contiguous row range ``[starts[p], ends[p])`` of every gathered
    column (no per-partition mask pass — the old engine paid ``n``
    fancy-index gathers per column — and no per-partition serialize:
    the gathered columns ship as the object's out-of-band buffers)."""
    rows = len(assign)
    if rows:
        order = np.argsort(assign, kind="stable")
        gathered = {c: np.ascontiguousarray(np.asarray(v)[order])
                    for c, v in batch.items()}
        sorted_assign = assign[order]
        starts = np.searchsorted(sorted_assign, np.arange(n), side="left")
        ends = np.searchsorted(sorted_assign, np.arange(n), side="right")
    else:
        gathered = {c: np.ascontiguousarray(np.asarray(v)[:0])
                    for c, v in batch.items()}
        starts = ends = np.zeros(n, np.int64)
    return FusedPartitions(gathered,
                           tuple(int(x) for x in starts),
                           tuple(int(x) for x in ends), block_index)


def assign_partitions(batch: Dict[str, Any], rows: int, *, mode: str,
                      n: int, key: Optional[str], part_seed,
                      block_offset: Optional[Tuple[int, int]],
                      boundaries, descending: bool) -> np.ndarray:
    """Row → output-partition assignment, shared by both engines (the
    legacy barrier engine and the streaming engine must route every row
    identically for parity)."""
    if rows == 0 or (mode in ("hash", "sort") and key not in batch):
        return np.zeros(rows, np.int64)
    if mode == "repartition":
        # order-preserving: rows map to output partitions by GLOBAL row
        # position (contiguous ranges), so repartition keeps Dataset order
        start, total = block_offset
        assign = (start + np.arange(rows)) * n // total
        return np.minimum(assign, n - 1)
    if mode == "random":
        rng = np.random.default_rng(part_seed)
        return rng.integers(0, n, size=rows)
    if mode == "hash":
        col = np.asarray(batch[key])
        if np.issubdtype(col.dtype, np.integer):
            # vectorized: the per-row python hash loop dominated
            # GB-scale shuffles
            return (col.astype(np.int64) % n).astype(np.int64)
        return np.array([_stable_hash(x) % n for x in col], np.int64)
    if mode == "sort":
        col = np.asarray(batch[key])
        assign = np.searchsorted(boundaries, col, side="right") \
            if len(boundaries) else np.zeros(rows, np.int64)
        if descending:
            assign = (n - 1) - assign
        return assign
    raise ValueError(mode)


def _stable_hash(x) -> int:
    """Content hash stable across processes (Python's str/bytes hash is
    per-process salted, which would scatter equal keys across
    reducers).  Integer-valued floats coerce to int so a key column that
    materializes int64 in one block and float64 in another still routes
    equal keys to ONE partition."""
    import zlib

    if hasattr(x, "item"):
        x = x.item()
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, float) and x.is_integer():
        return int(x)
    b = x if isinstance(x, bytes) else str(x).encode()
    return zlib.crc32(b)


# --------------------------------------------------------------- reducers


class _ShuffleReducer:
    """One reducer actor multiplexes every output partition ``p`` with
    ``p % num_actors == actor_index`` (n output partitions must not cost
    n processes — a 100-block sort keeps its 100 output blocks on a
    handful of actors).

    ``consume`` merges per arrival; ``finalize(p)`` assembles partition
    ``p`` in block-index order and applies the mode's post-step (sort /
    seeded permutation) and the optional reduce spec:

    - ``("groups", key, fn_blob)`` — GroupedDataset.map_groups: the
      group function runs INSIDE the reducer, so only its (usually
      small) output ever re-enters the object plane. The old shape
      returned the full merged partition (≈ dataset/n bytes) just to
      feed a follow-up task — for a 2 GB groupby that round-trip alone
      re-spilled the entire dataset.
    - ``("agg", key, aggs)`` — GroupedDataset aggregations fold
      ALGEBRAICALLY per arrival (sum/count/min/max/sumsq partials per
      key): reducer memory is O(distinct keys), not O(partition).
    """

    def __init__(self, actor_index: int, num_actors: int, n: int,
                 spec_blob: bytes):
        import cloudpickle

        self._idx = actor_index
        self._num_actors = num_actors
        self._n = n
        spec = cloudpickle.loads(spec_blob)
        self._mode: str = spec["mode"]
        self._key: Optional[str] = spec.get("key")
        self._descending: bool = spec.get("descending", False)
        self._seed = spec.get("seed")
        self._reduce = spec.get("reduce")  # None | ("groups",fn) | ("agg",aggs)
        self._mine = [p for p in range(n) if p % num_actors == actor_index]
        # collect mode: partition -> list of (block_index, pa.Table)
        self._chunks: Dict[int, list] = {p: [] for p in self._mine}
        # agg mode: partition -> key value -> partial vector
        self._partials: Dict[int, dict] = {p: {} for p in self._mine}

    # ------------------------------------------------------------ consume
    def consume(self, fused_batch, upcoming=()) -> bool:
        """Merge one BATCH of fused objects (the pump coalesces every
        map completion it sees per wait round into one actor call — one
        RPC + one ref-handoff per batch instead of per object)."""
        if upcoming:
            # announced restore order: warm the spill readahead cache for
            # the fused objects this reducer will be handed next
            try:
                from ray_tpu_torch.core_worker.worker import CoreWorker

                cw = CoreWorker._current
                if cw is not None and cw._shm not in (False, None):
                    cw._shm.prefetch_spilled(upcoming)
            except Exception:  # noqa: BLE001 — readahead is best-effort
                pass
        if isinstance(fused_batch, FusedPartitions):
            fused_batch = (fused_batch,)
        agg = self._reduce is not None and self._reduce[0] == "agg"
        for fused in fused_batch:
            if not isinstance(fused, FusedPartitions):
                # batched dispatch ships refs INSIDE the tuple (one
                # handoff per batch); resolve here — a same-node
                # zero-copy arena read
                import ray_tpu_torch as rt

                fused = rt.get([fused])[0]
            for p in self._mine:
                if fused.rows_in(p) == 0:
                    continue
                if agg:
                    # fold over zero-copy VIEWS: only scalars survive
                    # the call, no alias outlives the arg pin
                    self._fold(p, fused.decode(p))
                else:
                    # one bulk copy of OUR slice only (the decoded
                    # arrays must not keep aliasing the fused object —
                    # a retained alias pins its arena span for the life
                    # of the reduce); kept as a batch DICT: the arrow
                    # table (when one is even needed — group-map output
                    # skips it) builds ONCE at finalize from
                    # numpy-concatenated columns
                    self._chunks[p].append(
                        (fused.block_index, fused.decode_copy(p)))
        return True

    # ---------------------------------------------------------- agg fold
    _AGG_SLOTS = ("count", "sum", "min", "max", "sumsq")

    def _fold(self, p: int, chunk: Dict[str, np.ndarray]) -> None:
        key = self._key
        if key not in chunk:
            return
        keys = np.asarray(chunk[key])
        uniq, inv = np.unique(keys, return_inverse=True)
        partials = self._partials[p]
        _, aggs = self._reduce
        cols = {col for _, col, kind in aggs if kind != "count"}
        # sorted-segment reductions: one argsort + one reduceat pass per
        # column, O(rows log rows) per chunk — a per-key boolean mask
        # (`inv == i` per unique key) is O(keys × rows) and a
        # high-cardinality groupby would spend the whole per-arrival
        # overlap budget rescanning inv
        order = np.argsort(inv, kind="stable")
        starts = np.searchsorted(inv[order], np.arange(len(uniq)),
                                 side="left")
        counts = np.diff(np.append(starts, len(inv)))
        reduced = {}
        for c in cols:
            v = np.asarray(chunk[c])[order]
            reduced[c] = (
                np.add.reduceat(v, starts),
                np.add.reduceat(v.astype(np.float64) ** 2, starts),
                np.minimum.reduceat(v, starts),
                np.maximum.reduceat(v, starts),
            )
        for i, k in enumerate(uniq):
            kk = k.item() if hasattr(k, "item") else k
            slot = partials.setdefault(kk, {})
            slot["count"] = slot.get("count", 0) + int(counts[i])
            for c in cols:
                sums, sumsqs, mins, maxs = reduced[c]
                cs = slot.setdefault(c, {})
                # .item() keeps integer sums integral (the old engine's
                # np.sum over an int column returned a python int)
                cs["sum"] = cs.get("sum", 0) + sums[i].item()
                cs["sumsq"] = cs.get("sumsq", 0.0) + float(sumsqs[i])
                mn, mx = mins[i].item(), maxs[i].item()
                cs["min"] = min(cs.get("min", mn), mn)
                cs["max"] = max(cs.get("max", mx), mx)

    # ----------------------------------------------------------- finalize
    def finalize(self, p: int):
        if self._reduce is not None and self._reduce[0] == "agg":
            return self._finalize_agg(p)
        chunks = self._chunks.pop(p, [])
        # BLOCK INDEX order — not arrival order: parity with the barrier
        # engine (global order for repartition, stable sort ties, the
        # same seeded permutation for random)
        chunks.sort(key=lambda t: t[0])
        batch = _merge_batches([d for _, d in chunks])
        rows = len(next(iter(batch.values()))) if batch else 0
        if self._mode == "sort" and self._key in batch:
            order = np.argsort(batch[self._key], kind="stable")
            if self._descending:
                order = order[::-1]
            batch = {c: np.asarray(v)[order] for c, v in batch.items()}
        elif self._mode == "random" and rows:
            reduce_seed = (self._seed * 1000 + p
                           if self._seed is not None else None)
            rng = np.random.default_rng(reduce_seed)
            order = rng.permutation(rows)
            batch = {c: np.asarray(v)[order] for c, v in batch.items()}
        if self._reduce is not None and self._reduce[0] == "groups":
            return self._apply_groups(batch)
        return B.block_from_batch(batch)

    def _apply_groups(self, batch: Dict[str, np.ndarray]):
        """Columnar per-key-group application of the user fn (the old
        ``_map_partition`` body, run in-reducer) — straight off the
        merged numpy columns, no arrow round trip."""
        import cloudpickle

        _, fn_blob = self._reduce
        fn = cloudpickle.loads(fn_blob)
        key = self._key
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

    def _finalize_agg(self, p: int):
        import math

        _, aggs = self._reduce
        partials = self._partials.pop(p, {})
        rows: List[Dict] = []
        for k, slot in partials.items():
            row: Dict[str, Any] = {self._key: k}
            count = slot["count"]
            for out, col, kind in aggs:
                if kind == "count":
                    row[out] = count
                    continue
                cs = slot[col]
                if kind == "sum":
                    row[out] = cs["sum"]
                elif kind == "mean":
                    row[out] = cs["sum"] / max(count, 1)
                elif kind == "min":
                    row[out] = cs["min"]
                elif kind == "max":
                    row[out] = cs["max"]
                elif kind == "std":
                    mean = cs["sum"] / max(count, 1)
                    var = max(cs["sumsq"] / max(count, 1) - mean * mean,
                              0.0)
                    row[out] = math.sqrt(var)
                else:
                    raise ValueError(f"unknown aggregation {kind!r}")
            rows.append(row)
        return B.block_from_rows(rows)

    def drain_spills(self) -> bool:
        """Pre-reap barrier: force any finalize outputs still queued in
        this worker's async spill writer onto disk.  The pump kills
        reducer actors the moment their outputs are READY at the driver,
        and a SIGKILL would lose bytes whose only copy is the pending
        write queue (arena span already freed)."""
        try:
            from ray_tpu_torch.core_worker.worker import CoreWorker

            cw = CoreWorker._current
            if cw is not None and cw._shm not in (False, None):
                return cw._shm.flush_spills(10.0)
        except Exception:  # noqa: BLE001 — best-effort; close() drains too
            pass
        return True

    def ping(self) -> bool:
        return True


def _merge_batches(dicts: List[Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
    """Concatenate batch dicts column-wise in numpy.  Homogeneous
    schemas (the overwhelmingly common case) never touch arrow; a
    schema mismatch falls back to arrow's promote-concat (missing
    columns become nulls — the legacy engine's semantics)."""
    dicts = [d for d in dicts if d]
    if not dicts:
        return {}
    if len(dicts) == 1:
        return dict(dicts[0])
    cols = list(dicts[0])
    if all(list(d) == cols for d in dicts[1:]):
        return {c: np.concatenate([d[c] for d in dicts]) for c in cols}
    merged = B.concat_blocks([B.block_from_batch(d) for d in dicts])
    return B.block_to_batch(merged)


# ------------------------------------------------------------- pre-passes


def compute_repartition_offsets(block_refs: List[Any]) -> Dict[int, tuple]:
    """Global row position of each block (order-preserving repartition
    routes rows by contiguous range) — shared by both engines."""
    import ray_tpu_torch as rt

    @rt.remote
    def _count(block):
        return B.block_num_rows(block)

    counts = rt.get([_count.remote(r) for r in block_refs])
    total = max(1, sum(counts))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return {i: (int(starts[i]), total) for i in range(len(counts))}


def compute_sort_boundaries(block_refs: List[Any], key: str,
                            n: int) -> np.ndarray:
    """Quantile boundaries from per-block key samples.  Each block's
    sampler is seeded by ITS OWN index — one fixed seed across blocks
    drew identical sample indices everywhere, biasing the boundary
    quantiles toward whatever the common positions happened to hold."""
    import ray_tpu_torch as rt

    @rt.remote
    def _sample_keys(block, block_index):
        batch = B.block_to_batch(block)
        col = batch.get(key)
        if col is None or len(col) == 0:
            return np.empty(0)
        k = max(1, len(col) // 16)
        idx = np.random.default_rng(block_index).choice(
            len(col), size=k, replace=False)
        return np.asarray(col)[idx]

    samples = [s for s in rt.get(
        [_sample_keys.remote(r, i) for i, r in enumerate(block_refs)])
        if len(s)]
    allk = np.sort(np.concatenate(samples)) if samples else np.empty(0)
    if not len(allk):
        return np.empty(0)
    qs = np.linspace(0, 1, n + 1)[1:-1]
    return np.quantile(allk, qs)


# ------------------------------------------------------------------ pump


def streaming_shuffle(sources, n: int, *, mode: str,
                      key: Optional[str] = None,
                      seed: Optional[int] = None,
                      descending: bool = False,
                      reduce_spec=None,
                      window: Optional[int] = None) -> List[Any]:
    """Drive the streaming shuffle: windowed fused-map submission,
    per-arrival reducer consumption, block-index-ordered finalize.

    ``sources`` may be a LIST of block refs or a lazy ITERATOR (the
    hash/random paths never materialize the input set — each input ref
    is dropped the moment its map task completes, so the object plane
    only ever holds one window of blocks).  repartition/sort need a
    global pre-pass (row offsets / key quantiles) and materialize.
    Returns the ``n`` reduce-output block refs in partition order;
    reducer actors are reaped asynchronously once every output lands.
    """
    import cloudpickle

    import ray_tpu_torch as rt
    from ray_tpu_torch.data.context import DataContext

    n = max(1, n)
    ctx = DataContext.get_current()
    if window is None:
        window = ctx.shuffle_map_window or ctx.max_inflight_blocks
    window = max(1, window)

    offsets_map = None
    boundaries = None
    if mode == "repartition":
        sources = list(sources)
        offsets_map = compute_repartition_offsets(sources)
    elif mode == "sort":
        sources = list(sources)
        boundaries = compute_sort_boundaries(sources, key, n)

    @rt.remote
    def _partition_fused(block, part_seed, block_index):
        rows = B.block_num_rows(block)
        batch = B.block_to_batch(block)
        assign = assign_partitions(
            batch, rows, mode=mode, n=n, key=key, part_seed=part_seed,
            block_offset=None if offsets_map is None
            else offsets_map[block_index],
            boundaries=boundaries, descending=descending)
        return make_fused(batch, assign, n, block_index)

    num_actors = max(1, min(n, ctx.shuffle_reducer_actors))
    spec_blob = cloudpickle.dumps({
        "mode": mode, "key": key, "descending": descending, "seed": seed,
        "reduce": reduce_spec})
    reducer_cls = rt.remote(_ShuffleReducer)
    reducers = [reducer_cls.options(num_cpus=0, max_concurrency=1).remote(
        a, num_actors, n, spec_blob) for a in range(num_actors)]

    pending: Dict[Any, int] = {}
    consume_refs: List[Any] = []
    out: Optional[List[Any]] = None
    it = iter(sources)
    if isinstance(sources, list):
        # take ownership so consumed input refs free as the window moves
        drained = sources

        def _drain(lst=drained):
            while lst:
                yield lst.pop(0)

        it = _drain()
    try:
        bi = 0
        exhausted = False
        while True:
            while not exhausted and len(pending) < window:
                try:
                    src = next(it)
                except StopIteration:
                    exhausted = True
                    break
                ref = _partition_fused.remote(
                    src, seed + bi if seed is not None else None, bi)
                del src  # the map task now owns the input block
                pending[ref] = bi
                bi += 1
            if not pending:
                break
            ready, _ = rt.wait(list(pending), num_returns=1)
            for ref in ready:
                pending.pop(ref)
                # announced restore order: the fused objects still in
                # flight are the ones this reducer will be handed next —
                # by the time a backlogged reducer executes THIS
                # consume, those have landed (and under arena pressure,
                # spilled).  Dispatch is per fused object: measured
                # FASTER than coalescing ready batches into one call —
                # a batch keeps every ref in it alive until the slowest
                # actor consumes it, and that wider ref lifetime alone
                # re-created arena pressure (0.29 GB of spill and -30%
                # throughput on the 2.2 GB bench).
                upcoming = tuple(r.object_id.binary()
                                 for r in list(pending)[:4])
                for red in reducers:
                    consume_refs.append(red.consume.remote(ref, upcoming))
            # bound un-acked consume work (and surface map/consume errors
            # early instead of at the final barrier)
            high_water = max(window * num_actors * 4, 16)
            if len(consume_refs) > high_water:
                n_wait = len(consume_refs) - high_water // 2
                done, rest = rt.wait(consume_refs,
                                          num_returns=n_wait)
                rt.get(done)
                consume_refs = rest
        rt.get(consume_refs)  # consume barrier + error propagation
        consume_refs = []
        out = [reducers[p % num_actors].finalize.remote(p)
               for p in range(n)]
        return out
    finally:
        _reap_when_done(out, reducers)


def _reap_when_done(out_refs: Optional[List[Any]], reducers: List[Any]):
    """Kill the reducer actors once every finalize output is READY (the
    outputs are node-durable — arena/spill — so the values outlive their
    producers; same contract the ActorPool relies on).  On an aborted
    shuffle (out_refs None) kill immediately."""
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch.core_worker.worker import CoreWorker

    def _kill_all():
        # pre-reap spill barrier: a finalize output demoted to the
        # actor's async spill queue must land on disk before the actor
        # is SIGKILLed — the queued bytes are its only copy (the driver
        # seeing the reply only proves the VALUE left the actor if it
        # shipped inline; large outputs ship by location)
        try:
            rt.get([red.drain_spills.remote() for red in reducers],
                        timeout=15.0)
        except Exception:  # noqa: BLE001 — dead/slow actor: reap anyway
            pass
        for red in reducers:
            try:
                rt.kill(red)
            except Exception:  # noqa: BLE001
                pass

    if not out_refs:
        _kill_all()
        return
    remaining = [len(out_refs)]
    lock = threading.Lock()

    def _one_done():
        with lock:
            remaining[0] -= 1
            last = remaining[0] == 0
        if last:
            # NOT inline: done-callbacks run on the reply reader thread,
            # and kill() is a blocking RPC round-trip — killing from a
            # detached thread keeps the reader draining replies
            threading.Thread(target=_kill_all, daemon=True,
                             name="rt-shuffle-reap").start()

    try:
        store = CoreWorker.current_or_raise().memory_store
        for ref in out_refs:
            store.add_done_callback(ref.object_id, _one_done)
    except Exception:  # noqa: BLE001 — no worker: nothing to reap through
        _kill_all()
