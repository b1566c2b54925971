"""The port's Data (``ray_tpu_torch.data``) against ``ray_tpu.data`` on the
CPU: one module-scoped cluster per package (JAX first, then the port), and
one scenario program run through both packages' Data. Every part's rows
and batches must be EQUAL to what ``ray_tpu`` gave on the same part: the
same rows in the same order, the same column names, dtypes, shapes and
bytes (tolerance: none). The parts:

- ``range``, ``from_items`` and ``from_numpy``; ``map``, ``filter``,
  ``flat_map``, ``map_batches`` (also on an ``ActorPoolStrategy`` pool
  with a class UDF), ``add_column``, ``select_columns``, ``limit``;
- ``repartition``; a seeded ``random_shuffle`` (the same row order in
  both, ``ray_tpu/data/shuffle.py:35-38``) on both shuffle engines;
  ``sort`` both ways; ``groupby().map_groups`` and every aggregation;
  ``zip``; the hash ``join`` of each kind;
- ``iter_batches`` across block boundaries, with and without
  ``drop_last``;
- ``streaming_split(2)`` over two epochs;
- write then read for json, csv, parquet, numpy and tfrecords (the
  written bytes too, where the format fixes them);
- ``iter_torch_batches(device="cpu")`` against the JAX package's CPU
  tensors, and ``iter_jax_batches(sharding=...)`` on a mesh of one CPU
  rank (gloo) against JAX's ``NamedSharding`` on one CPU device.

Then the port alone: ``iter_torch_batches()`` with no device raises where
CUDA is absent (there is no fall back to the CPU).
"""

import importlib
import os
import threading

import numpy as np
import pytest

from _torch_isolation import _module_isolation_guard  # noqa: F401

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
JAX_ATTEMPTS = 3
_RESULTS = {}    # what ray_tpu gave on each part, for the port to equal


class _Pkg:
    def __init__(self, name):
        self.name = name
        self.rt = importlib.import_module(name)
        self.data = importlib.import_module(f"{name}.data")
        self.port = name == "ray_tpu_torch"

    def start(self):
        if self.port:
            self.rt.init(num_cpus=4, num_gpus=1)
        else:
            self.rt.init(num_cpus=4, num_tpus=0)

    def stop(self):
        self.rt.shutdown()


@pytest.fixture(scope="module", params=PACKAGES)
def pkg(request):
    p = _Pkg(request.param)
    p.start()
    yield p
    p.stop()


def norm(v):
    """A value as comparable plain data: arrays and tensors by dtype,
    shape and bytes; python values by type and value."""
    if hasattr(v, "full_tensor"):             # a DTensor: its whole value
        v = v.full_tensor()
    if type(v).__module__.startswith("torch"):
        return ("tensor", str(v.dtype).split(".")[-1], tuple(v.shape),
                v.contiguous().numpy().tobytes())
    if type(v).__module__.startswith("jax"):
        v = np.asarray(v)
        return ("tensor", str(v.dtype), v.shape, v.tobytes())
    if isinstance(v, np.ndarray):
        if v.dtype == object:
            return ("obj", v.shape, [norm(x) for x in v.tolist()])
        return ("nd", str(v.dtype), v.shape,
                np.ascontiguousarray(v).tobytes())
    if isinstance(v, np.generic):
        return ("np", str(v.dtype), v.item())
    if isinstance(v, dict):
        return {k: norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [norm(x) for x in v])
    return (type(v).__name__, v)


def _run(p, part, *args):
    """``part(p, *args)``; for ``ray_tpu`` only, again on a fresh cluster
    when it fails: tests/conftest.py's module guard ends every JAX-package
    test file with a machine-wide ``pkill`` of ``ray_tpu``'s worker command
    lines, so under xdist another file's teardown can kill this file's
    ``ray_tpu`` workers (ROADMAP.md C.2). The port fails on its first
    error."""
    if p.port:
        return part(p, *args)
    for attempt in range(JAX_ATTEMPTS):
        try:
            return part(p, *args)
        except Exception:  # noqa: BLE001 — the last attempt re-raises
            if attempt == JAX_ATTEMPTS - 1:
                raise
            p.stop()
            p.start()


def _check(p, name, got):
    """Record ``ray_tpu``'s result of a part; hold the port's to it."""
    got = norm(got)
    if not p.port:
        _RESULTS[name] = got
    else:
        assert name in _RESULTS, f"ray_tpu gave no result for {name}"
        assert got == _RESULTS[name], (name, got, _RESULTS[name])


def _items(n, seed):
    rng = np.random.default_rng(seed)
    return [{"k": int(rng.integers(0, 5)), "v": float(rng.normal()),
             "tag": f"t{i % 3}", "vec": [int(x) for x in
                                        rng.integers(0, 9, i % 3 + 1)]}
            for i in range(n)]


# -------------------------------------------------------------- the parts

def _sources_and_maps(pkg):
    d = pkg.data

    class AddOffset:            # a class UDF: built once per pool actor
        def __init__(self, off):
            self.off = off

        def __call__(self, b):
            return {"id": b["id"], "y": b["id"] * 2 + self.off}

    out = {
        "range": d.range(37, num_blocks=4).take_all(),
        "chain": (d.range(60, num_blocks=4)
                  .map(lambda r: {"x": r["id"] * 3, "h": r["id"] / 7})
                  .filter(lambda r: r["x"] % 2 == 0)
                  .flat_map(lambda r: [r, {"x": -r["x"], "h": r["h"]}])
                  .take_all()),
        "items": d.from_items(_items(25, 1), num_blocks=3).take_all(),
        "numpy": d.from_numpy({
            "a": np.arange(24, dtype=np.float32).reshape(6, 4),
            "b": np.arange(6, dtype=np.int16)}).take_all(),
        "map_batches": (d.range(50, num_blocks=3)
                        .map_batches(lambda b: {"z": b["id"] * 0.5},
                                     batch_size=7)
                        .add_column("w", lambda b: b["z"] + 1)
                        .take_all()),
        "actor_pool": (d.range(40, num_blocks=4)
                       .map_batches(AddOffset, batch_size=6,
                                    compute=d.ActorPoolStrategy(size=2),
                                    fn_constructor_args=(100,))
                       .take_all()),
        "select_limit": (d.from_items(_items(12, 2), num_blocks=2)
                         .select_columns(["k", "tag"]).limit(5).take_all()),
        "count_schema": [d.range(33, num_blocks=3).count(),
                         d.from_items(_items(4, 3)).schema(),
                         d.range(100, num_blocks=3).sum("id"),
                         d.range(100, num_blocks=3).mean("id")],
    }
    return out


def test_sources_and_maps(pkg):
    _check(pkg, "sources_and_maps", _run(pkg, _sources_and_maps))


def _shuffles_sort_groupby(pkg):
    d = pkg.data
    items = _items(40, 4)
    ds = d.from_items(items, num_blocks=4)
    out = {
        "repartition": [ds.repartition(3).num_blocks(),
                        ds.repartition(3).take_all()],
        "random": ds.random_shuffle(seed=7).take_all(),
        "sort": ds.sort("v").take_all(),
        "sort_desc": ds.sort("k", descending=True).take_all(),
        "map_groups": ds.groupby("k").map_groups(
            lambda rows: {"k": rows[0]["k"], "n": len(rows),
                          "vs": float(sum(r["v"] for r in rows))}).take_all(),
        "aggs": [getattr(ds.groupby("k"), a)("v").take_all()
                 for a in ("sum", "mean", "min", "max", "std")]
        + [ds.groupby("k").count().take_all(),
           ds.groupby("k").aggregate(total=("v", "sum"),
                                     n=(None, "count")).take_all()],
    }
    # the streaming shuffle engine: at least streaming_shuffle_min_blocks
    # blocks, with the reducers' map_groups and algebraic aggregations
    ctx = d.DataContext.get_current()
    big = d.from_items(_items(150, 5),
                       num_blocks=ctx.streaming_shuffle_min_blocks)
    out["streaming"] = {
        "random": big.random_shuffle(seed=3).take_all(),
        "sort": big.sort("v").take_all(),
        "sum": big.groupby("k").sum("v").take_all(),
        "std": big.groupby("k").std("v").take_all(),
        "groups": big.groupby("k").map_groups(
            lambda rows: [{"k": rows[0]["k"], "n": len(rows)}]).take_all(),
    }
    return out


def test_shuffles_sort_groupby(pkg):
    _check(pkg, "shuffles_sort_groupby", _run(pkg, _shuffles_sort_groupby))


def _zip_and_joins(pkg):
    d = pkg.data
    left = d.from_items([{"id": i, "a": i * 10} for i in range(12)],
                        num_blocks=3)
    right = d.from_items([{"id": i, "b": f"r{i}", "a": -i}
                          for i in range(6, 16)], num_blocks=2)
    out = {"zip": d.range(12, num_blocks=3).zip(
        d.from_items([{"id": i * i} for i in range(12)], num_blocks=2))
        .take_all()}
    for how in ("inner", "left_outer", "right_outer", "full_outer"):
        out[how] = left.join(right, on="id", how=how,
                             num_partitions=3).take_all()
    return out


def test_zip_and_joins(pkg):
    _check(pkg, "zip_and_joins", _run(pkg, _zip_and_joins))


def _iter_batches_across_blocks(pkg):
    d = pkg.data
    ds = d.from_numpy({"x": np.arange(46, dtype=np.int32),
                       "m": np.arange(92, dtype=np.float64).reshape(46, 2)}
                      ).repartition(5)
    out = {f"{bs}_{drop}": list(ds.iter_batches(batch_size=bs,
                                                drop_last=drop))
           for bs in (4, 7, 46, 50) for drop in (False, True)}
    return out


def test_iter_batches_across_blocks(pkg):
    _check(pkg, "iter_batches", _run(pkg, _iter_batches_across_blocks))


def _streaming_split_two_epochs(pkg):
    d = pkg.data
    ds = d.range(30, num_blocks=6).map(lambda r: {"id": r["id"],
                                                  "sq": r["id"] ** 2})
    its = ds.streaming_split(2)
    got = {}

    def consume(i):
        got[i] = [[b for b in its[i].iter_batches(batch_size=4)]
                  for _ in range(2)]

    threads = [threading.Thread(target=consume, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert sorted(got) == [0, 1]
    for i in (0, 1):    # the two epochs are the same stream
        assert norm(got[i][0]) == norm(got[i][1])
    return [got[0], got[1]]


def test_streaming_split_two_epochs(pkg):
    _check(pkg, "streaming_split", _run(pkg, _streaming_split_two_epochs))


def _write_then_read(pkg, tmp_path):
    d = pkg.data
    rows = [{"id": i, "name": f"n{i}", "score": i * 0.25}
            for i in range(20)]
    ds = d.from_items(rows, num_blocks=2)
    out = {}
    for fmt in ("json", "csv", "parquet"):
        path = str(tmp_path / fmt)
        files = getattr(ds, f"write_{fmt}")(path)
        out[fmt] = [[os.path.basename(f) for f in files],
                    getattr(d, f"read_{fmt}")(path).take_all()]
        if fmt != "parquet":
            out[fmt].append([open(f, "rb").read() for f in files])
    arr = d.from_numpy({"data": np.arange(30, dtype=np.float32)
                        .reshape(10, 3)})
    files = arr.write_numpy(str(tmp_path / "npy"), column="data")
    out["numpy"] = [d.read_numpy(str(tmp_path / "npy")).take_all(),
                    [open(f, "rb").read() for f in files]]
    rec = d.from_items([{"data": bytes([i]) * (i + 1)} for i in range(9)],
                       num_blocks=3)
    files = rec.write_tfrecords(str(tmp_path / "tfr"))
    out["tfrecords"] = [d.read_tfrecords(str(tmp_path / "tfr")).take_all(),
                        [open(f, "rb").read() for f in files]]
    return out


def test_write_then_read(pkg, tmp_path):
    _check(pkg, "write_then_read", _run(pkg, _write_then_read, tmp_path))


def _torch_batches_on_cpu(pkg):
    d = pkg.data
    ds = d.from_numpy({"tokens": np.arange(60, dtype=np.int32).reshape(
        20, 3), "w": np.linspace(0, 1, 20, dtype=np.float32)}).repartition(3)
    kw = {"device": "cpu"} if pkg.port else {}
    batches = list(ds.iter_torch_batches(batch_size=6, **kw))
    assert all(v.device.type == "cpu" for b in batches for v in b.values())
    return batches


def test_torch_batches_on_cpu(pkg):
    _check(pkg, "torch_batches", _run(pkg, _torch_batches_on_cpu))


def _jax_batches_with_sharding(pkg):
    """A mesh of one CPU rank: JAX's NamedSharding over one CPU device;
    the port's (mesh, logical_sharding(...)) over a gloo group of this
    process alone, which the test ends if it made it."""
    d = pkg.data
    ds = d.from_numpy({"x": np.arange(32, dtype=np.float32).reshape(8, 4),
                       "y": np.arange(8, dtype=np.int32)})
    if pkg.port:
        import torch.distributed as dist

        from ray_tpu_torch.parallel import MeshConfig, make_mesh
        from ray_tpu_torch.parallel.sharding import (FSDP_TP_RULES,
                                                     logical_sharding)

        joined = dist.is_initialized()
        try:
            mesh = make_mesh(MeshConfig(), device_type="cpu")
            sharding = (mesh, logical_sharding(("batch",), mesh,
                                               FSDP_TP_RULES))
            batches = list(ds.iter_jax_batches(batch_size=3,
                                               sharding=sharding))
            assert all(hasattr(v, "full_tensor") for b in batches
                       for v in b.values())
            got = norm(batches)
        finally:
            if not joined and dist.is_initialized():
                dist.destroy_process_group()
    else:
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec

        mesh = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))
        sharding = NamedSharding(mesh, PartitionSpec("data"))
        got = norm(list(ds.iter_jax_batches(batch_size=3,
                                            sharding=sharding)))
    return got


def test_jax_batches_with_sharding(pkg):
    _check(pkg, "jax_batches", _run(pkg, _jax_batches_with_sharding))


def test_torch_batches_default_to_cuda_and_raise_without_it(monkeypatch):
    """``iter_torch_batches()`` (``device=None``) means the card: without
    CUDA it raises at the call, on a Dataset and on a streaming shard,
    before any block is read."""
    import torch

    from ray_tpu_torch import data

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = data.from_numpy({"x": np.arange(4)})
    for call in (lambda: ds.iter_torch_batches(),
                 lambda: ds.iter_jax_batches(),
                 lambda: data.DataIterator(None, 0).iter_torch_batches()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("pkg", ["ray_tpu_torch"], indirect=True)
def test_bench_run_fed_by_a_dataset(pkg):
    """chip_smoke phase 17 (a)'s run (``dataset_fed_run``, 1b_bench on the
    card) on the CPU at ``debug``: bench.run's training fed by
    ``iter_torch_batches(device="cpu")`` over bench.run's own batch rows,
    spread over blocks, gives bench.run's losses bit for bit (the same
    weights, the same batch each step)."""
    import runpy

    import torch

    from ray_tpu_torch import bench
    from ray_tpu_torch.models import llama

    smoke = runpy.run_path(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"), run_name="chip_smoke")
    cfg = bench.CONFIGS["debug"]
    fixed = bench.run("debug", batch=2, seq=16, steps=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    llama.init_params(cfg, gen, "cpu")             # the weights' draws
    rows = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                         dtype=torch.int32).numpy()
    ds = pkg.data.from_numpy({"tokens": np.tile(rows, (3, 1))}) \
        .repartition(4)
    fed = smoke["dataset_fed_run"](
        "debug", 2, 16, 2, torch.device("cpu"),
        ds.iter_torch_batches(batch_size=2, device="cpu"))
    assert fed["losses"] == fixed["losses"]
    assert len(fed["batch_wait_ms"]) == 3
