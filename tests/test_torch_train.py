"""The port's Train (``ray_tpu_torch.train``) against ``ray_tpu.train`` on
the CPU: one module-scoped cluster per package (JAX first, then the
port), and one scenario program run through both packages' Train, taken
from tests/test_train.py. Each part's results are held to stated values
and, for the port, to what ``ray_tpu`` gave on the same part:

- a single worker's reports and ``Result``;
- 2 workers with ``broadcast_from_rank_zero`` and ``barrier``;
- checkpoint report, prune to ``num_to_keep`` and auto-resume: the
  metrics, the kept checkpoint directories and the restored state;
- a failure restart that resumes from the last checkpoint, and
  ``max_failures`` exhausted;
- ``TorchTrainer``'s DDP gradient sync on gloo (2 workers, different data,
  the same weights after 10 steps; ``prepare_data_loader`` shards and
  reshuffles): the weights equal across the packages to 1e-6;
- the ``Checkpoint`` pytree round trip;
- ``datasets=`` feeding a gang of 2 CPU workers through
  ``get_dataset_shard``: the same rows on each rank, and least-squares
  losses within 1e-6 of JAX's.

Then the port alone: a ``use_gpu`` bundle takes the GPU lease path (the
worker sees its grant as ``CUDA_VISIBLE_DEVICES``; ``init(num_gpus=1)``
on the CPU is a plain node count), ``ZeroShardedOptimizer`` over the
port's KV group (its ranks on threads over an in-memory KV) equals
``ray_tpu``'s ``FlatOptimizer`` on the full vector bit for bit, as does
the port's own ``FlatOptimizer`` (``pipeline_spec=`` runs in
tests/test_torch_train_pipeline.py).

Only ``ray_tpu``'s side runs a part once more, on a fresh cluster, when
it fails: tests/conftest.py's module guard ends every JAX-package test
file with a machine-wide ``pkill`` of ``ray_tpu``'s worker command lines,
so under xdist another file's teardown can kill this file's ``ray_tpu``
workers (ROADMAP.md C.2). The port fails on its first error.
"""

import importlib
import json
import os
import threading

import numpy as np
import pytest

from _torch_dist import MemoryKV
from _torch_isolation import _module_isolation_guard  # noqa: F401

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
TIMEOUT = 120
JAX_ATTEMPTS = 3
DDP_TOL = 1e-6   # the same float32 DDP steps on gloo in both packages
_RESULTS = {}    # what ray_tpu gave on each part, for the port to equal


class _Pkg:
    def __init__(self, name):
        self.name = name
        self.rt = importlib.import_module(name)
        self.train = importlib.import_module(f"{name}.train")
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


def _run(p, part, *args):
    """``part(p, *args)``; for ``ray_tpu`` only, again on a fresh cluster
    when it fails (see the module docstring)."""
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
    if not p.port:
        _RESULTS[name] = got
    elif name in _RESULTS:
        assert got == _RESULTS[name], (name, got, _RESULTS[name])


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x, np.float64)


# ------------------------------------------------------------------ parts
# train_fns are made inside functions so cloudpickle ships them by value.

def _single(p, tmp):
    name = p.name

    def train_fn(config):
        train = importlib.import_module(f"{name}.train")
        assert train.get_context().get_world_size() == 1
        for step in range(3):
            train.report({"step": step, "loss": 1.0 / (step + 1)})

    t = p.train
    res = t.JaxTrainer(
        train_fn, scaling_config=t.ScalingConfig(num_workers=1),
        run_config=t.RunConfig(name="single", storage_path=tmp),
    ).fit(timeout_s=TIMEOUT)
    return {"metrics": res.metrics, "checkpoint": res.checkpoint,
            "path_tail": os.path.basename(res.path)}


def test_single_worker_reports_and_result(pkg, tmp_path):
    got = _run(pkg, _single, str(tmp_path))
    assert got == {"metrics": {"step": 2, "loss": 1.0 / 3},
                   "checkpoint": None, "path_tail": "single"}
    _check(pkg, "single", got)


def _broadcast_barrier(p, tmp):
    name = p.name

    def train_fn(config):
        train = importlib.import_module(f"{name}.train")
        ctx = train.get_context()
        token = train.broadcast_from_rank_zero(
            {"seed": 1234} if ctx.get_world_rank() == 0 else None)
        train.barrier()
        token2 = train.broadcast_from_rank_zero(
            "round2" if ctx.get_world_rank() == 0 else None)
        train.barrier(tag="end")
        train.report({"seed": token["seed"], "second": token2,
                      "world": ctx.get_world_size()})

    t = p.train
    res = t.JaxTrainer(
        train_fn, scaling_config=t.ScalingConfig(num_workers=2),
        run_config=t.RunConfig(name="coll", storage_path=tmp),
    ).fit(timeout_s=TIMEOUT)
    return res.metrics


def test_broadcast_and_barrier_across_gang(pkg, tmp_path):
    got = _run(pkg, _broadcast_barrier, str(tmp_path))
    assert got == {"seed": 1234, "second": "round2", "world": 2}
    _check(pkg, "broadcast", got)


def _ckpt_fn(name):
    def train_fn(config):
        train = importlib.import_module(f"{name}.train")
        ctx = train.get_context()
        start, w = 0, np.zeros(2)
        ck = ctx.get_checkpoint()
        if ck is not None:
            state = ck.to_pytree()
            start, w = int(state["step"]) + 1, np.asarray(state["w"])
        for step in range(start, config["total"]):
            w = w + 1.0
            ckpt = train.Checkpoint.from_pytree(
                train.checkpoint_dir(step), {"step": step, "w": w})
            train.report({"step": step}, checkpoint=ckpt)

    return train_fn


def _prune_resume(p, tmp):
    t = p.train
    run = t.RunConfig(name="ckpt", storage_path=tmp,
                      checkpoint_config=t.CheckpointConfig(num_to_keep=2))
    out = {}
    for total in (3, 4):   # the second run auto-resumes on the storage
        res = t.JaxTrainer(_ckpt_fn(p.name),
                           train_loop_config={"total": total},
                           scaling_config=t.ScalingConfig(num_workers=1),
                           run_config=run).fit(timeout_s=TIMEOUT)
        state = res.checkpoint.to_pytree()
        out[total] = {
            "metrics": res.metrics,
            "kept": sorted(e for e in os.listdir(res.path)
                           if e.startswith("checkpoint_")),
            "latest": os.path.basename(res.checkpoint.path),
            "state_step": int(state["step"]),
            "state_w": _np(state["w"]).tolist()}
    return out


def test_checkpoint_report_prune_and_resume(pkg, tmp_path):
    got = _run(pkg, _prune_resume, str(tmp_path))
    assert got[3]["metrics"] == {"step": 2}
    assert got[3]["kept"] == ["checkpoint_00000001", "checkpoint_00000002"]
    assert got[3]["state_step"] == 2 and got[3]["state_w"] == [3.0, 3.0]
    assert got[4]["state_step"] == 3 and got[4]["state_w"] == [4.0, 4.0]
    # a new trainer's manager prunes only what it registered itself
    assert got[4]["kept"] == ["checkpoint_0000000%d" % i for i in (1, 2, 3)]
    _check(pkg, "prune_resume", got)


def _failures(p, tmp):
    name = p.name
    marker = os.path.join(tmp, "attempts")

    def train_fn(config):
        train = importlib.import_module(f"{name}.train")
        ctx = train.get_context()
        start = 0
        ck = ctx.get_checkpoint()
        if ck is not None:
            start = int(ck.to_pytree()["step"]) + 1
        for step in range(start, 3):
            ckpt = train.Checkpoint.from_pytree(
                train.checkpoint_dir(step), {"step": step})
            train.report({"step": step, "start": start}, checkpoint=ckpt)
            if step == 1 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").write("died")
                raise RuntimeError("injected worker failure")

    def broken(config):
        raise RuntimeError("always broken")

    t = p.train
    res = t.JaxTrainer(
        train_fn, train_loop_config={"marker": marker},
        scaling_config=t.ScalingConfig(num_workers=1),
        run_config=t.RunConfig(
            name="failover", storage_path=tmp,
            failure_config=t.FailureConfig(max_failures=2))
    ).fit(timeout_s=TIMEOUT)
    out = {"metrics": res.metrics, "failed_once": os.path.exists(marker),
           "state_step": int(res.checkpoint.to_pytree()["step"])}
    with pytest.raises(t.TrainingFailedError, match="always broken"):
        t.JaxTrainer(
            broken, scaling_config=t.ScalingConfig(num_workers=1),
            run_config=t.RunConfig(
                name="broken", storage_path=tmp,
                failure_config=t.FailureConfig(max_failures=1)),
        ).fit(timeout_s=TIMEOUT)
    return out


def test_failure_restarts_resume_and_exhaust(pkg, tmp_path):
    got = _run(pkg, _failures, str(tmp_path))
    # the restart resumed from step 1's checkpoint, not from scratch
    assert got == {"metrics": {"step": 2, "start": 2}, "failed_once": True,
                   "state_step": 2}
    _check(pkg, "failures", got)


def _ddp(p, tmp):
    name = p.name

    def train_fn(config):
        import torch
        import torch.distributed as dist
        from torch.utils.data import DataLoader, TensorDataset

        train = importlib.import_module(f"{name}.train")
        ctx = train.get_context()
        torch.manual_seed(0)  # same init on every rank
        model = train.prepare_model(torch.nn.Linear(4, 1))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        # DIFFERENT data per rank: without DDP's allreduce the weights
        # would diverge at once
        g = torch.Generator().manual_seed(ctx.get_world_rank())
        x = torch.randn(64, 4, generator=g)
        y = x @ torch.arange(4.0)[:, None] + 1.0
        for _ in range(10):
            opt.zero_grad()
            loss = ((model(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
        flat = torch.cat([q.detach().ravel() for q in model.parameters()])
        gathered = [torch.zeros_like(flat)
                    for _ in range(dist.get_world_size())]
        dist.all_gather(gathered, flat)
        assert torch.equal(gathered[0], gathered[1]), "DDP ranks diverged"
        dl = train.prepare_data_loader(DataLoader(
            TensorDataset(torch.arange(16.0)[:, None]), batch_size=2,
            shuffle=True))
        e1 = [v.item() for b in dl for v in b[0].ravel()]
        e2 = [v.item() for b in dl for v in b[0].ravel()]
        assert len(e1) == 8 and e1 != e2
        if ctx.get_world_rank() == 0:
            train.report({"weights": flat.tolist(), "loss": float(loss),
                          "backend": dist.get_backend()})

    t = p.train
    res = t.TorchTrainer(
        train_fn, scaling_config=t.ScalingConfig(num_workers=2),
        run_config=t.RunConfig(name="torch-ddp", storage_path=tmp),
    ).fit(timeout_s=TIMEOUT)
    return res.metrics


def test_torch_trainer_ddp_gradient_sync(pkg, tmp_path):
    got = _run(pkg, _ddp, str(tmp_path))
    assert got["backend"] == "gloo"          # workers that hold no GPU
    assert np.isfinite(got["loss"])
    if pkg.port:
        want = _RESULTS["ddp"]
        np.testing.assert_allclose(got["weights"], want["weights"],
                                   rtol=DDP_TOL, atol=DDP_TOL)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=DDP_TOL)
    else:
        _RESULTS["ddp"] = got


def _datasets_gang(p, tmp):
    """A gang of 2 CPU workers fed by ``datasets=``: each rank reads its
    ``get_dataset_shard("train")`` (a ``streaming_split`` iterator) and
    takes least-squares SGD steps on its batches with the package's own
    array library (JAX's jnp, the port's torch), reporting every loss and
    the rows it saw."""
    name = p.name

    def train_fn(config):
        train = importlib.import_module(f"{name}.train")
        ctx = train.get_context()
        shard = train.get_dataset_shard("train")
        w = np.zeros(4, np.float32)
        losses, ids = [], []
        if name == "ray_tpu_torch":
            import torch

            batches = shard.iter_torch_batches(batch_size=4,
                                               device="cpu")
            w = torch.from_numpy(w)
        else:
            import jax.numpy as jnp

            batches = ({k: jnp.asarray(v) for k, v in b.items()}
                       for b in shard.iter_batches(batch_size=4))
            w = jnp.asarray(w)
        for b in batches:
            err = b["x"] @ w - b["y"]
            losses.append(float((err * err).mean()))
            w = w - 0.1 * (2.0 / len(err)) * (b["x"].T @ err)
            ids += [int(i) for i in np.asarray(b["id"])]
        # each rank's own record: the gang's last report may be either's
        with open(os.path.join(ctx.get_storage_path(),
                               f"rank{ctx.get_world_rank()}.json"),
                  "w") as f:
            json.dump({"losses": losses, "ids": ids}, f)
        train.report({"done": True})

    rng = np.random.default_rng(21)
    x = rng.standard_normal((24, 4)).astype(np.float32)
    y = (x @ np.array([1.0, -2.0, 0.5, 3.0], np.float32)).astype(np.float32)
    ds = p.data.from_numpy({"id": np.arange(24), "x": x, "y": y}) \
        .repartition(6)
    t = p.train
    res = t.JaxTrainer(
        train_fn, scaling_config=t.ScalingConfig(num_workers=2),
        run_config=t.RunConfig(name="datasets", storage_path=tmp),
        datasets={"train": ds},
    ).fit(timeout_s=TIMEOUT)
    out = []
    for rank in range(2):
        with open(os.path.join(res.path, f"rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def test_datasets_feed_the_gang(pkg, tmp_path):
    pkg.data = importlib.import_module(f"{pkg.name}.data")
    got = _run(pkg, _datasets_gang, str(tmp_path))
    ids = got[0]["ids"] + got[1]["ids"]
    assert sorted(ids) == list(range(24))      # each row on one rank
    for rank in got:
        assert len(rank["losses"]) == -(-len(rank["ids"]) // 4)
    if pkg.port:
        want = _RESULTS["datasets"]
        for g, w in zip(got, want):
            assert g["ids"] == w["ids"]
            np.testing.assert_allclose(g["losses"], w["losses"],
                                       rtol=DDP_TOL)
    else:
        _RESULTS["datasets"] = got


def test_checkpoint_pytree_roundtrip(pkg, tmp_path):
    tree = {"a": np.arange(6.0).reshape(2, 3), "b": {"c": np.float32(2.5)},
            "n": 7}
    back = pkg.train.Checkpoint.from_pytree(str(tmp_path / "ck"),
                                            tree).to_pytree()
    got = {"a": _np(back["a"]).tolist(), "c": float(back["b"]["c"]),
           "n": int(back["n"])}
    assert got == {"a": tree["a"].tolist(), "c": 2.5, "n": 7}
    _check(pkg, "roundtrip", got)
    if pkg.port:   # tensors come back with their bits and dtype
        import torch

        t = {"w": torch.randn(3, 5, dtype=torch.bfloat16), "i": 3}
        b = pkg.train.Checkpoint.from_pytree(str(tmp_path / "t"),
                                             t).to_pytree()
        assert b["w"].dtype == torch.bfloat16
        assert torch.equal(b["w"].view(torch.int16),
                           t["w"].view(torch.int16))


# --------------------------------------------------------- the port alone

@pytest.mark.parametrize("pkg", ["ray_tpu_torch"], indirect=True)
def test_gpu_bundle_takes_the_lease(pkg, tmp_path):
    """A ``use_gpu`` worker is leased its GPU as a ``num_gpus`` actor is:
    it sees the grant as CUDA_VISIBLE_DEVICES, and the GPU comes back
    when the gang ends."""

    def train_fn(config):
        import os

        from ray_tpu_torch import train
        from ray_tpu_torch.train.context import holds_gpu

        train.report({"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                      "holds_gpu": holds_gpu()})

    t = pkg.train
    res = t.JaxTrainer(
        train_fn, scaling_config=t.ScalingConfig(num_workers=1,
                                                 use_gpu=True),
        run_config=t.RunConfig(name="gpu", storage_path=str(tmp_path)),
    ).fit(timeout_s=TIMEOUT)
    assert res.metrics == {"visible": "0", "holds_gpu": True}
    assert t.ScalingConfig(use_gpu=True).bundle() == {"GPU": 1.0}
    import time

    deadline = time.monotonic() + 30
    while pkg.rt.available_resources().get("GPU") != 1.0:
        assert time.monotonic() < deadline, pkg.rt.available_resources()
        time.sleep(0.1)


def test_gpu_lease_without_cuda_refuses(monkeypatch):
    """A worker that holds a GPU lease but cannot reach CUDA raises in
    ``prepare_model`` instead of training on the CPU; one without a lease
    trains on the CPU."""
    import torch

    from ray_tpu_torch.train import prepare_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    with pytest.raises(RuntimeError, match="holds a GPU lease"):
        prepare_model(torch.nn.Linear(2, 2))
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    model = prepare_model(torch.nn.Linear(2, 2))
    assert model.weight.device.type == "cpu"


def test_datasets_and_pipeline_spec_refuse():
    """``datasets=`` is kept for the gang (test_datasets_feed_the_gang runs
    it), and ``get_dataset_shard`` outside a training worker refuses;
    ``pipeline_spec=`` is ported (tests/test_torch_train_pipeline.py runs
    it) and, as in ``ray_tpu``, takes the place of the gang's train loop:
    exactly one of the two."""
    from ray_tpu_torch import train as t

    ds = object()
    assert t.JaxTrainer(lambda: None, datasets={"train": ds}).datasets == {
        "train": ds}
    with pytest.raises(ValueError, match="exactly one"):
        t.JaxTrainer()
    with pytest.raises(ValueError, match="exactly one"):
        t.JaxTrainer(lambda: None, pipeline_spec=object())
    assert t.JaxTrainer(pipeline_spec=object()).pipeline_spec is not None
    with pytest.raises(RuntimeError, match="outside a training worker"):
        t.get_dataset_shard("train")




@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_zero_sharded_matches_flat_optimizer(kind):
    """The port's sharded step == ``ray_tpu``'s full-vector
    ``FlatOptimizer`` step, bit for bit, with per-member optimizer state
    1/W the size (tests/test_train_pipeline.py's case, on the port's KV
    group); and the port's own ``FlatOptimizer.update`` == ``ray_tpu``'s on
    the same vectors, state included."""
    from ray_tpu.train.collectives import FlatOptimizer as JaxFlatOptimizer
    from ray_tpu_torch.collective.kv_group import KVGroup
    from ray_tpu_torch.train import FlatOptimizer, ZeroShardedOptimizer

    W, n, steps = 2, 1003, 3
    rng = np.random.RandomState(0)
    params0 = rng.randn(n).astype(np.float32)
    grads = [[rng.randn(n).astype(np.float32) for _ in range(W)]
             for _ in range(steps)]
    kv, outs, zeros, errors = MemoryKV(), {}, {}, []

    def member(rank):
        try:
            g = KVGroup(kv, W, rank, f"z_{kind}", timeout_s=30)
            zero = ZeroShardedOptimizer(g, FlatOptimizer(kind=kind, lr=0.05))
            zeros[rank] = zero
            p = params0.copy()
            for s in range(steps):
                p = zero.step(p, grads[s][rank], average=True)
            outs[rank] = p
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=member, args=(r,)) for r in range(W)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not errors, errors
    npad = -(-n // W) * W
    opt, ref_opt = FlatOptimizer(kind=kind, lr=0.05), JaxFlatOptimizer(
        kind=kind, lr=0.05)
    state, ref_state = opt.init_state(npad), ref_opt.init_state(npad)
    ref = mine = np.pad(params0, (0, npad - n))
    for s in range(steps):
        g = np.pad(sum(grads[s]), (0, npad - n)) / W
        ref = ref_opt.update(ref, g, ref_state)
        mine = opt.update(mine, g, state)
        np.testing.assert_array_equal(mine, ref)
        assert state.keys() == ref_state.keys()
        for k in state:
            np.testing.assert_array_equal(state[k], ref_state[k])
    for r in range(W):
        np.testing.assert_array_equal(outs[r], ref[:n])
    if kind != "sgd":
        assert zeros[0].state["m"].size == npad // W
