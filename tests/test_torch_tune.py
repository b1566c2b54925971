"""The port's Tune (``ray_tpu_torch.tune``) against ``ray_tpu.tune`` on the
CPU. Held EQUAL across the packages (tolerance: none):

- the trial configs of a search space (grid axes x seeded random domains)
  and the suggestions of the grid, random, Halton and TPE searchers, fed
  the same completions; OptunaSearch's gate;
- the stop and exploit decisions of ASHA, HyperBand, median stopping and
  PBT over one seeded stream of (trial, step, score) reports, and PBT's
  exploit sources and explored configs;

then, on one module-scoped cluster per package (JAX first, then the
port): ``Tuner.fit`` of a deterministic trainable (its score a function
of the config and the step) under ASHA, its results and best result; and
``Tuner.restore`` of an experiment whose trial failed after a
checkpoint, which must resume the same trial from the same checkpoint.

Last, the port alone: ``Tuner(JaxTrainer(...))`` over its CPU ``debug``
Llama trainer (one worker), a two-point learning-rate grid from the JAX
package's init (converted): every trial's losses within 1e-5 relative of
the JAX package's train loop run in this process on the same weights and
batch, and the best trial the lower final loss; concurrent trials over a
trainer, and trials whose worker takes a GPU lease.
"""

import importlib
import os

import numpy as np
import pytest

from _torch_isolation import _module_isolation_guard  # noqa: F401

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
LOSS_RTOL = 1e-5     # the same f32 debug train steps in both packages
TRAIN_STEPS = 3
TUNE_LRS = (1e-3, 3e-2)
JAX_ATTEMPTS = 3
_RESULTS = {}


def _tune(name):
    return importlib.import_module(f"{name}.tune")


def _space(t):
    return {"x": t.uniform(-1.0, 1.0), "lr": t.loguniform(1e-4, 1e-1),
            "n": t.randint(1, 10), "act": t.choice(["relu", "gelu", "tanh"]),
            "g": t.grid_search([1, 2]), "fixed": 5}


def _score(config) -> float:
    """A deterministic objective of a config."""
    return -((config["x"] - 0.3) ** 2) - 0.1 * abs(np.log10(config["lr"])
                                                   + 2) \
        + 0.01 * config["n"] + {"relu": 0.0, "gelu": 0.05,
                                "tanh": -0.05}[config["act"]] + config["g"]


# ------------------------------------------------------- no cluster needed

def _search_run(name):
    t = _tune(name)
    from importlib import import_module

    search = import_module(f"{name}.tune.search")
    out = {"expand": search.expand_param_space(_space(t), 3, seed=4),
           "grid": search.expand_param_space(
               {"a": t.grid_search([1, 2, 3]), "b": t.grid_search(["u", "v"])},
               1)}
    for label, searcher in (("halton", t.HaltonSearch(seed=2)),
                            ("tpe", t.TPESearch(seed=3, n_initial=4))):
        searcher.setup(_space(t), "score", "max")
        got = []
        for tid in range(12):
            cfg = searcher.suggest(tid)
            got.append(cfg)
            searcher.on_trial_complete(tid, {"score": _score(cfg)})
        out[label] = got
    try:
        t.OptunaSearch(seed=0)
        out["optuna"] = "constructed"
    except ImportError as e:
        out["optuna"] = str(e)
    return out


@pytest.mark.parametrize("name", PACKAGES)
def test_search_spaces_and_searchers(name):
    got = _search_run(name)
    if name == "ray_tpu":
        _RESULTS["search"] = got
    else:
        assert got == _RESULTS["search"]


def _scheduler_run(name):
    t = _tune(name)
    rng = np.random.default_rng(11)
    n_trials, max_step = 8, 9
    base = rng.normal(size=n_trials)
    slope = rng.uniform(0.0, 0.3, n_trials)

    def score(tid, step):
        return float(base[tid] + slope[tid] * step)

    out = {}
    for label, make in (
            ("asha", lambda: t.ASHAScheduler(max_t=max_step, grace_period=1,
                                             reduction_factor=3)),
            ("hyperband", lambda: t.HyperBandScheduler(max_t=27, eta=3)),
            ("median", lambda: t.MedianStoppingRule(grace_period=2,
                                                    min_samples_required=2))):
        sched = make()
        live, decisions = set(range(n_trials)), []
        for step in range(1, max_step + 1):
            for tid in sorted(live):
                d = sched.on_result(tid, step, score(tid, step))
                decisions.append((tid, step, d))
                if d == "stop":
                    live.discard(tid)
        out[label] = decisions
    pbt = t.PopulationBasedTraining(
        perturbation_interval=2, quantile_fraction=0.25,
        hyperparam_mutations={"lr": t.uniform(0.001, 0.1),
                              "mom": [0.8, 0.9, 0.99]}, seed=1)
    pbt._population_size = n_trials
    configs = {tid: {"lr": 0.01 * (tid + 1), "mom": 0.9}
               for tid in range(n_trials)}
    decisions = []
    for step in range(1, max_step + 1):
        for tid in range(n_trials):
            d = pbt.on_result(tid, step, score(tid, step))
            if d == "exploit":
                src, new = pbt.exploit(tid, configs)
                configs[tid] = new
                d = (d, src, new)
            decisions.append((tid, step, d))
    out["pbt"] = decisions
    out["pbt_configs"] = configs
    return out


@pytest.mark.parametrize("name", PACKAGES)
def test_scheduler_decisions(name):
    got = _scheduler_run(name)
    assert any(d == "stop" for _, _, d in got["asha"])
    assert any(isinstance(d, tuple) for _, _, d in got["pbt"])
    if name == "ray_tpu":
        _RESULTS["schedulers"] = got
    else:
        assert got == _RESULTS["schedulers"]


# ------------------------------------------------------------- on clusters

class _Pkg:
    def __init__(self, name):
        self.name = name
        self.rt = importlib.import_module(name)
        self.tune = _tune(name)
        self.train = importlib.import_module(f"{name}.train")
        self.port = name == "ray_tpu_torch"

    def start(self):
        if self.port:
            self.rt.init(num_cpus=6, num_gpus=1)
        else:
            self.rt.init(num_cpus=6, num_tpus=0)

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
    if not p.port:
        _RESULTS[name] = got
    else:
        assert name in _RESULTS, f"ray_tpu gave no result for {name}"
        assert got == _RESULTS[name], (name, got, _RESULTS[name])


def _plain(grid):
    return [(r.config, {k: v for k, v in r.metrics.items()}, r.error)
            for r in grid]


def _fit_asha(pkg):
    name = pkg.name

    def trainable(config):
        tune = importlib.import_module(f"{name}.tune")
        for step in range(1, 10):
            tune.report({"score": config["a"] * step - step * step * 0.05
                         + config["b"]})

    t = pkg.tune
    grid = t.Tuner(
        trainable,
        param_space={"a": t.grid_search([0.1, 0.5, 1.0, 0.3]),
                     "b": t.grid_search([0.0, 0.2])},
        tune_config=t.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=1,
            scheduler=t.ASHAScheduler(max_t=9, grace_period=1,
                                      reduction_factor=2)),
    ).fit(timeout_s=120)
    best = grid.get_best_result()
    assert best.config == {"a": 1.0, "b": 0.2}
    return [_plain(grid), best.config, best.metrics]


def test_tuner_fit_with_asha(pkg):
    _check(pkg, "fit_asha", _run(pkg, _fit_asha))


def _restore(pkg, tmp_path):
    import tempfile

    name = pkg.name
    root = tempfile.mkdtemp(dir=str(tmp_path))    # fresh for each attempt
    flag = os.path.join(root, "fail_once")
    open(flag, "w").close()

    def trainable(config):
        tune = importlib.import_module(f"{name}.tune")
        state = tune.get_checkpoint() or {"i": 0}
        for i in range(state["i"], 6):
            tune.report({"score": config["w"] * (i + 1),
                         "resumed_from": state["i"]},
                        checkpoint={"i": i + 1})
            if config["w"] == 2 and i == 2 and os.path.exists(flag):
                raise RuntimeError("planted failure")

    t = pkg.tune
    storage = os.path.join(root, "exp")
    first = t.Tuner(trainable, param_space={"w": t.grid_search([1, 2])},
                    tune_config=t.TuneConfig(metric="score", mode="max",
                                             max_concurrent_trials=1),
                    storage_path=storage).fit(timeout_s=120)
    errors = [bool(r.error) for r in first]
    assert errors == [False, True], errors
    os.remove(flag)
    second = t.Tuner.restore(storage, trainable).fit(timeout_s=120)
    assert all(r.error is None for r in second)
    return [[(r.config, r.metrics) for r in first if r.error is None],
            [(r.config, r.metrics) for r in second]]


def test_tuner_restore_resumes_the_failed_trial(pkg, tmp_path):
    _check(pkg, "restore", _run(pkg, _restore, tmp_path))


# ------------------------------------------- Tuner over each Train trainer

@pytest.fixture(scope="module")
def debug_weights():
    """The JAX package's ``debug`` Llama init as numpy arrays."""
    import jax

    from ray_tpu.models import llama as jllama

    params = jllama.init_params(jllama.CONFIGS["debug"], jax.random.key(0))
    tokens = np.random.default_rng(5).integers(0, 256, (4, 32)).astype(
        np.int32)
    return jax.tree_util.tree_map(np.asarray, params), tokens


def _jax_losses(config):
    """The JAX package's train loop of the f32 ``debug`` Llama, run in this
    process (what a JAX Train worker would run, with no worker for another
    test file's teardown to kill, ROADMAP.md C.2): ``config["steps"]``
    steps at ``config["lr"]`` from ``config["weights"]`` on one batch; the
    loss of each step."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama, training
    from ray_tpu.parallel.mesh import MeshConfig, make_mesh
    from ray_tpu.parallel.sharding import ShardingRules, set_mesh

    cfg = llama.CONFIGS["debug"]
    mesh = make_mesh(MeshConfig(dp=1, fsdp=-1), devices=jax.devices()[:1])
    rules = ShardingRules()
    opt = training.OptimizerConfig(learning_rate=config["lr"],
                                   warmup_steps=1, decay_steps=100).make()
    batch = {"tokens": jnp.asarray(config["tokens"])}
    with set_mesh(mesh):
        state, _ = training.init_train_state(
            lambda key: jax.tree_util.tree_map(jnp.asarray,
                                               config["weights"]),
            llama.param_logical_axes(cfg), opt, mesh, rules,
            jax.random.key(0))
        step = training.make_train_step(
            lambda p, b: llama.loss_fn(p, b, cfg, rules), opt, mesh, rules)
        losses = []
        for _ in range(config["steps"]):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    return losses


def _port_train_fn():
    """The port's train loop, made here so cloudpickle ships it by value:
    the same steps as :func:`_jax_losses` from the converted weights; the
    losses reported once."""

    def train_fn(config):
        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.models import llama, training
        from ray_tpu_torch.models.convert import params_from_jax

        cfg = llama.CONFIGS["debug"]
        opt = training.OptimizerConfig(learning_rate=config["lr"],
                                       warmup_steps=1, decay_steps=100).make()
        state = training.init_train_state(
            lambda g: params_from_jax(config["weights"], device="cpu"), opt,
            None, "cpu")
        step = training.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg),
                                        opt)
        batch = {"tokens": torch.from_numpy(config["tokens"])}
        losses = []
        for _ in range(config["steps"]):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        train.report({"loss": losses[-1], "losses": losses})

    return train_fn


@pytest.mark.parametrize("pkg", ["ray_tpu_torch"], indirect=True)
def test_tuner_over_the_trainer(pkg, tmp_path, debug_weights):
    """``Tuner(JaxTrainer(...))`` on the port's CPU ``debug`` trainer over a
    learning-rate grid: each trial's losses within LOSS_RTOL of the JAX
    package's train loop on the same weights and batch, and the best
    trial the lower final loss."""
    weights, tokens = debug_weights
    config = {"weights": weights, "tokens": tokens, "steps": TRAIN_STEPS}
    tr = pkg.train
    trainer = tr.JaxTrainer(
        _port_train_fn(), train_loop_config=config,
        scaling_config=tr.ScalingConfig(num_workers=1),
        run_config=tr.RunConfig(name="tuned", storage_path=str(tmp_path)))
    t = pkg.tune
    grid = t.Tuner(
        trainer, param_space={"lr": t.grid_search(list(TUNE_LRS))},
        tune_config=t.TuneConfig(metric="loss", mode="min",
                                 max_concurrent_trials=1),
    ).fit(timeout_s=240)
    assert [r.error for r in grid] == [None] * len(TUNE_LRS)
    losses = {r.config["lr"]: r.metrics["losses"] for r in grid}
    assert sorted(losses) == sorted(TUNE_LRS)
    for lr, got in losses.items():
        want = _jax_losses(dict(config, lr=lr))
        assert len(got) == TRAIN_STEPS
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    best = grid.get_best_result()
    assert best.metrics["loss"] == min(v[-1] for v in losses.values())


@pytest.mark.parametrize("pkg", ["ray_tpu_torch"], indirect=True)
def test_concurrent_trials_over_a_trainer(pkg, tmp_path):
    """Four trials over one trainer, two at a time: each trial actor's
    trainer creates its own gang. (A worker's threads outside a task once
    shared the driver's parent task id, so two trial actors minted the
    same TrainWorker id and the second trial failed with "worker already
    running"; the JAX package still does at max_concurrent_trials > 1.)"""
    def train_fn(config):
        from ray_tpu_torch import train

        train.report({"loss": config["lr"] * 2})

    tr = pkg.train
    trainer = tr.JaxTrainer(
        train_fn, scaling_config=tr.ScalingConfig(num_workers=1),
        run_config=tr.RunConfig(name="both", storage_path=str(tmp_path)))
    t = pkg.tune
    grid = t.Tuner(trainer, param_space={"lr": t.grid_search([1, 2, 3, 4])},
                   tune_config=t.TuneConfig(metric="loss", mode="min",
                                            max_concurrent_trials=2),
                   ).fit(timeout_s=120)
    assert [r.error for r in grid] == [None] * 4
    assert [r.metrics["loss"] for r in grid] == [2, 4, 6, 8]
    assert grid.get_best_result().config == {"lr": 1}


@pytest.mark.parametrize("pkg", ["ray_tpu_torch"], indirect=True)
def test_gpu_trials_over_a_trainer_one_at_a_time(pkg, tmp_path):
    """Two trials over a trainer whose worker takes a GPU lease (a plain
    count on the CPU), one at a time, as chip_smoke phase 17 (d) runs
    them: the second trial's gang must not reuse the first's worker id
    (with the shared parent id it waited forever for that dead worker)."""
    def train_fn(config):
        import os

        import torch   # noqa: F401 — as a real trainer's worker does

        from ray_tpu_torch import train

        train.report({"loss": config["lr"],
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})

    tr = pkg.train
    trainer = tr.JaxTrainer(
        train_fn, scaling_config=tr.ScalingConfig(num_workers=1,
                                                  use_gpu=True),
        run_config=tr.RunConfig(name="gpu", storage_path=str(tmp_path)))
    t = pkg.tune
    grid = t.Tuner(trainer, param_space={"lr": t.grid_search([3, 1])},
                   tune_config=t.TuneConfig(metric="loss", mode="min",
                                            max_concurrent_trials=1),
                   ).fit(timeout_s=60)
    assert [r.error for r in grid] == [None, None]
    assert [r.metrics["visible"] for r in grid] == ["0", "0"]
    assert grid.get_best_result().config == {"lr": 1}
    import time

    deadline = time.monotonic() + 30     # the gangs' leases come back
    while pkg.rt.available_resources().get("GPU", 0.0) != 1.0 \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    assert pkg.rt.available_resources().get("GPU", 0.0) == 1.0
