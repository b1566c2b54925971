"""The port's MPMD pipeline training (``ray_tpu_torch.train.pipeline``)
against ``ray_tpu.train.pipeline`` on the CPU: tests/test_train_pipeline.py's
scenarios through both packages, on one cluster per package (JAX first,
then the port).

The stages are its MLPs (2 and 3 dense layers, tanh between): the port's
stage ``init`` returns the JAX init's arrays, so both packages train the
same weights on the same microbatches. Held, each to 1e-5 relative
(tests/test_train_pipeline.py's tolerance):

- 2 stages, M = 4, sgd, 4 steps; 3 stages, M = 4, adam, 2 steps;
  ``data_parallel=2`` (the KV allreduce fold), sgd; ZeRO
  (``zero_sharded_state``) with adam: the step losses and the final stage
  parameters equal to ``ray_tpu``'s;
- a killed stage raises ``PipelineStageError`` from ``step()`` within
  15 s of a 30 s deadline, in both packages;
- ``JaxTrainer(pipeline_spec=)``'s ``Result.metrics`` (step, loss, the
  stage parameters) equal to ``ray_tpu``'s.

The stages run on the CPU (``PipelineSpec(device="cpu")``; the port's
default is the stage's GPU). ``ray_tpu``'s part runs once more on a fresh
cluster when it fails (tests/conftest.py's machine-wide ``pkill`` can
take its workers under xdist, ROADMAP.md C.2); the port fails on its
first error.
"""

import time

import numpy as np
import pytest

from _torch_isolation import _module_isolation_guard  # noqa: F401

D_IN, D_H, D_OUT = 4, 8, 2
RTOL = 1e-5          # tests/test_train_pipeline.py:144
JAX_ATTEMPTS = 3

# name -> (stages, microbatches, PipelineSpec keywords, steps, data seed)
SCENARIOS = {
    "two_stage_sgd": (2, 4, dict(optimizer="sgd", learning_rate=0.05), 4, 7),
    "three_stage_adam": (3, 4, dict(optimizer="adam", learning_rate=0.01),
                         2, 3),
    "data_parallel_sgd": (2, 3, dict(data_parallel=2, optimizer="sgd",
                                     learning_rate=0.05), 2, 5),
    "zero_adam": (2, 3, dict(data_parallel=2, zero_sharded_state=True,
                             optimizer="adam", learning_rate=0.01), 2, 8),
}


def _dims(n):
    return [D_IN] + [D_H] * (n - 1) + [D_OUT]


def _data(seed, count):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, D_IN).astype(np.float32),
             rng.randn(8, D_OUT).astype(np.float32)) for _ in range(count)]


# ------------------------------------------------------------- JAX side

def _jax_stages(n):
    import jax
    import jax.numpy as jnp

    from ray_tpu.train.pipeline import StageSpec

    def make(d_in, d_out, is_last):
        def init(rng):
            return {"w": jax.random.normal(rng, (d_in, d_out)) * 0.3,
                    "b": jnp.zeros((d_out,))}

        def apply(p, x):
            h = x @ p["w"] + p["b"]
            return h if is_last else jnp.tanh(h)

        return StageSpec(init, apply)

    d = _dims(n)
    return [make(d[i], d[i + 1], i == n - 1) for i in range(n)]


def _jax_loss():
    import jax.numpy as jnp

    def loss(pred, y):
        return jnp.mean((pred - y) ** 2)

    return loss


def _jax_inits(n, seed=0):
    """The JAX stages' initial weights, as each stage actor draws them."""
    import jax

    return [jax.tree_util.tree_map(np.asarray,
                                   s.init(jax.random.PRNGKey(seed + i)))
            for i, s in enumerate(_jax_stages(n))]


# ------------------------------------------------------------ port side

def _port_stages(inits):
    """The port's stages: the same MLP, whose init returns ``inits``."""
    from ray_tpu_torch.train.pipeline import StageSpec

    def make(w, b, is_last):
        def init(generator):
            import torch

            return {"w": torch.from_numpy(w.copy()),
                    "b": torch.from_numpy(b.copy())}

        def apply(p, x):
            import torch

            h = x @ p["w"] + p["b"]
            return h if is_last else torch.tanh(h)

        return StageSpec(init, apply)

    return [make(p["w"], p["b"], i == len(inits) - 1)
            for i, p in enumerate(inits)]


def _port_loss():
    def loss(pred, y):
        return ((pred - y) ** 2).mean()

    return loss


# ------------------------------------------------------------- scenarios

def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree.numpy() if hasattr(tree, "numpy") else tree)


def _spec(pkg, name, n_stages, M, kw, **extra):
    import importlib

    pipeline = importlib.import_module(f"{pkg}.train.pipeline")
    if pkg == "ray_tpu":
        stages, loss = _jax_stages(n_stages), _jax_loss()
    else:
        stages, loss = _port_stages(_jax_inits(n_stages)), _port_loss()
        extra["device"] = "cpu"
    return pipeline.PipelineSpec(stages=stages, loss=loss,
                                 num_microbatches=M, **kw, **extra)


def _scenario(pkg, name):
    import importlib

    pipeline = importlib.import_module(f"{pkg}.train.pipeline")
    n, M, kw, steps, seed = SCENARIOS[name]
    spec = _spec(pkg, name, n, M, kw)
    R = spec.data_parallel
    data = _data(seed, M * R * steps)
    runner = pipeline.PipelineRunner(spec)
    losses = []
    try:
        for s in range(steps):
            chunk = data[s * M * R:(s + 1) * M * R]
            losses.append(runner.step([c[0] for c in chunk],
                                      [c[1] for c in chunk])["loss"])
        final = runner.finish()
    finally:
        runner.shutdown()
    return {"losses": losses, "params": [_numpy_tree(p) for p in final]}


def _killed_stage(pkg):
    import importlib

    rt = importlib.import_module(pkg)
    pipeline = importlib.import_module(f"{pkg}.train.pipeline")
    compiled = importlib.import_module(f"{pkg}.graph.compiled")
    runner = pipeline.PipelineRunner(
        _spec(pkg, "kill", 2, 4, dict(learning_rate=0.05)))
    data = _data(0, 4)
    xs, ys = [d[0] for d in data], [d[1] for d in data]
    try:
        assert runner.step(xs, ys)["step"] == 1
        rt.kill(runner._actors[1])
        t0 = time.monotonic()
        with pytest.raises(compiled.PipelineStageError):
            runner.step(xs, ys, timeout_s=30.0)
        return time.monotonic() - t0
    finally:
        runner.shutdown()


def _fit(pkg, storage):
    import importlib

    train = importlib.import_module(f"{pkg}.train")
    data = _data(2, 4 * 3)

    def data_fn(step):
        d = data[step * 4:(step + 1) * 4]
        return [x for x, _ in d], [y for _, y in d]

    spec = _spec(pkg, "fit", 2, 4, dict(learning_rate=0.05), num_steps=3,
                 data_fn=data_fn)
    res = train.JaxTrainer(pipeline_spec=spec, run_config=train.RunConfig(
        name="pipe", storage_path=storage)).fit(timeout_s=120)
    return {"step": res.metrics["step"], "loss": res.metrics["loss"],
            "params": [_numpy_tree(p) for p in res.metrics["stage_params"]],
            "checkpoint": res.checkpoint}


def _parts(pkg, storage):
    out = {name: _scenario(pkg, name) for name in SCENARIOS}
    out["kill_s"] = _killed_stage(pkg)
    out["fit"] = _fit(pkg, storage)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every part through ``ray_tpu`` on its cluster, then through the port
    on its own: {package: {part: result}}."""
    import ray_tpu
    import ray_tpu_torch

    got = {}
    for attempt in range(JAX_ATTEMPTS):
        ray_tpu.init(num_cpus=8, num_tpus=0)
        try:
            got["ray_tpu"] = _parts(
                "ray_tpu", str(tmp_path_factory.mktemp(f"jax{attempt}")))
            break
        except Exception:  # noqa: BLE001 — C.2; the last attempt raises
            if attempt == JAX_ATTEMPTS - 1:
                raise
        finally:
            ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    try:
        got["ray_tpu_torch"] = _parts(
            "ray_tpu_torch", str(tmp_path_factory.mktemp("port")))
    finally:
        ray_tpu_torch.shutdown()
    return got


def _flat(params):
    return np.concatenate([np.concatenate([p[k].ravel() for k in sorted(p)])
                           for p in params])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pipeline_matches_jax(results, name):
    want, got = results["ray_tpu"][name], results["ray_tpu_torch"][name]
    n, M, kw, steps, _ = SCENARIOS[name]
    assert len(got["losses"]) == steps and len(got["params"]) == n
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    np.testing.assert_allclose(_flat(got["params"]), _flat(want["params"]),
                               rtol=RTOL, atol=1e-6)
    # the weights moved: the comparison reads the updates
    start = _flat(_jax_inits(n))
    assert np.abs(_flat(got["params"]) - start).max() > 1e-4


def test_killed_stage_raises_typed_within_deadline(results):
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        assert results[pkg]["kill_s"] < 15.0, (pkg, results[pkg]["kill_s"])


def test_fit_pipeline_matches_jax(results):
    want, got = results["ray_tpu"]["fit"], results["ray_tpu_torch"]["fit"]
    assert got["step"] == want["step"] == 3
    assert got["checkpoint"] is None and want["checkpoint"] is None
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
    np.testing.assert_allclose(_flat(got["params"]), _flat(want["params"]),
                               rtol=RTOL, atol=1e-6)


def test_spec_validation_matches_jax():
    from ray_tpu.train import pipeline as jp
    from ray_tpu_torch.train import pipeline as tp

    stages = _port_stages(_jax_inits(2))
    for mod in (jp, tp):
        with pytest.raises(ValueError):
            mod.PipelineSpec(stages=[], loss=_port_loss())
        with pytest.raises(ValueError):
            mod.PipelineSpec(stages=stages, loss=_port_loss(),
                             num_microbatches=0)
        with pytest.raises(ValueError):
            mod.PipelineSpec(stages=stages, loss=_port_loss(),
                             zero_sharded_state=True)  # needs dp >= 2


def test_stage_on_cuda_needs_a_gpu(monkeypatch):
    """``PipelineSpec.device`` None means CUDA: without it the stage's
    device resolution raises (no silent CPU stage)."""
    import cloudpickle
    import torch

    from ray_tpu_torch.train.pipeline import _PipelineStageActor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    actor = _PipelineStageActor(cloudpickle.dumps(
        {"init": lambda g: {}, "apply": lambda p, x: x}), 0, 1, 1, 0,
        "sgd", 0.1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        actor.run_pipeline(None, None, None, None, None, None)
