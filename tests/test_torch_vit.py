"""ray_tpu_torch.models.vit against ray_tpu.models.vit on the CPU.

Weights are converted from the JAX init (the zero-initialised head is
replaced by a seeded one where the logits are compared, so they depend on
the whole network); images and labels come from numpy seeds. Tolerances:
patchify exact (reshapes only); f32 logits 1e-5 absolute and loss 1e-5
relative; gradients 1e-4 absolute, as the Llama training tests; after 3
train steps, losses and gradient norms 1e-5 relative and parameters as
``tests/test_torch_training.py`` holds them (each element 5e-5, the
update 1e-4 relative in norm).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import training as jtraining
from ray_tpu.models import vit as jvit
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu.parallel.sharding import ShardingRules, set_mesh
from ray_tpu_torch.models import training as ttraining
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.models.convert import params_from_jax, train_state_from_jax

from _torch_isolation import _module_isolation_guard  # noqa: F401

OPT = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=20)
STEPS = 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(cfg, seed=0, head=True):
    """JAX init of ``cfg``, with a seeded (nonzero) head if ``head``; the
    JAX tree and its conversion."""
    jp = jvit.init_params(cfg, jax.random.key(seed))
    if head:
        rng = np.random.default_rng(seed + 100)
        jp["head_w"] = jnp.asarray(0.2 * rng.standard_normal(
            jp["head_w"].shape).astype(np.float32))
        jp["head_b"] = jnp.asarray(0.1 * rng.standard_normal(
            jp["head_b"].shape).astype(np.float32))
    return jp, params_from_jax(_np_tree(jp))


def _batch(cfg, seed=0, b=4):
    rng = np.random.default_rng(seed)
    return {"images": rng.random((b, cfg.image_size, cfg.image_size,
                                  cfg.channels)).astype(np.float32),
            "labels": rng.integers(0, cfg.num_classes, b).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("patch", [4, 8, 16])
def test_patchify_equals_jax(patch):
    rng = np.random.default_rng(patch)
    imgs = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
    want = np.asarray(jvit.patchify(jnp.asarray(imgs), patch))
    got = tvit.patchify(torch.from_numpy(imgs), patch).numpy()
    assert got.shape == (2, (32 // patch) * (48 // patch), patch * patch * 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_logits_and_loss_match_jax(seed):
    jc, tc = jvit.CONFIGS["debug"], tvit.CONFIGS["debug"]
    jp, tp = _params(jc, seed)
    batch = _batch(jc, seed)
    jlogits = jvit.forward(jp, jnp.asarray(batch["images"]), jc)
    jloss, jm = jvit.loss_fn(jp, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, jc)
    with torch.no_grad():
        tlogits = tvit.forward(tp, torch.from_numpy(batch["images"]), tc)
        tloss, tm = tvit.loss_fn(tp, _torch_batch(batch), tc)
    assert tlogits.dtype == torch.float32 and tlogits.shape == (4, 10)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-5)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert tm["accuracy"].item() == float(jm["accuracy"])


def test_gelu_is_the_tanh_form(monkeypatch):
    """With MLP pre-activations of a few units, where erf-GELU and
    tanh-GELU part: the port's logits meet JAX's 1e-5 with the tanh form,
    and an erf GELU put in its place misses it by more than 10x."""
    jc, tc = jvit.CONFIGS["debug"], tvit.CONFIGS["debug"]
    jp, tp = _params(jc, 2)
    rng = np.random.default_rng(2)
    w_in = (rng.standard_normal(jp["layers"]["w_in"].shape) * 0.5).astype(
        np.float32)
    jp["layers"]["w_in"] = jnp.asarray(w_in)
    tp["layers"]["w_in"] = torch.from_numpy(w_in.copy())
    images = _batch(jc, 2)["images"]
    want = np.asarray(jvit.forward(jp, jnp.asarray(images), jc))

    def logits():
        with torch.no_grad():
            return tvit.forward(tp, torch.from_numpy(images), tc).numpy()

    np.testing.assert_allclose(logits(), want, atol=1e-5)
    monkeypatch.setattr(tvit, "gelu", torch.nn.functional.gelu)
    assert np.abs(logits() - want).max() > 1e-4


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_jax(remat):
    jc = dataclasses.replace(jvit.CONFIGS["debug"], remat=remat)
    tc = dataclasses.replace(tvit.CONFIGS["debug"], remat=remat)
    jp, tp = _params(jc, 3)
    batch = _batch(jc, 3)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jvit.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jc), has_aux=True)(jp)
    leaves = ttraining.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tloss, _ = tvit.loss_fn(tp, _torch_batch(batch), tc)
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, j in zip(grads, jleaves):
        assert g.shape == j.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-4)
    assert all(g.abs().sum() > 0 for g in grads)


@pytest.fixture(scope="module")
def jax_run():
    """3 JAX train steps of the f32 debug ViT (its own zero head) on a
    1-device mesh: the converted initial state, per-step metrics and the
    final parameters."""
    cfg = jvit.CONFIGS["debug"]
    mesh = make_mesh(MeshConfig(dp=1, fsdp=-1), devices=jax.devices()[:1])
    rules = ShardingRules()
    opt = jtraining.OptimizerConfig(**OPT).make()
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg, 4, b=8).items()}
    metrics = []
    with set_mesh(mesh):
        state, _ = jtraining.init_train_state(
            lambda key: jvit.init_params(cfg, key),
            jvit.param_logical_axes(cfg), opt, mesh, rules,
            jax.random.key(4))
        step = jtraining.make_train_step(
            lambda p, b: jvit.loss_fn(p, b, cfg, rules), opt, mesh, rules)
        state0 = train_state_from_jax(state)
        for _ in range(STEPS):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    return state0, metrics, _np_tree(state.params)


def _flat(params):
    return np.concatenate([np.asarray(t.detach() if isinstance(
        t, torch.Tensor) else t).ravel()
        for t in ttraining.tree_leaves(params)])


def test_train_steps_match_jax(jax_run):
    state0, jmetrics, jparams = jax_run
    start = _flat(state0.params)
    cfg = tvit.CONFIGS["debug"]
    opt = ttraining.OptimizerConfig(**OPT).make()
    step = ttraining.make_train_step(lambda p, b: tvit.loss_fn(p, b, cfg),
                                     opt)
    batch = _torch_batch(_batch(cfg, 4, b=8))
    state = state0
    losses = []
    for i, j in enumerate(jmetrics):
        state, m = step(state, batch)
        assert m["lr_step"] == j["lr_step"] == i
        assert set(m) == set(j)
        for k in ("loss", "grad_norm"):
            assert float(m[k]) == pytest.approx(j[k], rel=1e-5), (i, k)
        assert float(m["accuracy"]) == j["accuracy"]
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    got, want = _flat(state.params), _flat(jparams)
    np.testing.assert_allclose(got, want, atol=5e-5)
    moved = np.linalg.norm(want - start)
    assert moved > 0
    assert np.linalg.norm(got - want) <= 1e-4 * moved


@pytest.mark.parametrize("name", ["debug", "S16", "B16", "L16"])
def test_config_arithmetic_matches_jax(name):
    j, t = jvit.CONFIGS[name], tvit.CONFIGS[name]
    for f in dataclasses.fields(j):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    for p in ("head_dim", "num_patches", "seq_len", "patch_dim"):
        assert getattr(t, p) == getattr(j, p), p
    assert t.num_params() == j.num_params()
    assert t.flops_per_image() == j.flops_per_image()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_counts_and_logical_axes(dtype):
    """``init_params`` has the JAX tree's structure, shapes and dtypes, the
    head zero as in JAX, ``num_params`` counts it, and
    ``param_logical_axes`` names each leaf's axes, one per dim."""
    jc = dataclasses.replace(jvit.CONFIGS["debug"], dtype=getattr(jnp, dtype))
    tc = dataclasses.replace(tvit.CONFIGS["debug"],
                             dtype=getattr(torch, dtype))
    tp = tvit.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.eval_shape(lambda: jvit.init_params(jc, jax.random.key(0)))
    assert sorted(tp) == sorted(shapes)
    for t, j in zip(ttraining.tree_leaves(tp),
                    jax.tree_util.tree_leaves(shapes)):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[1] == str(j.dtype)
    assert (tp["head_w"] == 0).all() and (tp["cls_token"] == 0).all()
    assert (tp["layers"]["ln1_w"] == 1).all()
    assert sum(t.numel() for t in ttraining.tree_leaves(tp)) \
        == tc.num_params()
    axes = tvit.param_logical_axes(tc)
    assert axes == jvit.param_logical_axes(jc)
    for name, leaf in tp.items():
        if name == "layers":
            assert sorted(axes[name]) == sorted(leaf)
            for k, t in leaf.items():
                assert len(axes[name][k]) == t.dim(), k
        else:
            assert len(axes[name]) == leaf.dim(), name
