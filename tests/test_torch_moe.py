"""ray_tpu_torch.models.moe against ray_tpu.models.moe on the CPU.

Weights are converted from the JAX init; tokens and activations come from
numpy seeds. Tolerances:

- f32 logits 1e-5 absolute; ``aux`` and ``router_z`` 1e-5 relative (the
  same f32 math, summed in another order);
- routing exact: the top-k experts, the 0/1 dispatch tensor and the
  ``dropped`` metric (a count over T·K); the f32 combine weights 1e-6;
- gradients of ``loss_fn`` 1e-4 absolute, as the Llama training tests
  hold their f32 logits; after 3 train steps, losses and gradient norms
  1e-5 relative and parameters as ``tests/test_torch_training.py`` holds
  them (each element 5e-5, the update 1e-4 relative in norm);
- bf16 ``_moe_mlp`` 2e-2 relative in norm (the frameworks round bf16
  products at different points).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models import moe as jmoe
from ray_tpu.models import training as jtraining
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu.parallel.sharding import ShardingRules, set_mesh
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models import training as ttraining
from ray_tpu_torch.models.convert import params_from_jax, train_state_from_jax

from _torch_isolation import _module_isolation_guard  # noqa: F401

OPT = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=20)
STEPS = 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(**kw):
    jc = dataclasses.replace(jmoe.CONFIGS["debug"], **kw)
    tc = dataclasses.replace(tmoe.CONFIGS["debug"], **kw)
    return jc, tc


def _with_base(jc, tc, jax_kw=None, torch_kw=None, **kw):
    """The configs with their Llama backbones replaced: ``kw`` in both,
    ``jax_kw`` and ``torch_kw`` in one (a dtype is each package's own)."""
    return (dataclasses.replace(jc, base=dataclasses.replace(
                jc.base, **kw, **(jax_kw or {}))),
            dataclasses.replace(tc, base=dataclasses.replace(
                tc.base, **kw, **(torch_kw or {}))))


def _bf16(jc, tc):
    return _with_base(jc, tc, jax_kw={"dtype": jnp.bfloat16},
                      torch_kw={"dtype": torch.bfloat16})


def _params(jc, seed=0):
    jp = jmoe.init_params(jc, jax.random.key(seed))
    return jp, params_from_jax(_np_tree(jp))


def _tokens(seed=0, b=4, s=32):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, s)).astype(np.int32)


def _leaf_names(tree, prefix=""):
    """Dotted names in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def _layer0(jp):
    return jax.tree_util.tree_map(lambda a: a[0], jp["layers"])


def _jax_routing(monkeypatch, x, layer, cfg):
    """JAX's ``_moe_mlp`` on one layer, with its top-k indices and its
    (T, E, C) dispatch and combine tensors read where the module hands
    them to ``jax.lax.top_k`` and ``with_logical_constraint``."""
    seen = {"top_idx": [], "tec": []}
    top_k, constrain = jax.lax.top_k, jmoe.with_logical_constraint

    def rec_top_k(x, k):
        w, i = top_k(x, k)
        seen["top_idx"].append(np.asarray(i))
        return w, i

    def rec_constrain(a, axes, rules):
        if tuple(axes) == ("tokens", None, None):
            seen["tec"].append(np.asarray(a))
        return constrain(a, axes, rules)

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jmoe, "with_logical_constraint", rec_constrain)
    out, metrics = jmoe._moe_mlp(jnp.asarray(x), layer, cfg, ShardingRules())
    monkeypatch.undo()
    (top_idx,), (dispatch, combine) = seen["top_idx"], seen["tec"]
    return out, metrics, top_idx, dispatch, combine


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax(seed):
    jc, tc = _configs()
    jp, tp = _params(jc, seed)
    tokens = _tokens(seed)
    jlogits, jm = jmoe.forward(jp, jnp.asarray(tokens), jc)
    with torch.no_grad():
        tlogits, tm = tmoe.forward(tp, torch.from_numpy(tokens), tc)
    assert tlogits.dtype == torch.float32 and tlogits.shape == (4, 32, 256)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-5)
    for k in ("aux", "router_z"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5)
    assert tm["dropped"].item() == float(jm["dropped"])


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_routing_matches_jax_exactly(monkeypatch, capacity_factor):
    """Top-k experts and dispatch slots equal JAX's bit for bit, the
    combine weights to 1e-6, and the layer's output to 1e-5."""
    jc, tc = _configs(capacity_factor=capacity_factor)
    jp, tp = _params(jc, 3)
    x = np.random.default_rng(3).standard_normal((2, 24, 64)).astype(
        np.float32)
    jout, jm, jidx, jdisp, jcomb = _jax_routing(monkeypatch, x,
                                                _layer0(jp), jc)
    tlayer = {k: v[0] for k, v in tp["layers"].items()}
    xt = torch.from_numpy(x)
    with torch.no_grad():
        _, _, _, tidx, tdisp, tcomb, _ = tmoe._route(
            xt.reshape(48, 64), tlayer["router"], tc)
        tout, tm = tmoe._moe_mlp(xt, tlayer, tc)
    assert tdisp.shape == jdisp.shape == (48, 4, tc.capacity(48))
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(tdisp.numpy(), jdisp)
    np.testing.assert_allclose(tcomb.numpy(), jcomb, atol=1e-6)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)
    assert tm["dropped"].item() == float(jm["dropped"])


def test_tie_routes_to_the_lowest_experts(monkeypatch):
    """A zero router gives every expert the same probability: both
    packages take experts 0 and 1 for every token (``jax.lax.top_k``
    puts the lower index first on a tie), and fill their slots in token
    order."""
    jc, tc = _configs()
    jp, tp = _params(jc, 4)
    jlayer = dict(_layer0(jp))
    jlayer["router"] = jnp.zeros_like(jlayer["router"])
    tlayer = {k: v[0] for k, v in tp["layers"].items()}
    tlayer["router"] = torch.zeros_like(tlayer["router"])
    x = np.random.default_rng(4).standard_normal((2, 16, 64)).astype(
        np.float32)
    _, _, jidx, jdisp, _ = _jax_routing(monkeypatch, x, jlayer, jc)
    with torch.no_grad():
        _, probs, top_w, tidx, tdisp, _, _ = tmoe._route(
            torch.from_numpy(x).reshape(32, 64), tlayer["router"], tc)
    assert (probs == 0.25).all()
    want = np.tile([0, 1], (32, 1))
    np.testing.assert_array_equal(jidx, want)
    np.testing.assert_array_equal(tidx.numpy(), want)
    assert (top_w == 0.5).all()
    np.testing.assert_array_equal(tdisp.numpy(), jdisp)


def test_quarter_capacity_drops_as_jax():
    """capacity_factor 0.25 leaves a quarter of the slots: the dropped
    share equals JAX's exactly, and the loss stays finite."""
    jc, tc = _configs(capacity_factor=0.25)
    jp, tp = _params(jc, 2)
    tokens = _tokens(2)
    jloss, jm = jmoe.loss_fn(jp, {"tokens": jnp.asarray(tokens)}, jc)
    with torch.no_grad():
        tloss, tm = tmoe.loss_fn(tp, {"tokens": torch.from_numpy(tokens)}, tc)
    assert tm["dropped_frac"].item() == float(jm["dropped_frac"]) > 0.5
    assert np.isfinite(tloss.item())
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("layer", [0, 1])
def test_per_expert_drops_match_jax_at_8_experts(monkeypatch, layer):
    """8x7b's router shape (8 experts, top-2, capacity factor 1.25) at the
    debug width, 256 tokens: each expert's dropped assignments (those the
    router sent it beyond its slots) equal ``ray_tpu.models.moe``'s."""
    jc, tc = _configs(n_experts=8, top_k=2, capacity_factor=1.25)
    # seeded weights of the JAX init's shapes (that init compiles for
    # seconds at 8 experts), converted for the port
    rng = np.random.default_rng(5)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.3 * rng.standard_normal(a.shape), a.dtype),
        jax.eval_shape(lambda: jmoe.init_params(jc, jax.random.key(0))))
    tp = params_from_jax(_np_tree(jp))
    # activations sharing a direction, as a trained model's do: the
    # router favours some experts and drops at its capacity
    xr = np.random.default_rng(5 + layer)
    x = (xr.standard_normal((4, 64, 64))
         + 2.0 * xr.standard_normal(64)).astype(np.float32)
    jlayer = jax.tree_util.tree_map(lambda a: a[layer], jp["layers"])
    _, jm, jidx, jdisp, _ = _jax_routing(monkeypatch, x, jlayer, jc)
    tlayer = {k: v[layer] for k, v in tp["layers"].items()}
    with torch.no_grad():
        _, _, _, tidx, tdisp, _, _ = tmoe._route(
            torch.from_numpy(x).reshape(256, 64), tlayer["router"], tc)

    def drops(idx, dispatch):
        routed = np.bincount(np.asarray(idx).reshape(-1), minlength=8)
        return routed - np.asarray(dispatch).sum(axis=(0, 2))

    want = drops(jidx, jdisp)
    np.testing.assert_array_equal(drops(tidx.numpy(), tdisp.numpy()), want)
    assert 0 < want.sum() == round(float(jm["dropped"]) * 256 * 2)


def test_single_expert_equals_dense_llama():
    """E=1, K=1 with room for every token: the MoE layer is the dense
    FFN, so the logits equal the port's ``llama.forward`` on the same
    weights with the expert moved into ``w_gate``/``w_up``/``w_down``."""
    one = tmoe.MoEConfig(base=tllama.CONFIGS["debug"], n_experts=1, top_k=1,
                         capacity_factor=2.0)
    params = tmoe.init_params(one, torch.Generator().manual_seed(1), "cpu")
    dense = {k: v for k, v in params.items() if k != "layers"}
    layers = {k: v for k, v in params["layers"].items()
              if k not in ("router", "we_gate", "we_up", "we_down")}
    for name in ("gate", "up", "down"):
        layers[f"w_{name}"] = params["layers"][f"we_{name}"][:, 0]
    dense["layers"] = layers
    tokens = torch.from_numpy(_tokens(5))
    with torch.no_grad():
        got, metrics = tmoe.forward(params, tokens, one)
        want = tllama.forward(dense, tokens, one.base)
    assert metrics["dropped"].item() == 0.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_bf16_layer_matches_jax():
    """bf16 activations: dispatch and combine rounded to bf16 before the
    products, in both packages; the router stays f32."""
    jc, tc = _bf16(*_configs())
    jp, tp = _params(jc, 6)
    assert tp["layers"]["router"].dtype == torch.float32
    assert tp["layers"]["we_up"].dtype == torch.bfloat16
    x = np.random.default_rng(6).standard_normal((2, 16, 64)).astype(
        np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jout, jm = jmoe._moe_mlp(xb, _layer0(jp), jc, ShardingRules())
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    with torch.no_grad():
        tout, tm = tmoe._moe_mlp(xt, {k: v[0] for k, v in
                                      tp["layers"].items()}, tc)
    assert tout.dtype == torch.bfloat16
    want = np.asarray(jout.astype(jnp.float32))
    got = tout.float().numpy()
    assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)
    assert tm["dropped"].item() == float(jm["dropped"])


@pytest.mark.parametrize("remat,policy", [(False, "nothing"),
                                          (True, "nothing"),
                                          (True, "dots")])
def test_loss_gradients_match_jax(remat, policy):
    jc, tc = _with_base(*_configs(), remat=remat, remat_policy=policy)
    jp, tp = _params(jc, 7)
    tokens = _tokens(7)
    rng = np.random.default_rng(7)
    mask = (rng.random(tokens.shape) < 0.8).astype(np.int32)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jmoe.loss_fn(p, {"tokens": jnp.asarray(tokens),
                                   "mask": jnp.asarray(mask)}, jc),
        has_aux=True)(jp)
    leaves = ttraining.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tloss, tm = tmoe.loss_fn(tp, {"tokens": torch.from_numpy(tokens),
                                  "mask": torch.from_numpy(mask)}, tc)
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for k in ("ce", "aux_loss", "router_z"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5)
    assert tm["accuracy"].item() == float(jm["accuracy"])
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, j in zip(grads, jleaves):
        assert g.shape == j.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-4)
    named = dict(zip(_leaf_names(tp), grads))
    for k in ("router", "we_gate", "we_up", "we_down"):
        assert named[f"layers.{k}"].abs().sum() > 0, k


@pytest.fixture(scope="module")
def jax_run():
    """3 JAX train steps of the f32 debug MoE on a 1-device mesh: the
    converted initial state, per-step metrics and the final parameters."""
    cfg = jmoe.CONFIGS["debug"]
    mesh = make_mesh(MeshConfig(dp=1, fsdp=-1), devices=jax.devices()[:1])
    rules = ShardingRules()
    opt = jtraining.OptimizerConfig(**OPT).make()
    batch = {"tokens": jnp.asarray(_tokens(8))}
    metrics = []
    with set_mesh(mesh):
        state, _ = jtraining.init_train_state(
            lambda key: jmoe.init_params(cfg, key),
            jmoe.param_logical_axes(cfg), opt, mesh, rules,
            jax.random.key(8))
        step = jtraining.make_train_step(
            lambda p, b: jmoe.loss_fn(p, b, cfg, rules), opt, mesh, rules)
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
    cfg = tmoe.CONFIGS["debug"]
    opt = ttraining.OptimizerConfig(**OPT).make()
    step = ttraining.make_train_step(lambda p, b: tmoe.loss_fn(p, b, cfg),
                                     opt)
    batch = {"tokens": torch.from_numpy(_tokens(8))}
    state = state0
    for i, j in enumerate(jmetrics):
        state, m = step(state, batch)
        assert m["lr_step"] == j["lr_step"] == i
        assert set(m) == set(j)
        for k in ("loss", "ce", "grad_norm", "aux_loss", "router_z"):
            assert float(m[k]) == pytest.approx(j[k], rel=1e-5), (i, k)
        for k in ("accuracy", "tokens", "dropped_frac"):
            assert float(m[k]) == j[k], (i, k)
    got, want = _flat(state.params), _flat(jparams)
    np.testing.assert_allclose(got, want, atol=5e-5)
    moved = np.linalg.norm(want - start)
    assert moved > 0
    assert np.linalg.norm(got - want) <= 1e-4 * moved


@pytest.mark.parametrize("name", ["debug", "tiny", "8x7b"])
def test_config_arithmetic_matches_jax(name):
    j, t = jmoe.CONFIGS[name], tmoe.CONFIGS[name]
    for f in ("n_experts", "top_k", "capacity_factor", "aux_loss_coef",
              "router_z_coef"):
        assert getattr(t, f) == getattr(j, f), f
    for f in dataclasses.fields(j.base):
        if f.name != "dtype":
            assert getattr(t.base, f.name) == getattr(j.base, f.name)
    assert t.num_params() == j.num_params()
    assert t.active_params() == j.active_params()
    assert t.flops_per_token(2048) == j.flops_per_token(2048)
    for tokens in (1, 7, 48, 4096):
        assert t.capacity(tokens) == j.capacity(tokens)


@pytest.mark.parametrize("bf16", [False, True])
def test_init_tree_counts_and_logical_axes(bf16):
    """``init_params`` has the JAX tree's structure, shapes and dtypes
    (the router f32 also in a bf16 model), ``num_params`` counts it, and
    ``param_logical_axes`` names each leaf's axes, one per dim."""
    jc, tc = _bf16(*_configs()) if bf16 else _configs()
    tp = tmoe.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.eval_shape(lambda: jmoe.init_params(jc, jax.random.key(0)))
    assert sorted(tp) == sorted(shapes)
    assert sorted(tp["layers"]) == sorted(shapes["layers"])
    for t, j in zip(ttraining.tree_leaves(tp),
                    jax.tree_util.tree_leaves(shapes)):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[1] == str(j.dtype)
    assert tp["layers"]["router"].dtype == torch.float32
    assert sum(t.numel() for t in ttraining.tree_leaves(tp)) \
        == tc.num_params()
    axes = tmoe.param_logical_axes(tc)
    assert axes == jmoe.param_logical_axes(jc)
    assert sorted(axes) == sorted(tp)
    for name, leaf in tp.items():
        if name == "layers":
            assert sorted(axes[name]) == sorted(leaf)
            for k, t in leaf.items():
                assert len(axes[name][k]) == t.dim(), k
        else:
            assert len(axes[name]) == leaf.dim(), name


def test_convert_keeps_the_router_f32():
    jc, _ = _bf16(*_configs())
    jp = jmoe.init_params(jc, jax.random.key(9))
    tp = params_from_jax(_np_tree(jp))
    assert tp["layers"]["router"].dtype == torch.float32
    assert tp["layers"]["we_gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["layers"]["router"].numpy(),
                                  np.asarray(jp["layers"]["router"]))


def test_llama_logical_axes_match_jax():
    for name in ("debug", "1b"):
        for tie in (False, True):
            jc = dataclasses.replace(jllama.CONFIGS[name],
                                     tie_embeddings=tie)
            tc = dataclasses.replace(tllama.CONFIGS[name],
                                     tie_embeddings=tie)
            assert tllama.param_logical_axes(tc) == \
                jllama.param_logical_axes(jc)
