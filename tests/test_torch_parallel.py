"""ray_tpu_torch.parallel, the sharded train state, ring and Ulysses
attention and llama's ``sp_axis`` path against the JAX package on the
CPU. The port's side runs in one pool of 4 gloo ranks (``_torch_dist.py``,
spawned once for the module); the JAX side on the 8-device virtual CPU
mesh of tests/conftest.py. Both take the same numpy inputs, and the
port's weights are the JAX init's, converted.

- mesh shapes, abstract meshes, and ``logical_spec`` equal to JAX's
  ``PartitionSpec`` for every ``param_logical_axes`` leaf of the three
  families under the three rule tables;
- each rank's local shard shapes equal to JAX's ``addressable_shards``
  for the device at the same mesh coordinate (``MeshConfig(fsdp=2,
  tp=2)`` over ``jax.devices()[:4]``);
- the sharded ``debug`` loss equal to JAX's sharded loss, rtol and atol
  2e-5 (tests/test_models.py:103's tolerance);
- 3 sharded train steps: losses and grad norms to 1e-5 relative and the
  gathered parameters to 5e-5 absolute and 1e-4 of the update in norm
  (tests/test_torch_training.py's tolerances), the moments placed as
  their parameters;
- ``ring_attention`` at sp=4, modes ring and Ulysses, causal and not:
  outputs to atol 2e-5 (tests/test_ops.py:46) and gradients of sum(out²)
  to 5e-4 (tests/test_ops.py:62);
- the ``sp_axis`` ``debug`` loss against JAX's on the same mesh, 2e-5;
- the MoE's expert axis on ``moe.CONFIGS["debug"]`` (4 experts): each
  rank's local shard shapes equal to JAX's ``addressable_shards`` under
  FSDP_RULES at fsdp=4 (one expert a rank), the sharded loss and router
  metrics (fsdp=4 under FSDP_RULES, fsdp=2 x tp=2 under FSDP_TP_RULES)
  to 2e-5, 3 sharded train steps at fsdp=4 to the Llama steps'
  tolerances, and the ``sp_axis`` loss at sp=4 to 2e-5;
- then the port alone: a sharded tree through ``train.Checkpoint`` (DCP,
  a file a rank) restores bit for bit on the mesh.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import llama as jllama
from ray_tpu.models import moe as jmoe
from ray_tpu.models import training as jtraining
from ray_tpu.models import vit as jvit
from ray_tpu.ops.ring_attention import ring_attention as jring_attention
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsharding

from _torch_dist import RankPool
from _torch_isolation import _module_isolation_guard  # noqa: F401

RULES = ("FSDP_RULES", "TP_RULES", "FSDP_TP_RULES")
LOSS_TOL = 2e-5       # tests/test_models.py:103
RING_TOL = 2e-5       # tests/test_ops.py:46
GRAD_TOL = 5e-4       # tests/test_ops.py:62
OPT = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=20)
STEPS = 3


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def debug_params():
    cfg = jllama.CONFIGS["debug"]
    return cfg, jllama.init_params(cfg, jax.random.key(0))


def _tokens(seed=1, b=4, s=16):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _jmesh(devices=None, **kw):
    return jmesh.make_mesh(jmesh.MeshConfig(**kw), devices=devices)


# ----------------------------------------------------------- pure functions

@pytest.mark.parametrize("n, kw", [
    (8, {}), (8, {"fsdp": 2, "tp": 2, "dp": -1}), (4, {"sp": 4, "fsdp": 1}),
    (8, {"dp": 2, "fsdp": 2, "sp": 2}), (1, {})])
def test_mesh_shapes_match_jax(n, kw):
    tc, jc = tmesh.MeshConfig(**kw), jmesh.MeshConfig(**kw)
    assert tc.resolve(n) == jc.resolve(n)
    assert tmesh.mesh_shape_for(n, tc) == jmesh.mesh_shape_for(n, jc)
    ta, ja = tmesh.get_abstract_mesh(n, tc), jmesh.get_abstract_mesh(n, jc)
    assert ta.axis_names == tuple(ja.axis_names)
    assert ta.axis_sizes == tuple(ja.axis_sizes)
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tmesh.stage_device_slices(2, range(n * 2)) == \
        [list(s) for s in jmesh.stage_device_slices(2, list(range(n * 2)))]
    with pytest.raises(ValueError):
        tmesh.MeshConfig(fsdp=-1, tp=-1).resolve(n)


def _pairs(t_axes, j_axes):
    """(port axes, JAX axes) leaf pairs of two logical-axes trees."""
    if isinstance(j_axes, dict):
        assert set(t_axes) == set(j_axes)
        return [p for k in j_axes for p in _pairs(t_axes[k], j_axes[k])]
    return [(t_axes, j_axes)]


@pytest.mark.parametrize("rules", RULES)
def test_logical_specs_match_jax(rules):
    tr, jr = getattr(tsharding, rules), getattr(jsharding, rules)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert tsharding.LOGICAL_AXES == jsharding.LOGICAL_AXES
    trees = [(tllama.param_logical_axes(tllama.CONFIGS[n]),
              jllama.param_logical_axes(jllama.CONFIGS[n]))
             for n in ("debug", "8b")]
    trees += [(tmoe.param_logical_axes(tmoe.CONFIGS["debug"]),
               jmoe.param_logical_axes(jmoe.CONFIGS["debug"])),
              (tvit.param_logical_axes(tvit.CONFIGS["debug"]),
               jvit.param_logical_axes(jvit.CONFIGS["debug"]))]
    n = 0
    for t_axes, j_axes in trees:
        for ta, ja in _pairs(t_axes, j_axes):
            assert ta == ja
            assert tsharding.logical_spec(ta, tr) == tuple(
                jsharding.logical_spec(ja, jr)), (ta, rules)
            n += 1
    assert n > 30


# ------------------------------------------------------------- on 4 ranks

def test_local_shard_shapes_match_jax(pool, debug_params):
    cfg, jp = debug_params
    axes = jllama.param_logical_axes(cfg)
    mesh = _jmesh(jax.devices()[:4], fsdp=2, tp=2)
    with jsharding.set_mesh(mesh):
        placed = jsharding.shard_pytree(jp, axes, mesh,
                                        jsharding.FSDP_TP_RULES)
    got = pool.run("mesh_and_shards", {"fsdp": 2, "tp": 2},
                   "FSDP_TP_RULES", _np_tree(jp), axes)
    devices = mesh.devices

    def jax_shapes(tree, device):
        if isinstance(tree, dict):
            return {k: jax_shapes(v, device) for k, v in tree.items()}
        (shard,) = [s for s in tree.addressable_shards if s.device == device]
        return tuple(shard.data.shape)

    seen = set()
    for r in got:
        assert r["shape"] == devices.shape
        assert tuple(r["names"]) == tuple(mesh.axis_names)
        coord = tuple(r["coordinate"])
        seen.add(coord)
        assert r["local_shapes"] == jax_shapes(placed, devices[coord]), coord
    assert len(seen) == 4
    # a sharded leaf really is split: wq's embed dim over fsdp, heads
    # over tp
    wq = got[0]["local_shapes"]["layers"]["wq"]
    assert wq[1] == cfg.hidden // 2 and wq[2] == cfg.n_heads // 2


@pytest.mark.parametrize("config_kw, rules", [
    ({"fsdp": 2, "tp": 2}, "FSDP_TP_RULES"),
    ({"dp": 2, "fsdp": 2}, "FSDP_RULES")])
def test_sharded_loss_matches_jax(pool, debug_params, config_kw, rules):
    cfg, jp = debug_params
    tokens = _tokens()
    jr = jsharding.FSDP_TP_RULES
    mesh = _jmesh(dp=2, fsdp=2, tp=2)
    with jsharding.set_mesh(mesh):
        sharded = jsharding.shard_pytree(jp, jllama.param_logical_axes(cfg),
                                         mesh, jr)
        jloss, jaux = jax.jit(lambda p, b: jllama.loss_fn(p, b, cfg, jr))(
            sharded, {"tokens": jnp.asarray(tokens)})
    got = pool.run("sharded_loss", config_kw, rules, _np_tree(jp), tokens)
    for r in got:   # every rank holds the same loss
        np.testing.assert_allclose(r["loss"], float(jloss), rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        assert r["accuracy"] == float(jaux["accuracy"])
        assert r["tokens"] == float(jaux["tokens"])


def _flat(tree):
    if isinstance(tree, dict):
        return np.concatenate([_flat(tree[k]) for k in sorted(tree)])
    return np.asarray(tree, np.float32).ravel()


def test_sharded_train_steps_match_jax(pool, debug_params):
    cfg, _ = debug_params
    tokens = _tokens(seed=3)
    rules = jsharding.FSDP_TP_RULES
    mesh = _jmesh(jax.devices()[:4], fsdp=2, tp=2)
    opt = jtraining.OptimizerConfig(**OPT).make()
    with jsharding.set_mesh(mesh):
        state, _ = jtraining.init_train_state(
            lambda key: jllama.init_params(cfg, key),
            jllama.param_logical_axes(cfg), opt, mesh, rules,
            jax.random.key(0))
        start = _np_tree(state.params)
        step = jtraining.make_train_step(
            lambda p, b: jllama.loss_fn(p, b, cfg, rules), opt, mesh, rules)
        jmetrics = []
        for _ in range(STEPS):
            state, m = step(state, {"tokens": jnp.asarray(tokens)})
            jmetrics.append({k: float(v) for k, v in m.items()})
    want = _np_tree(state.params)
    got = pool.run("sharded_train", {"fsdp": 2, "tp": 2}, "FSDP_TP_RULES",
                   start, tokens, OPT, STEPS)
    for r in got:
        for i, (t, j) in enumerate(zip(r["metrics"], jmetrics)):
            assert t["lr_step"] == j["lr_step"] == i
            for k in ("loss", "grad_norm"):
                assert t[k] == pytest.approx(j[k], rel=1e-5), (i, k)
            assert t["tokens"] == j["tokens"]
        # the moments take their parameter's placements; counts replicate
        assert r["mu_wq_placements"] == r["wq_placements"] == \
            r["sharding_mu_wq"] == r["sharding_wq"] == ["S(1)", "S(2)"]
        assert r["sharding_step"] == ["R", "R"]
        g, w, p0 = _flat(r["params"]), _flat(want), _flat(start)
        np.testing.assert_allclose(g, w, atol=5e-5)
        moved = np.linalg.norm(w - p0)
        assert moved > 0
        assert np.linalg.norm(g - w) <= 1e-4 * moved
    assert jmetrics[-1]["loss"] < jmetrics[0]["loss"]


def _qkv(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32)
                 for _ in range(3))


@pytest.fixture(scope="module")
def ring_mesh():
    return _jmesh(fsdp=2, sp=4)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(pool, ring_mesh, mode, causal):
    q, k, v = _qkv(2, 2, 64, 4, 16)
    want = jax.jit(lambda q, k, v: jring_attention(
        q, k, v, ring_mesh, causal=causal, mode=mode, block=16))(q, k, v)
    got = pool.run("ring", {"fsdp": 1, "sp": 4}, q, k, v, causal, mode, 16,
                   False)
    for r in got:
        np.testing.assert_allclose(r["out"], np.asarray(want), atol=RING_TOL,
                                   rtol=RING_TOL)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_ring_attention_grads_match_jax(pool, ring_mesh, mode):
    q, k, v = _qkv(3, 2, 32, 4, 16)

    def loss(q, k, v):
        return jnp.sum(jring_attention(q, k, v, ring_mesh, causal=True,
                                            mode=mode, block=8) ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    got = pool.run("ring", {"fsdp": 1, "sp": 4}, q, k, v, True, mode, 8,
                   True)
    for name, w in zip(("dq", "dk", "dv"), want):
        np.testing.assert_allclose(got[0][name], np.asarray(w),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)
        np.testing.assert_array_equal(got[3][name], got[0][name])


def test_sp_axis_loss_matches_jax(pool, debug_params):
    cfg, jp = debug_params
    jcfg = dataclasses.replace(cfg, sp_axis="sp")
    tokens = _tokens(seed=4)
    rules = jsharding.FSDP_TP_RULES
    mesh = _jmesh(jax.devices()[:4], fsdp=1, sp=2, tp=2)
    with jsharding.set_mesh(mesh):
        sharded = jsharding.shard_pytree(
            jp, jllama.param_logical_axes(cfg), mesh, rules)
        jloss, _ = jax.jit(lambda p, b: jllama.loss_fn(
            p, b, jcfg, rules, mesh=mesh))(sharded,
                                           {"tokens": jnp.asarray(tokens)})
    got = pool.run("sharded_loss", {"fsdp": 1, "sp": 2, "tp": 2},
                   "FSDP_TP_RULES", _np_tree(jp), tokens, "sp")
    for r in got:
        np.testing.assert_allclose(r["loss"], float(jloss), rtol=LOSS_TOL,
                                   atol=LOSS_TOL)


# ------------------------------------------------- the MoE's expert axis

MOE_METRICS = ("aux_loss", "router_z", "dropped_frac", "ce")


@pytest.fixture(scope="module")
def moe_run():
    """JAX's side of the expert-axis tests, computed once: the debug MoE's
    train state on a fsdp=4 mesh under FSDP_RULES (the weights placed by
    the rule table), its initial parameters, the metrics of 3 train steps
    (the first step's are the loss at the initial parameters) and the
    parameters after them."""
    cfg = jmoe.CONFIGS["debug"]
    tokens = _tokens(seed=6)
    rules = jsharding.FSDP_RULES
    mesh = _jmesh(jax.devices()[:4], fsdp=4)
    opt = jtraining.OptimizerConfig(**OPT).make()
    with jsharding.set_mesh(mesh):
        state, _ = jtraining.init_train_state(
            lambda key: jmoe.init_params(cfg, key),
            jmoe.param_logical_axes(cfg), opt, mesh, rules,
            jax.random.key(0))
        # each device's shard shapes, before the steps donate the state
        shards = {name: {sh.device: tuple(sh.data.shape)
                         for sh in state.params["layers"][name]
                         .addressable_shards}
                  for name in ("we_gate", "we_up", "we_down", "router")}
        start = _np_tree(state.params)
        step = jtraining.make_train_step(
            lambda p, b: jmoe.loss_fn(p, b, cfg, rules, mesh=mesh), opt,
            mesh, rules)
        jmetrics = []
        for _ in range(STEPS):
            state, m = step(state, {"tokens": jnp.asarray(tokens)})
            jmetrics.append({k: float(v) for k, v in m.items()})
    return {"cfg": cfg, "tokens": tokens, "mesh": mesh, "shards": shards,
            "start": start, "metrics": jmetrics,
            "final": _np_tree(state.params)}


def test_moe_local_shard_shapes_match_jax(pool, moe_run):
    cfg = moe_run["cfg"]
    axes = jmoe.param_logical_axes(cfg)
    got = pool.run("mesh_and_shards", {"fsdp": 4}, "FSDP_RULES",
                   moe_run["start"], axes)
    devices = moe_run["mesh"].devices
    for r in got:
        coord = tuple(r["coordinate"])
        for name, by_device in moe_run["shards"].items():
            assert r["local_shapes"]["layers"][name] == \
                by_device[devices[coord]], (name, coord)
    # the experts really are split, one a rank
    assert got[0]["local_shapes"]["layers"]["we_gate"][1] == \
        cfg.n_experts // 4


@pytest.mark.parametrize("config_kw, rules", [
    ({"fsdp": 4}, "FSDP_RULES"),
    ({"fsdp": 2, "tp": 2}, "FSDP_TP_RULES")])
def test_moe_sharded_loss_matches_jax(pool, moe_run, config_kw, rules):
    """The loss at the initial weights: JAX's first train step's."""
    want = moe_run["metrics"][0]
    got = pool.run("sharded_loss", config_kw, rules, moe_run["start"],
                   moe_run["tokens"], None, "moe")
    for r in got:
        for k in ("loss",) + MOE_METRICS:
            np.testing.assert_allclose(r[k], want[k], rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=k)
        assert r["tokens"] == want["tokens"]


def test_moe_sharded_train_steps_match_jax(pool, moe_run):
    got = pool.run("sharded_train", {"fsdp": 4}, "FSDP_RULES",
                   moe_run["start"], moe_run["tokens"], OPT, STEPS, "moe")
    for r in got:
        for i, (t, j) in enumerate(zip(r["metrics"], moe_run["metrics"])):
            for k in ("loss", "grad_norm", "aux_loss"):
                assert t[k] == pytest.approx(j[k], rel=1e-5), (i, k)
        g, w, p0 = (_flat(r["params"]), _flat(moe_run["final"]),
                    _flat(moe_run["start"]))
        np.testing.assert_allclose(g, w, atol=5e-5)
        moved = np.linalg.norm(w - p0)
        assert moved > 0
        assert np.linalg.norm(g - w) <= 1e-4 * moved


def test_moe_sp_axis_loss_matches_jax(pool, moe_run):
    cfg, jp = moe_run["cfg"], moe_run["start"]
    tokens = _tokens(seed=7)
    jcfg = dataclasses.replace(cfg, base=dataclasses.replace(
        cfg.base, sp_axis="sp"))
    rules = jsharding.FSDP_RULES
    mesh = _jmesh(jax.devices()[:4], fsdp=1, sp=4)
    with jsharding.set_mesh(mesh):
        sharded = jsharding.shard_pytree(
            jp, jmoe.param_logical_axes(cfg), mesh, rules)
        jloss, jaux = jax.jit(lambda p, b: jmoe.loss_fn(
            p, b, jcfg, rules, mesh=mesh))(
                sharded, {"tokens": jnp.asarray(tokens)})
    got = pool.run("sharded_loss", {"fsdp": 1, "sp": 4}, "FSDP_RULES",
                   jp, tokens, "sp", "moe")
    for r in got:
        np.testing.assert_allclose(r["loss"], float(jloss), rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(r["aux_loss"], float(jaux["aux_loss"]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)


def test_moe_sp_axis_refuses_without_a_mesh():
    import torch

    cfg = tmoe.CONFIGS["debug"]
    cfg = dataclasses.replace(cfg, base=dataclasses.replace(
        cfg.base, sp_axis="sp"))
    params = tmoe.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="needs a mesh"):
        tmoe.loss_fn(params, {"tokens": torch.zeros(2, 8, dtype=torch.long)},
                     cfg)


def test_sharded_checkpoint_restores_bit_equal(pool, debug_params, tmp_path):
    """A tree of DTensors through ``train.Checkpoint`` (DCP): each rank
    writes its own file, and the restore fills a target on the live mesh
    with the saved shards' bits."""
    cfg, jp = debug_params
    got = pool.run("checkpoint_roundtrip", {"fsdp": 2, "tp": 2},
                   str(tmp_path / "ck"), _np_tree(jp),
                   jllama.param_logical_axes(cfg))
    for r in got:
        assert r["equal"] and r["count"] == 7
    assert len(got[0]["files"]) == 4, got[0]["files"]


def test_sp_axis_refuses_without_a_mesh():
    cfg = dataclasses.replace(tllama.CONFIGS["debug"], sp_axis="sp")
    import torch

    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    with pytest.raises(NotImplementedError, match="needs a mesh"):
        tllama.loss_fn(params, {"tokens": torch.zeros(2, 8, dtype=torch.long)},
                       cfg)
