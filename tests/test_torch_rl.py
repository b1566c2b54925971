"""The port's RL PPO path (``ray_tpu_torch.rl``) against ``ray_tpu.rl`` on
the CPU.

- the envs (CartPole, its masked-velocity POMDP, Pendulum): trajectories
  from one seed and one action sequence bit-equal;
- ``torch_forward`` and ``torch_lstm_forward_seq`` (and a step of the
  LSTM cell) against ``jax_forward`` and ``jax_lstm_forward_seq`` on the
  same numpy-initialised weights, 1e-6;
- ``EnvRunner`` fragments (feedforward and LSTM, vectorised) bit-equal,
  then ``compute_gae`` and ``build_ppo_batch`` equal;
- ``PPOLearner.update`` (MLP, and LSTM over (B, L) windows) from the same
  params, batch and seed: metrics and weights within 1e-5 relative
  (weights also 1e-6 absolute: biases start at 0) of the JAX learner's;
- on one cluster per package (JAX first): a 2-learner ``LearnerGroup`` on
  the KV backend, one synchronized update: metrics and weights within
  1e-5 of JAX's; 2 PPO iterations with 2 env runners: the same
  ``num_env_steps_sampled`` and weights within 1e-4;
- every public name of ``ray_tpu.rl`` exists in the port, and none
  refuses.

The port's learners run on the CPU (``device="cpu"``,
``learner_device="cpu"``; their default is CUDA). ``ray_tpu``'s cluster
part runs once more on a fresh cluster when it fails (tests/conftest.py's
machine-wide ``pkill`` can take its workers under xdist, ROADMAP.md
C.2).
"""

import numpy as np
import pytest
import torch

from ray_tpu.rl import envs as jenvs
from ray_tpu.rl import learner as jlearner
from ray_tpu.rl import module as jmodule
from ray_tpu.rl.env_runner import EnvRunner as JEnvRunner
from ray_tpu_torch.rl import envs as tenvs
from ray_tpu_torch.rl import learner as tlearner
from ray_tpu_torch.rl import module as tmodule
from ray_tpu_torch.rl.env_runner import EnvRunner as TEnvRunner

from _torch_isolation import _module_isolation_guard  # noqa: F401

FWD_TOL = 1e-6
LEARNER_RTOL = 1e-5
ITER_TOL = 1e-4
JAX_ATTEMPTS = 3
PPO_KW = dict(lr=1e-3, num_epochs=2, minibatch_size=64, seed=3)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ------------------------------------------------------------------ envs

@pytest.mark.parametrize("name", ["CartPole-v1", "CartPoleMaskedVelocity-v1",
                                  "Pendulum-v1"])
def test_env_trajectories_bit_equal(name):
    te, je = tenvs.make_env(name, seed=5), jenvs.make_env(name, seed=5)
    t_obs, _ = te.reset(seed=11)
    j_obs, _ = je.reset(seed=11)
    _bits_equal(t_obs, j_obs)
    rng = np.random.default_rng(0)
    for _ in range(120):
        a = (rng.uniform(-2, 2, 1).astype(np.float32) if name == "Pendulum-v1"
             else int(rng.integers(0, 2)))
        t, j = te.step(a), je.step(a)
        _bits_equal(t[0], j[0])
        assert t[1:4] == j[1:4]
        if t[2] or t[3]:
            _bits_equal(te.reset()[0], je.reset()[0])
    assert tenvs.CartPoleEnv.num_actions == jenvs.CartPoleEnv.num_actions


# --------------------------------------------------------------- modules

def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def test_forward_matches_jax():
    params = jmodule.init_policy_params(4, 2, seed=3)
    tparams = tmodule.init_policy_params(4, 2, seed=3)
    for k in params:
        _bits_equal(tparams[k], params[k])
    obs = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    jl, jv = jmodule.jax_forward(params, obs)
    tl, tv = tmodule.torch_forward(_t(params), torch.from_numpy(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=FWD_TOL,
                               atol=FWD_TOL)
    _bits_equal(tmodule.np_forward(tparams, obs)[0],
                jmodule.np_forward(params, obs)[0])


def test_lstm_forward_seq_matches_jax():
    params = jmodule.init_lstm_policy_params(4, 2, hidden=16, seed=2)
    tparams = tmodule.init_lstm_policy_params(4, 2, hidden=16, seed=2)
    for k in params:
        _bits_equal(tparams[k], params[k])
    rng = np.random.default_rng(1)
    B, L = 3, 7
    obs = rng.standard_normal((B, L, 4)).astype(np.float32)
    first = rng.random((B, L)) < 0.2
    state = {k: rng.standard_normal((B, 16)).astype(np.float32)
             for k in ("h", "c", "hv", "cv")}
    jl, jv = jmodule.jax_lstm_forward_seq(params, obs, state, first)
    tl, tv = tmodule.torch_lstm_forward_seq(
        _t(params), torch.from_numpy(obs), _t(state),
        torch.from_numpy(first))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=FWD_TOL,
                               atol=FWD_TOL)
    jl1, jv1, js = jmodule.jax_lstm_step(params, obs[:, 0], state, first[:, 0])
    tl1, tv1, ts = tmodule.torch_lstm_step(
        _t(params), torch.from_numpy(obs[:, 0]), _t(state),
        torch.from_numpy(first[:, 0]))
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=FWD_TOL, atol=FWD_TOL)
    assert tmodule.get_initial_state(tparams, 2).keys() == \
        jmodule.get_initial_state(params, 2).keys()


# --------------------------------------------------- runners and batches

def _fragments(runner_cls, params, num_envs=2, steps=64, seed=4):
    """Two runners' fragments (each a list of ``num_envs`` fragments)."""
    out = []
    for i in range(2):
        r = runner_cls("CartPole-v1", seed=seed, worker_index=i,
                       num_envs=num_envs)
        r.set_weights(params, 1)
        frags = r.sample(steps)
        out.extend(frags if isinstance(frags, list) else [frags])
    return out


def _assert_fragments_equal(tf, jf):
    assert len(tf) == len(jf)
    for t, j in zip(tf, jf):
        assert t.keys() == j.keys()
        for k in t:
            if k == "state_in":
                for s in t[k]:
                    _bits_equal(t[k][s], j[k][s])
            elif isinstance(t[k], np.ndarray):
                _bits_equal(t[k], j[k])
            else:
                assert t[k] == j[k], k


@pytest.fixture(scope="module")
def mlp_batch():
    params = jmodule.init_policy_params(4, 2, hidden=(32, 32), seed=1)
    tf = _fragments(TEnvRunner, params, num_envs=1, steps=256)
    jf = _fragments(JEnvRunner, params, num_envs=1, steps=256)
    _assert_fragments_equal(tf, jf)
    tb = tlearner.build_ppo_batch(tf, gamma=0.99, lam=0.95)
    jb = jlearner.build_ppo_batch(jf, gamma=0.99, lam=0.95)
    return params, tb, jb


@pytest.fixture(scope="module")
def lstm_batch():
    params = jmodule.init_lstm_policy_params(4, 2, hidden=16, seed=2)
    tf = _fragments(TEnvRunner, params, num_envs=2, steps=64)
    jf = _fragments(JEnvRunner, params, num_envs=2, steps=64)
    _assert_fragments_equal(tf, jf)
    tb = tlearner.build_ppo_batch(tf, seq_len=8)
    jb = jlearner.build_ppo_batch(jf, seq_len=8)
    return params, tb, jb


@pytest.mark.parametrize("which", ["mlp_batch", "lstm_batch"])
def test_build_ppo_batch_equal(request, which):
    _, (tb, tr, tn), (jb, jr, jn) = request.getfixturevalue(which)
    assert tr == jr and tn == jn
    assert tb.keys() == jb.keys()
    for k in tb:
        _bits_equal(tb[k], jb[k])


def test_compute_gae_equal():
    rng = np.random.default_rng(3)
    rewards = rng.standard_normal(50).astype(np.float32)
    values = rng.standard_normal(50).astype(np.float32)
    dones = rng.random(50) < 0.1
    t = tlearner.compute_gae(rewards, values, dones, 0.7, gamma=0.9, lam=0.8)
    j = jlearner.compute_gae(rewards, values, dones, 0.7, gamma=0.9, lam=0.8)
    for a, b in zip(t, j):
        _bits_equal(a, b)


# -------------------------------------------------------------- learners

def _assert_weights_close(got, want, rtol, atol=1e-6):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("which", ["mlp_batch", "lstm_batch"])
def test_ppo_learner_update_matches_jax(request, which):
    params, (tb, _, _), _ = request.getfixturevalue(which)
    jl = jlearner.PPOLearner(params, **PPO_KW)
    tl = tlearner.PPOLearner(params, device="cpu", **PPO_KW)
    assert tl.device.type == "cpu"
    for _ in range(2):
        jm, tm = jl.update(tb), tl.update(tb)
        assert tm.keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=LEARNER_RTOL,
                                       atol=1e-6, err_msg=k)
    got, want = tl.get_weights(), jl.get_weights()
    assert all(v.dtype == np.float32 for v in got.values())
    _assert_weights_close(got, want, LEARNER_RTOL)
    moved = max(np.abs(want[k] - params[k]).max() for k in params)
    assert moved > 1e-3


def test_compute_apply_gradients_match_jax(mlp_batch):
    params, (tb, _, _), _ = mlp_batch
    jl = jlearner.PPOLearner(params, **PPO_KW)
    tl = tlearner.PPOLearner(params, device="cpu", **PPO_KW)
    jg, jaux = jl.compute_gradients(tb)
    tg, taux = tl.compute_gradients(tb)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=LEARNER_RTOL, atol=1e-6)
    np.testing.assert_allclose(float(taux["total_loss"]),
                               float(jaux["total_loss"]), rtol=LEARNER_RTOL)
    grads = {k: np.asarray(v) for k, v in jg.items()}
    jl.apply_gradients(grads)
    tl.apply_gradients(grads)
    assert tl.updates == jl.updates == 1
    _assert_weights_close(tl.get_weights(), jl.get_weights(), LEARNER_RTOL)
    tl.set_weights(params)
    _bits_equal(tl.get_weights()["pi_w"], params["pi_w"])


def test_learner_on_cuda_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlearner.PPOLearner(jmodule.init_policy_params(4, 2))


# ------------------------------------------------------ on the clusters

def _learner_group(pkg, params, batch):
    import importlib

    lg = importlib.import_module(f"{pkg}.rl.learner_group")
    lmod = importlib.import_module(f"{pkg}.rl.learner")
    kw = dict(PPO_KW)
    if pkg == "ray_tpu_torch":
        kw["device"] = "cpu"

    def factory():
        return lmod.PPOLearner(params, **kw)

    group = lg.LearnerGroup(factory, num_learners=2)
    try:
        metrics = group.update(batch)
        return {"metrics": metrics, "weights": group.get_weights(),
                "updates": group.num_updates()}
    finally:
        group.shutdown()


def _ppo_iterations(pkg):
    import importlib

    rl = importlib.import_module(f"{pkg}.rl")
    extra = {"learner_device": "cpu"} if pkg == "ray_tpu_torch" else {}
    algo = (rl.PPOConfig(seed=1, hidden=(32, 32),
                         rollout_fragment_length=128, num_epochs=2,
                         minibatch_size=64, lr=1e-3, **extra)
            .environment("CartPole-v1").env_runners(2).build())
    try:
        steps = [algo.train()["env_runners"]["num_env_steps_sampled"]
                 for _ in range(2)]
        return {"steps": steps, "weights": algo.get_weights()}
    finally:
        algo.stop()


def _cluster_parts(pkg, mlp):
    params, (batch, _, _), _ = mlp
    return {"group": _learner_group(pkg, params, batch),
            "ppo": _ppo_iterations(pkg)}


@pytest.fixture(scope="module")
def cluster_results(mlp_batch):
    import ray_tpu
    import ray_tpu_torch

    got = {}
    for attempt in range(JAX_ATTEMPTS):
        ray_tpu.init(num_cpus=4, num_tpus=0)
        try:
            got["ray_tpu"] = _cluster_parts("ray_tpu", mlp_batch)
            break
        except Exception:  # noqa: BLE001 — C.2; the last attempt raises
            if attempt == JAX_ATTEMPTS - 1:
                raise
        finally:
            ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    try:
        got["ray_tpu_torch"] = _cluster_parts("ray_tpu_torch", mlp_batch)
    finally:
        ray_tpu_torch.shutdown()
    return got


def test_learner_group_matches_jax(cluster_results):
    want = cluster_results["ray_tpu"]["group"]
    got = cluster_results["ray_tpu_torch"]["group"]
    assert got["updates"] == want["updates"] == 1
    assert got["metrics"]["num_env_steps_trained"] == \
        want["metrics"]["num_env_steps_trained"]
    for k in want["metrics"]:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=LEARNER_RTOL, atol=1e-6, err_msg=k)
    _assert_weights_close(got["weights"], want["weights"], LEARNER_RTOL)


def test_ppo_iterations_match_jax(cluster_results):
    want = cluster_results["ray_tpu"]["ppo"]
    got = cluster_results["ray_tpu_torch"]["ppo"]
    assert got["steps"] == want["steps"] == [256, 256]
    _assert_weights_close(got["weights"], want["weights"], ITER_TOL,
                          atol=ITER_TOL)


# ------------------------------------------------------ names and refusals

def test_names_ported_or_refused():
    """Every public name of ``ray_tpu.rl`` (its submodules aside) exists
    in the port and none refuses: RL is ported whole."""
    import types

    import ray_tpu.rl as jrl

    import ray_tpu_torch.rl as trl

    names = [n for n in dir(jrl) if not n.startswith("_")
             and not isinstance(getattr(jrl, n), types.ModuleType)]
    assert {"DQN", "IMPALAConfig", "SAC", "BC", "MultiAgentPPO",
            "DreamerV3", "Anakin", "SebulbaHandle", "JaxCartPole"} <= set(
                names)
    for name in names:
        assert getattr(trl, name) is not None, name
    assert tenvs.get_jax_env("CartPole-v1") is tenvs.TorchCartPole
    trl.register_jax_env("x", tenvs.TorchCartPole)
    assert tenvs.get_jax_env("x") is tenvs.TorchCartPole
    from ray_tpu_torch.rl.multi_agent import CoordinationGameEnv

    assert isinstance(tenvs.make_env("coordination"), CoordinationGameEnv)
    from ray_tpu_torch.common.status import WAITING

    assert not [k for k in WAITING if k.startswith("rl")]
