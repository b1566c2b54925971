"""The port's Podracer (``ray_tpu_torch.rl.podracer``) and its in-device
CartPole, against ``ray_tpu.rl`` on the CPU, with no JAX cluster.

- ``TorchCartPole`` (the port's ``JaxCartPole``): reset and 50 steps from
  the same uniforms and actions as ``JaxCartPole``'s, within 1e-6 with the
  same done flags; bit-equal when both take the same sin and cos (XLA's
  f32 sin and cos differ from torch's in the last bit for some inputs);
- one Anakin step at ``batch_envs=4``, ``fragment_length=8`` (the sizes of
  tests/test_podracer.py::TestAnakin) from the same weights and draws:
  params, optimizer moments, env state and metrics within 1e-5 relative
  (1e-6 absolute) of ``_build_anakin_step``'s raw step;
- ``FragmentBatch`` round-trips, its columns views of the fused payload;
- on one port cluster: Sebulba with ``sync_weights=True`` and 2 runners
  equals the port's synchronous ``PPO.train()`` weight for weight over 3
  updates (1e-5, the JAX package's own oracle); a clean ``stop()``
  accounts for every fragment; one armed ``rl.fragment.push`` drop is
  counted and is not fatal; Anakin's ``train`` folds its weights back; a
  stateful module refuses Anakin.

The learners run on the CPU (``learner_device="cpu"``; the default is
CUDA, where Sebulba's learner actor takes a GPU lease).
"""

import threading
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl import module as jmodule
from ray_tpu.rl.envs import JaxCartPole
from ray_tpu_torch.rl.envs import TorchCartPole

from _torch_isolation import _module_isolation_guard  # noqa: F401

RTOL = 1e-5
ATOL = 1e-6
STEP_ATOL = 1e-6


def _uniform(key, shape):
    return np.array(jax.random.uniform(key, shape, minval=-0.05,
                                       maxval=0.05))


def _shared_trig(monkeypatch):
    """JaxCartPole's sin and cos computed by torch, so both envs take the
    same transcendental values."""
    def wrap(fn):
        return lambda x: jnp.asarray(fn(torch.from_numpy(
            np.array(x, np.float32))).numpy())

    monkeypatch.setattr(jnp, "cos", wrap(torch.cos))
    monkeypatch.setattr(jnp, "sin", wrap(torch.sin))


@pytest.mark.parametrize("trig", ["own", "shared"])
def test_cartpole_reset_and_steps_match_jax(trig, monkeypatch):
    if trig == "shared":
        _shared_trig(monkeypatch)
    B = 32
    key = jax.random.key(0)
    key, k = jax.random.split(key)
    js, jo = JaxCartPole.reset(k, B)
    ts, to = TorchCartPole.reset(torch.from_numpy(_uniform(k, (B, 4))), B)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    rng = np.random.default_rng(1)
    dones = 0
    for t in range(50):
        a = rng.integers(0, 2, B).astype(np.int32)
        key, k = jax.random.split(key)
        js, jo, jr, jd = JaxCartPole.step(js, jnp.asarray(a), k)
        ts, to, tr, td = TorchCartPole.step(
            ts, torch.from_numpy(a), torch.from_numpy(_uniform(k, (B, 4))))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(ts["steps"].numpy(),
                                      np.asarray(js["steps"]))
        if trig == "shared":
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        else:
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                       atol=STEP_ATOL)
        dones += int(td.sum())
    assert dones > 0   # the in-place reset ran
    g = torch.Generator().manual_seed(0)
    s, _ = TorchCartPole.reset(g, 1000)
    assert s["s"].abs().max() <= 0.05 and s["s"].dtype == torch.float32


def test_anakin_step_matches_jax():
    from ray_tpu.rl.podracer import _build_anakin_step as jbuild
    from ray_tpu_torch.rl.learner import _tensors
    from ray_tpu_torch.rl.podracer import _build_anakin_step as tbuild

    B, T = 4, 8
    hyper = {"gamma": 0.99, "lam": 0.95, "clip": 0.2, "vf_coeff": 0.5,
             "entropy_coeff": 0.01, "num_epochs": 2, "lr": 3e-4}
    params = jmodule.init_policy_params(4, 2, hidden=(64, 64), seed=0)
    jstep, jopt = jbuild(JaxCartPole, T, hyper)
    tstep, topt = tbuild(TorchCartPole, T, hyper)
    key = jax.random.PRNGKey(0)
    key, reset_key = jax.random.split(key)
    jenv, jobs = JaxCartPole.reset(reset_key, B)
    tenv, tobs = TorchCartPole.reset(
        torch.from_numpy(_uniform(reset_key, (B, 4))), B)
    # the unroll's draws, split as the JAX step's act() splits its key
    k, act, env = key, [], []
    for _ in range(T):
        k, k_act, k_env = jax.random.split(k, 3)
        act.append(np.array(jax.random.gumbel(k_act, (B, 2))))
        env.append(_uniform(k_env, (B, 4)))
    jp = {k_: jnp.asarray(v) for k_, v in params.items()}
    out = jax.jit(jstep)(jp, jopt.init(jp), jenv, jobs, key)
    tp = _tensors(params, "cpu")
    got = tstep(tp, topt.init(tp), tenv, tobs,
                {"act": torch.from_numpy(np.stack(act)),
                 "env": torch.from_numpy(np.stack(env))})
    for k_ in params:
        np.testing.assert_allclose(got[0][k_].numpy(), np.asarray(out[0][k_]),
                                   rtol=RTOL, atol=ATOL, err_msg=k_)
    # optax's state: (clip's empty state, (ScaleByAdamState, ...))
    adam = out[1][1][0]
    assert got[1]["count"] == int(adam.count) == 2
    for k_ in params:
        np.testing.assert_allclose(got[1]["mu"][k_].numpy(),
                                   np.asarray(adam.mu[k_]), rtol=RTOL,
                                   atol=ATOL, err_msg=k_)
    np.testing.assert_allclose(got[2]["s"].numpy(), np.asarray(out[2]["s"]),
                               atol=STEP_ATOL)
    np.testing.assert_array_equal(got[2]["steps"].numpy(),
                                  np.asarray(out[2]["steps"]))
    for k_, v in out[5].items():
        np.testing.assert_allclose(float(got[4][k_]), float(v), rtol=RTOL,
                                   atol=ATOL, err_msg=k_)


def test_fragment_batch_round_trips():
    from ray_tpu_torch.rl.podracer import FragmentBatch

    rng = np.random.default_rng(0)
    frags = [{"obs": rng.normal(size=(5, 4)).astype(np.float32),
              "actions": rng.integers(0, 2, 5).astype(np.int64),
              "rewards": np.ones(5, np.float32),
              "dones": np.zeros(5, np.float32),
              "logp": rng.normal(size=5).astype(np.float32),
              "values": rng.normal(size=5).astype(np.float32),
              "last_value": float(rng.normal()),
              "episode_returns": [12.0, 7.5], "weights_version": 3,
              "state_in": {"h": rng.normal(size=8).astype(np.float32)}}
             for _ in range(3)]
    fb = FragmentBatch.from_fragments(frags, runner=1,
                                      counters={"env_steps": 15})
    assert fb.num_fragments == 3 and fb.meta["version"] == 3
    import pickle

    fb = pickle.loads(pickle.dumps(fb, protocol=5))
    out = fb.to_fragments()
    for a, b in zip(frags, out):
        for k in ("obs", "actions", "rewards", "logp", "values"):
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["state_in"]["h"], b["state_in"]["h"])
        assert b["last_value"] == pytest.approx(a["last_value"])
        assert b["episode_returns"] == a["episode_returns"]
    assert np.shares_memory(out[1]["obs"], fb.columns["obs"])


# ------------------------------------------------------ one port cluster

@pytest.fixture(scope="module")
def rt():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _algo(num_runners=2, envs=2, **training):
    from ray_tpu_torch.rl.algorithm import PPOConfig

    cfg = PPOConfig(learner_device="cpu").environment("CartPole-v1")
    cfg = cfg.env_runners(num_runners, envs)
    return cfg.training(**training).build()


def test_sebulba_lock_step_equals_sync_ppo_and_stops_clean(rt):
    from ray_tpu_torch.rl.podracer import PodracerConfig, scale_out

    training = dict(rollout_fragment_length=16, minibatch_size=64,
                    num_epochs=2)
    algo = _algo(2, 2, **training)
    h = scale_out(algo, PodracerConfig(mode="sebulba", num_runners=2,
                                       sync_weights=True))
    try:
        recs = h.wait_updates(3, timeout_s=120)
    except BaseException:
        h.shutdown()
        raise
    assert h.learner_device == "cpu"
    assert all(r["policy_lag"] == 0 for r in recs)
    state = h.debug_state()
    assert state["mode"] == "sebulba" and state["totals"]["updates"] >= 3
    for metric in ("rt_rl_env_steps_total", "rt_rl_learner_updates_total",
                   "rt_rl_fragments_consumed_total"):
        assert metric in state["metrics"]
    s = h.stop(timeout_s=120)
    learner = s["learner"]
    produced = sum(r["fragments_produced"] for r in s["runners"].values())
    drops = sum(r["push_drops"] for r in s["runners"].values())
    assert s["queue"]["undelivered"] == 0
    assert learner["lost_batches"] == 0 and learner["lag_dropped"] == 0
    assert produced - drops == learner["consumed"]
    v = learner["version"]
    assert v >= 3
    oracle = _algo(2, 2, **training)
    try:
        for _ in range(v):
            oracle.train()
        got, want = algo.get_weights(), oracle.get_weights()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    finally:
        oracle.stop()
        algo.stop()


def test_fragment_push_fault_is_counted_and_not_fatal(rt):
    import cloudpickle

    from ray_tpu_torch.common import faults
    from ray_tpu_torch.graph.channels import ChannelClosed, ShmChannel
    from ray_tpu_torch.rl.podracer import FragmentBatch, _SebulbaRunner

    blob = cloudpickle.dumps({
        "env_spec": "CartPole-v1", "seed": 0, "num_envs": 1,
        "connectors": [], "module_to_env_connectors": [],
        "record_next_obs": False, "fragment_length": 8,
        "sync_weights": False, "io_timeout_s": 20.0})
    tag = uuid.uuid4().hex[:8]
    param_ch = ShmChannel(f"/rtrl_t{tag}_p", capacity=1 << 20, num_readers=1)
    frag_ch = ShmChannel(f"/rtrl_t{tag}_f", capacity=1 << 20, num_readers=1)
    param_ch._handle()
    frag_ch._handle()
    faults.clear()
    faults.inject("rl.fragment.push", "nth:2")
    runner = _SebulbaRunner(blob, 0)
    out = {}
    t = threading.Thread(target=lambda: out.update(
        stats=runner.run_acting(param_ch, frag_ch)), daemon=True)
    t.start()
    try:
        weights = jmodule.init_policy_params(4, 2, seed=0)
        param_ch.write({"version": 0, "ref": rt.put(weights)},
                       timeout_s=20.0)
        delivered = []
        for _ in range(3):
            msg = frag_ch.read(timeout_s=60.0)
            delivered.append(rt.get(msg["ref"], timeout=30.0))
        param_ch.close()
        try:
            while True:
                frag_ch.read(timeout_s=20.0)
        except (ChannelClosed, TimeoutError):
            pass
        t.join(timeout=60)
        assert not t.is_alive()
        assert faults.fired("rl.fragment.push") == 1
        assert out["stats"]["push_drops"] == 1
        assert out["stats"]["fragments_produced"] >= 4
        assert all(isinstance(fb, FragmentBatch) for fb in delivered)
    finally:
        faults.clear()
        for ch in (param_ch, frag_ch):
            ch.close()
            ch.unlink()


def test_anakin_trains_and_refuses_stateful_modules(rt):
    from ray_tpu_torch.rl import PodracerError
    from ray_tpu_torch.rl.podracer import PodracerConfig, scale_out

    algo = _algo(1, 1, rollout_fragment_length=8, minibatch_size=32,
                 num_epochs=2)
    try:
        before = algo.get_weights()
        v0 = algo._weights_version
        an = algo.scale_out(PodracerConfig(mode="anakin", batch_envs=4,
                                           fragment_length=8))
        out = an.train(2)
        assert an.updates == 2 and an.env_steps == 2 * 4 * 8
        assert out["env_steps_per_s"] > 0
        assert algo._weights_version == v0 + 2
        after = algo.get_weights()
        assert any(not np.allclose(before[k], after[k]) for k in before)
        assert an.debug_state()["mode"] == "anakin"
    finally:
        algo.stop()
    lstm = _algo(1, 1, rollout_fragment_length=8, minibatch_size=16,
                 num_epochs=1, module="lstm", seq_len=4)
    try:
        with pytest.raises(PodracerError, match="feedforward"):
            scale_out(lstm, PodracerConfig(mode="anakin"))
    finally:
        lstm.stop()
