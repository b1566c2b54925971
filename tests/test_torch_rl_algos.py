"""The port's RL algorithms beyond PPO (``ray_tpu_torch.rl``) against
``ray_tpu.rl`` on the CPU, with no cluster of either package.

- replay: ``ReplayBuffer`` and ``SequenceReplay`` of one seed sample the
  same indices (bit-equal batches);
- offline data: a JSON file written by either package is byte-equal to
  the other's and reads back the same in both;
- ``returns_to_go`` equal; ``vtrace_corrections`` within 1e-6 of JAX's on
  fragments of equal and of unequal length, cut at every boundary;
- one ``update`` (two for DQN, SAC and CQL, across a target sync or a
  second draw) of DQN, BC, MARWIL, SAC, CQL, IMPALA, APPO and DreamerV3
  from the same weights, batch and draws: metrics and weights within
  1e-5 relative (1e-6 absolute: biases start at 0) of the JAX learner's;
  DreamerV3's metrics within 1e-4 relative (1e-5 absolute) and weights
  within 5e-5 absolute, 1e-4 relative (measured here: the loss 3.3e-6
  relative, ``imagined_return_mean`` 1.3e-6 absolute, since the twohot
  bins differ from ``jnp.linspace``'s by up to 4.8e-7; weights 2.7e-5
  absolute after two updates, all in leaves whose Adam step
  lr·g/(|g| + eps) is ±lr for the tiny gradients that float noise
  moves);
- a two-policy ``MultiAgentEnvRunner`` fragment on the coordination game
  bit-equal.

The JAX learners draw inside their jitted steps; the port's take their
draws as arguments, so each test draws them in JAX from the keys the JAX
step splits, the way it splits them, and passes them in (a categorical is
argmax(logits + Gumbel noise) on jax 0.9.0, checked here). The port's
learners run on the CPU (``device="cpu"``; their default is CUDA).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl import module as jmodule
from ray_tpu_torch.rl import module as tmodule

from _torch_isolation import _module_isolation_guard  # noqa: F401

RTOL = 1e-5
ATOL = 1e-6
DREAMER_RTOL = 1e-4
DREAMER_ATOL = 1e-5
DREAMER_WEIGHTS_ATOL = 5e-5


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _np(tree):
    return {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                          else v) for k, v in tree.items()}


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    assert set(got) == set(want), (set(got) ^ set(want))
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what}{k}")


def _transitions(n=48, obs=4, actions=None, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((n, obs)).astype(np.float32),
        "actions": (rng.integers(0, 2, n).astype(np.int32) if actions is None
                    else rng.uniform(-actions, actions, (n, 1))
                    .astype(np.float32)),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "next_obs": rng.standard_normal((n, obs)).astype(np.float32),
        "dones": (rng.random(n) < 0.2).astype(np.float32),
    }


# ----------------------------------------------------------------- replay

def test_replay_samples_the_same_indices():
    from ray_tpu.rl import replay as jreplay
    from ray_tpu_torch.rl import replay as treplay

    tb, jb = treplay.ReplayBuffer(40, seed=3), jreplay.ReplayBuffer(40, seed=3)
    for i in range(3):   # 72 transitions wrap the ring of 40
        frag = _transitions(24, seed=i)
        tb.add_fragment(frag)
        jb.add_fragment(frag)
    assert len(tb) == len(jb) == 40
    for _ in range(4):
        t, j = tb.sample(16), jb.sample(16)
        for k in j:
            _bits_equal(t[k], j[k])
    ts = treplay.SequenceReplay(1000, seq_len=5, seed=2)
    js = jreplay.SequenceReplay(1000, seq_len=5, seed=2)
    rng = np.random.default_rng(7)
    for n in (12, 9, 20):
        frag = {"obs": rng.standard_normal((n, 3)).astype(np.float32),
                "actions": rng.integers(0, 2, n),
                "rewards": rng.standard_normal(n).astype(np.float32),
                "dones": rng.random(n) < 0.1,
                "state_in": {"h": rng.standard_normal((n, 4))
                             .astype(np.float32)}}
        ts.add_fragment(frag)
        js.add_fragment(frag)
    assert ts.has_sequences(4) == js.has_sequences(4)
    t, j = ts.sample(4), js.sample(4)
    assert t.keys() == j.keys()
    for k in j:
        _bits_equal(t[k], j[k])
    frag = dict(_transitions(10), terminated=np.zeros(10, bool))
    for k, v in treplay.transitions_from_fragment(frag).items():
        _bits_equal(v, jreplay.transitions_from_fragment(frag)[k])


# ---------------------------------------------------------------- offline

def _offline_fragments(n_frags=3, T=40, seed=0):
    rng = np.random.default_rng(seed)
    frags = []
    for _ in range(n_frags):
        frags.append({
            "obs": rng.standard_normal((T, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, T).astype(np.int32),
            "rewards": np.ones(T, np.float32),
            "dones": rng.random(T) < 0.05,
            "logp": rng.standard_normal(T).astype(np.float32)})
    return frags


def test_json_files_are_byte_compatible_both_ways(tmp_path):
    from ray_tpu.rl import offline as joffline
    from ray_tpu_torch.rl import offline as toffline

    frags = _offline_fragments()
    for name, mod in (("t", toffline), ("j", joffline)):
        w = mod.JsonWriter(str(tmp_path / name))
        for f in frags:
            w.write(f)
        w.close()
    tfile = tmp_path / "t" / "output-00000.jsonl"
    jfile = tmp_path / "j" / "output-00000.jsonl"
    assert tfile.read_bytes() == jfile.read_bytes()
    for path in (tmp_path / "t", tmp_path / "j"):
        t = toffline.JsonReader(str(path)).read_all()
        j = joffline.JsonReader(str(path)).read_all()
        assert t.keys() == j.keys()
        for k in j:
            _bits_equal(t[k], j[k])
    rows = [json.loads(line) for line in tfile.read_text().splitlines()]
    assert len(rows) == len(frags)
    # to_dataset: the same rows, one per transition, in both packages (the
    # plan's read task is what a worker runs; no cluster needed)
    tds = toffline.to_dataset(str(tmp_path / "t"))
    jds = joffline.to_dataset(str(tmp_path / "t"))
    tblocks = [task() for task in tds._ops[0].read_tasks]
    jblocks = [task() for task in jds._ops[0].read_tasks]
    assert len(tblocks) == len(jblocks) == 1
    assert tblocks[0].equals(jblocks[0])
    from ray_tpu.data import block as jblock
    from ray_tpu_torch.data import block as tblock

    trows = tblock.block_to_rows(tblocks[0])
    assert trows == jblock.block_to_rows(jblocks[0])
    assert len(trows) == sum(len(f["actions"]) for f in frags)


@pytest.fixture(scope="module")
def offline_dir(tmp_path_factory):
    from ray_tpu.rl.offline import JsonWriter

    path = str(tmp_path_factory.mktemp("offline"))
    w = JsonWriter(path)
    for f in _offline_fragments(n_frags=4, T=48, seed=1):
        w.write(f)
    w.close()
    return path


def test_bc_update_matches_jax(offline_dir):
    from ray_tpu.rl.offline import BC as JBC, BCConfig as JCfg
    from ray_tpu_torch.rl.offline import BC as TBC, BCConfig as TCfg

    kw = dict(input_path=offline_dir, minibatch_size=64, hidden=(16, 16),
              seed=2)
    jbc, tbc = JBC(JCfg(**kw)), TBC(TCfg(**kw, learner_device="cpu"))
    jm, tm = jbc.train(), tbc.train()
    _close(tm, jm)
    _close(_np(tbc.params), _np(jbc.params), what="params ")


def test_marwil_update_matches_jax(offline_dir):
    from ray_tpu.rl import marwil as jmarwil
    from ray_tpu_torch.rl import marwil as tmarwil

    rng = np.random.default_rng(0)
    rewards = rng.standard_normal(30).astype(np.float32)
    dones = rng.random(30) < 0.2
    _bits_equal(tmarwil.returns_to_go(rewards, dones, 0.9),
                jmarwil.returns_to_go(rewards, dones, 0.9))
    kw = dict(input_path=offline_dir, minibatch_size=64, hidden=(16, 16),
              seed=1, beta=1.0)
    j = jmarwil.MARWIL(jmarwil.MARWILConfig(**kw))
    t = tmarwil.MARWIL(tmarwil.MARWILConfig(**kw, learner_device="cpu"))
    _close(t.train(), j.train())
    _close(_np(t.params), _np(j.params), what="params ")


# -------------------------------------------------------------------- DQN

def test_dqn_updates_match_jax():
    from ray_tpu.rl.dqn import DQNLearner as J
    from ray_tpu_torch.rl.dqn import DQNLearner as T

    params = jmodule.init_policy_params(4, 2, hidden=(16, 16), seed=5)
    kw = dict(lr=1e-2, gamma=0.9, target_update_freq=2)
    j, t = J(params, **kw), T(params, **kw, device="cpu")
    for i in range(3):   # across the target sync after update 2
        batch = _transitions(32, seed=10 + i)
        _close(t.update(batch), j.update(batch), what=f"update {i} ")
    _close(t.get_weights(), j.get_weights(), what="weights ")


# ---------------------------------------------------------------- SAC, CQL

def _sac_draws(key, n, d, cql=None):
    """The JAX step's draws for one update, split as it splits them; the
    new learner key and the port's draws dict."""
    key, sub = jax.random.split(key)
    k1, k2, k3 = jax.random.split(sub, 3)
    draws = {"eps_next": jax.random.normal(k1, (n, d)),
             "eps_pi": jax.random.normal(k2, (n, d))}
    if cql is not None:
        n_actions, scale = cql
        k_rand, k_pi, k_pin = jax.random.split(k3, 3)
        draws["cql_rand"] = jax.random.uniform(
            k_rand, (n_actions, n, d), minval=-scale, maxval=scale)
        draws["cql_eps_pi"] = jax.random.normal(k_pi, (n, d))
        draws["cql_eps_pin"] = jax.random.normal(k_pin, (n, d))
    return key, {k: np.asarray(v) for k, v in draws.items()}


@pytest.mark.parametrize("algo", ["sac", "cql"])
def test_sac_and_cql_updates_match_jax(algo):
    if algo == "sac":
        from ray_tpu.rl.sac import SACLearner as J
        from ray_tpu_torch.rl.sac import SACLearner as T
        extra = {}
    else:
        from ray_tpu.rl.cql import CQLLearner as J
        from ray_tpu_torch.rl.cql import CQLLearner as T
        extra = dict(cql_alpha=0.5, cql_n_actions=3)
    kw = dict(hidden=(16, 16), actor_lr=1e-3, critic_lr=2e-3, alpha_lr=3e-3,
              gamma=0.95, tau=0.1, action_scale=2.0, seed=4, **extra)
    j, t = J(3, 1, **kw), T(3, 1, **kw, device="cpu")
    key = jax.random.key(4 + 7)
    cql = (3, np.float32(2.0)) if algo == "cql" else None
    for i in range(2):
        batch = _transitions(24, obs=3, actions=2.0, seed=20 + i)
        key, draws = _sac_draws(key, 24, 1, cql)
        _close(t.update(batch, draws), j.update(batch), what=f"update {i} ")
    js, ts = j.get_state(), t.get_state()
    for part in ("actor", "q1", "q2", "q1_target", "q2_target"):
        _close(ts[part], _np(js[part]), what=part + " ")
    _close({"a": ts["log_alpha"]}, {"a": js["log_alpha"]})


# ----------------------------------------------------- IMPALA, APPO, vtrace

def _aggregated_batch(lengths=(12, 12, 12), seed=0):
    """Fragments of ``lengths`` through the port's Aggregator (a copy of
    the JAX one): the concatenated batch with fragment_end flags."""
    from ray_tpu.rl.impala import Aggregator as JAgg
    from ray_tpu_torch.rl.impala import Aggregator as TAgg

    rng = np.random.default_rng(seed)
    frags = []
    for T in lengths:
        frags.append({
            "obs": rng.standard_normal((T, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, T).astype(np.int32),
            "logp": np.log(rng.uniform(0.3, 0.7, T)).astype(np.float32),
            "rewards": rng.standard_normal(T).astype(np.float32),
            "values": rng.standard_normal(T).astype(np.float32),
            "dones": rng.random(T) < 0.15,
            "last_value": float(rng.standard_normal()),
            "episode_returns": [1.0]})
    out = []
    for cls in (TAgg, JAgg):
        agg = cls(sum(lengths))
        agg.add_fragment(frags)
        out.append(agg.get_ready_batch())
    for k in out[1]:
        _bits_equal(out[0][k], out[1][k])
    return out[0]


@pytest.mark.parametrize("lengths", [(10, 10, 10, 10), (7, 13, 4, 11)])
def test_vtrace_corrections_match_jax(lengths):
    from ray_tpu.rl.impala import vtrace_corrections as jvt
    from ray_tpu_torch.rl.impala import fragment_layout, vtrace_corrections

    batch = _aggregated_batch(lengths, seed=len(set(lengths)))
    rng = np.random.default_rng(1)
    n = len(batch["obs"])
    values = rng.standard_normal(n).astype(np.float32)
    rho = rng.uniform(0.2, 2.0, n).astype(np.float32)
    kw = dict(gamma=0.9, rho_bar=1.0, c_bar=0.8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_vs, j_adv = jvt(jnp.asarray(values), jb, jnp.asarray(rho), **kw)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    t_vs, t_adv = vtrace_corrections(torch.from_numpy(values), tb,
                                     torch.from_numpy(rho), **kw)
    np.testing.assert_allclose(t_vs.numpy(), np.asarray(j_vs), atol=ATOL)
    np.testing.assert_allclose(t_adv.numpy(), np.asarray(j_adv), atol=ATOL)
    (F, T), index = fragment_layout(batch["fragment_end"])
    assert F == len(lengths) and T == max(lengths)
    assert (index is None) == (len(set(lengths)) == 1)


@pytest.mark.parametrize("algo", ["impala", "appo"])
def test_impala_and_appo_updates_match_jax(algo):
    from ray_tpu.rl import appo as jappo, impala as jimpala
    from ray_tpu_torch.rl import appo as tappo, impala as timpala

    J, T = ((jimpala.IMPALALearner, timpala.IMPALALearner)
            if algo == "impala" else
            (jappo.APPOLearner, tappo.APPOLearner))
    params = jmodule.init_policy_params(4, 2, hidden=(16, 16), seed=6)
    kw = dict(lr=1e-2, gamma=0.95, grad_clip=1.0)
    j, t = J(params, **kw), T(params, **kw, device="cpu")
    batch = _aggregated_batch((9, 15, 8), seed=3)
    tg, taux = t.compute_gradients(batch)
    jg, jaux = j.compute_gradients(batch)
    _close(_np(taux), _np(jaux), what="aux ")
    _close(_np(tg), _np(jg), what="grads ")
    _close(t.update(batch), j.update(batch))
    _close(t.get_weights(), j.get_weights(), what="weights ")


# -------------------------------------------------------------- DreamerV3

def test_jax_categorical_is_gumbel_argmax():
    """jax.random.categorical(key, logits) == argmax(logits +
    gumbel(key, logits.shape)) on the installed jax."""
    logits = jax.random.normal(jax.random.key(1), (64, 5, 7))
    for seed in range(3):
        key = jax.random.key(seed)
        want = jax.random.categorical(key, logits, axis=-1)
        got = jnp.argmax(logits + jax.random.gumbel(key, logits.shape),
                         axis=-1)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _dreamer_draws(key, B, L, cfg, A):
    key, sub = jax.random.split(key)
    keys = jax.random.split(sub, L + 1)
    shape_z = (cfg.latent_categoricals, cfg.latent_classes)
    wm = [jax.random.gumbel(keys[t], (B,) + shape_z) for t in range(L)]
    img_a, img_z = [], []
    for k in jax.random.split(keys[L], cfg.horizon):
        k_a, k_z = jax.random.split(k)
        img_a.append(jax.random.gumbel(k_a, (B * L, A)))
        img_z.append(jax.random.gumbel(k_z, (B * L,) + shape_z))
    return key, {"wm": np.stack(wm), "img_a": np.stack(img_a),
                 "img_z": np.stack(img_z)}


def test_dreamerv3_update_matches_jax():
    from ray_tpu.rl import dreamerv3 as jd
    from ray_tpu_torch.rl import dreamerv3 as td

    small = dict(units=16, deter=16, latent_categoricals=4,
                 latent_classes=4, horizon=5, seed=3)
    jcfg, tcfg = jd.DreamerV3Config(**small), td.DreamerV3Config(**small)
    B, L, A, O = 3, 6, 2, 4
    j = jd.DreamerV3Learner(O, A, jcfg)
    t = td.DreamerV3Learner(O, A, tcfg, device="cpu")
    for k in j._params:
        _bits_equal(t.get_weights()[k], np.asarray(j._params[k]))
    rng = np.random.default_rng(5)
    key = jax.random.key(3)
    for i in range(2):
        batch = {
            "obs": rng.standard_normal((B, L, O)).astype(np.float32),
            "actions": rng.integers(0, A, (B, L)).astype(np.int32),
            "rewards": rng.standard_normal((B, L)).astype(np.float32),
            "terminated": (rng.random((B, L)) < 0.1).astype(np.float32),
            "is_first": rng.random((B, L)) < 0.2}
        if i:   # recorded window-start latents, as replay ships them
            batch["state_in_h"] = rng.standard_normal((B, 16)).astype(
                np.float32)
            batch["state_in_z"] = np.eye(16, dtype=np.float32)[
                rng.integers(0, 16, B)]
            batch["state_in_a"] = np.eye(A, dtype=np.float32)[
                rng.integers(0, A, B)]
        key, draws = _dreamer_draws(key, B, L, jcfg, A)
        _close(t.update(batch, draws), j.update(batch), rtol=DREAMER_RTOL,
               atol=DREAMER_ATOL, what=f"update {i} ")
    _close(t.get_weights(), _np(j._params), rtol=DREAMER_RTOL,
           atol=DREAMER_WEIGHTS_ATOL, what="weights ")
    jr, tr = j.get_runner_weights(), t.get_runner_weights()
    assert jr.keys() == tr.keys()
    _bits_equal(tr["rssm_meta"], jr["rssm_meta"])


# ------------------------------------------------------------ multi-agent

def test_multi_agent_fragments_bit_equal():
    from ray_tpu.rl.multi_agent import MultiAgentEnvRunner as J
    from ray_tpu_torch.rl.envs import make_env
    from ray_tpu_torch.rl.multi_agent import (CoordinationGameEnv,
                                              MultiAgentEnvRunner as T)

    assert isinstance(make_env("coordination"), CoordinationGameEnv)
    mapping = {"agent_0": "p0", "agent_1": "p1"}
    weights = {"p0": jmodule.init_policy_params(3, 3, hidden=(8,), seed=1),
               "p1": jmodule.init_policy_params(3, 3, hidden=(8,), seed=2)}
    out = []
    for cls in (T, J):
        r = cls("coordination", mapping, seed=3, worker_index=1)
        r.set_weights(weights, 2)
        out.append([r.sample(40), r.sample(40)])   # across an episode end
    for t, j in zip(*out):
        assert t["episode_returns"] == j["episode_returns"]
        assert t["weights_version"] == j["weights_version"] == 2
        assert t["agents"].keys() == j["agents"].keys()
        for a in j["agents"]:
            for k, v in j["agents"][a].items():
                if isinstance(v, np.ndarray):
                    _bits_equal(t["agents"][a][k], v)
                else:
                    assert t["agents"][a][k] == v, (a, k)
    assert tmodule.init_policy_params(3, 3, hidden=(8,), seed=1).keys() == \
        weights["p0"].keys()


def test_sources_import_neither_jax_nor_ray_tpu():
    import ray_tpu_torch.rl as trl

    root = os.path.dirname(trl.__file__)
    for name in ("replay", "dqn", "offline", "marwil", "sac", "cql",
                 "impala", "appo", "multi_agent", "dreamerv3", "podracer"):
        with open(os.path.join(root, name + ".py"), encoding="utf-8") as f:
            src = f.read()
        assert "import jax" not in src and "from jax" not in src, name
        assert "from ray_tpu." not in src and "import ray_tpu\n" not in src
