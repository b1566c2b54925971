"""Multi-agent RL: multi-agent envs, policy mapping, per-policy learners
(port of ``ray_tpu/rl/multi_agent.py``; each policy's ``PPOLearner`` runs
on the algorithm's ``learner_device``, None meaning CUDA).

Reference: ``rllib/env/multi_agent_env.py`` (dict-keyed obs/action/reward
protocol), ``rllib/algorithms/algorithm_config.py multi_agent()`` (policies
+ policy_mapping_fn + policies_to_train), and the per-module learner
updates of the new API stack.

Protocol (gymnasium multi-agent shape):
    reset() -> ({agent_id: obs}, info)
    step({agent_id: action})
        -> ({agent_id: obs}, {agent_id: reward}, {agent_id: terminated},
            {agent_id: truncated}, info)
Agents may appear/disappear between steps; "__all__" in terminated ends
the episode for everyone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from ray_tpu_torch.rl.actor_manager import FaultTolerantActorManager
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.learner import PPOLearner, compute_gae
from ray_tpu_torch.rl.module import (get_initial_state, init_policy_params,
                               is_stateful, np_forward, np_sample_action,
                               np_stateful_sample_batch,
                               np_stateful_values)


class CoordinationGameEnv:
    """2-agent repeated matrix game: both get +1 when actions match, else
    0. Obs is each agent's OWN previous action (one-hot) — enough signal
    for two independent policies to converge on a convention. A standard
    multi-agent smoke test with a known optimum (reward_mean -> 1.0)."""

    agent_ids = ("agent_0", "agent_1")
    observation_size = 3
    num_actions = 3
    max_episode_steps = 32

    def __init__(self, seed: Optional[int] = None):
        self._steps = 0
        self._last = {a: 0 for a in self.agent_ids}

    def _obs(self):
        out = {}
        for a in self.agent_ids:
            v = np.zeros(self.observation_size, np.float32)
            v[self._last[a]] = 1.0
            out[a] = v
        return out

    def reset(self, seed: Optional[int] = None):
        self._steps = 0
        self._last = {a: 0 for a in self.agent_ids}
        return self._obs(), {}

    def step(self, actions: Dict[str, int]):
        self._steps += 1
        match = actions["agent_0"] == actions["agent_1"]
        rew = {a: 1.0 if match else 0.0 for a in self.agent_ids}
        self._last = dict(actions)
        trunc = self._steps >= self.max_episode_steps
        return (self._obs(), rew,
                {a: False for a in self.agent_ids},
                {a: trunc for a in self.agent_ids}, {})


class MultiAgentEnvRunner:
    """Rollout actor for multi-agent envs: per-agent trajectories are
    routed to per-POLICY buffers through the policy mapping (reference
    ``rllib/env/multi_agent_env_runner.py``).

    Stateful modules (rl/module.py contract) are supported on the acting
    path: each AGENT carries its own recurrent state (agents sharing a
    policy still have distinct histories), reset via ``is_first`` at
    episode boundaries. The bundled MultiAgentPPO trainer builds
    feedforward modules, so the recurrent plumbing here serves externally
    trained stateful policies (evaluation / league play)."""

    def __init__(self, env_spec, policy_mapping: Dict[str, str],
                 seed: int = 0, worker_index: int = 0):
        from ray_tpu_torch.rl.envs import make_env

        self.env = make_env(env_spec, seed=seed + worker_index)
        self._mapping = dict(policy_mapping)  # agent_id -> policy_id
        self._rng = np.random.default_rng(seed * 99991 + worker_index)
        self._params: Dict[str, Any] = {}     # policy_id -> params
        self._obs, _ = self.env.reset(seed=seed + worker_index)
        self._ep_return = 0.0
        self._weights_version = -1
        self._agent_state: Dict[str, Dict[str, np.ndarray]] = {}
        self._agent_first: Dict[str, bool] = {}
        # per-policy zero-state template, rebuilt only on set_weights —
        # _act runs per agent per step and must not re-derive it there
        self._state_templates: Dict[str, Dict[str, np.ndarray]] = {}

    def ping(self) -> bool:
        return True

    def set_weights(self, params_by_policy: Dict[str, Any],
                    version: int = 0) -> bool:
        self._params.update(params_by_policy)
        self._weights_version = version
        self._state_templates = {
            pid: get_initial_state(p, 1)
            for pid, p in self._params.items() if is_stateful(p)}
        return True

    def _act(self, agent_id: str, obs) -> Tuple[int, float, float]:
        """One action for one agent, carrying per-agent recurrent state
        for stateful policy modules."""
        pid = self._mapping[agent_id]
        params = self._params[pid]
        if not is_stateful(params):
            a, logp, value = np_sample_action(params, obs, self._rng)
            return int(a), logp, value
        tmpl = self._state_templates[pid]
        state = self._agent_state.get(agent_id)
        if state is None or set(state) != set(tmpl) or any(
                state[k].shape != tmpl[k].shape for k in tmpl):
            state = {k: v.copy() for k, v in tmpl.items()}
            self._agent_first[agent_id] = True
        first = np.array([self._agent_first.get(agent_id, True)], bool)
        a_b, lp_b, v_b, state = np_stateful_sample_batch(
            params, np.asarray(obs, np.float32)[None], state, first,
            self._rng)
        self._agent_state[agent_id] = state
        self._agent_first[agent_id] = False
        return int(a_b[0]), float(lp_b[0]), float(v_b[0])

    def sample(self, num_steps: int) -> Dict[str, Any]:
        # Buffers are PER AGENT, not per policy: agents sharing one policy
        # still have distinct trajectories, and GAE must bootstrap along
        # each agent's own value sequence — interleaving them would make
        # every TD delta use another agent's next-state value.
        buf: Dict[str, Dict[str, list]] = {}
        episode_returns: List[float] = []
        for _ in range(num_steps):
            actions, per_agent = {}, {}
            for agent_id, obs in self._obs.items():
                a, logp, value = self._act(agent_id, obs)
                actions[agent_id] = int(a)
                per_agent[agent_id] = (obs, a, logp, value)
            next_obs, rewards, terms, truncs, _ = self.env.step(actions)
            done = terms.get("__all__", False) or all(
                terms.get(a, False) or truncs.get(a, False)
                for a in actions)
            for agent_id, (obs, a, logp, value) in per_agent.items():
                b = buf.setdefault(agent_id, {
                    "obs": [], "actions": [], "rewards": [], "dones": [],
                    "logp": [], "values": []})
                b["obs"].append(obs)
                b["actions"].append(a)
                b["rewards"].append(rewards.get(agent_id, 0.0))
                b["dones"].append(done)
                b["logp"].append(logp)
                b["values"].append(value)
            self._ep_return += float(sum(rewards.values()))
            if done:
                episode_returns.append(self._ep_return)
                self._ep_return = 0.0
                self._obs, _ = self.env.reset()
                # drop (not just re-flag) per-agent recurrent state:
                # next _act restarts from the zero template anyway, and
                # envs that mint fresh agent ids per episode must not
                # accumulate dead agents' state forever
                self._agent_state.clear()
                self._agent_first.clear()
            else:
                self._obs = next_obs
        out = {}
        for agent_id, b in buf.items():
            pid = self._mapping[agent_id]
            last_val = 0.0
            if agent_id in self._obs:
                params = self._params[pid]
                obs1 = np.asarray(self._obs[agent_id],
                                  np.float32)[None]
                if is_stateful(params):
                    last_val = float(np_stateful_values(
                        params, obs1,
                        self._agent_state.get(agent_id)
                        or get_initial_state(params, 1),
                        np.array([self._agent_first.get(agent_id, True)],
                                 bool))[0])
                else:
                    _, v = np_forward(params, obs1)
                    last_val = float(v[0])
            out[agent_id] = {
                "policy_id": pid,
                "obs": np.asarray(b["obs"], np.float32),
                "actions": np.asarray(b["actions"], np.int32),
                "rewards": np.asarray(b["rewards"], np.float32),
                "dones": np.asarray(b["dones"], np.bool_),
                "logp": np.asarray(b["logp"], np.float32),
                "values": np.asarray(b["values"], np.float32),
                "last_value": last_val,
            }
        return {"agents": out, "episode_returns": episode_returns,
                "weights_version": self._weights_version}


class MultiAgentPPO(Algorithm):
    """PPO with one learner per policy (reference: the multi-module
    LearnerGroup update path)."""

    def __init__(self, config: "MultiAgentPPOConfig"):
        import ray_tpu_torch

        # NOTE: deliberately not calling Algorithm.__init__ — the runner
        # fleet is multi-agent-shaped.
        self.config = config
        self.iteration = 0
        self._weights_version = 0
        self._return_window: List[float] = []

        from ray_tpu_torch.rl.envs import make_env

        env = make_env(config.env)
        obs, _ = env.reset(seed=0)
        self._mapping = {
            agent_id: config.policy_mapping_fn(agent_id)
            for agent_id in obs
        }
        self.learners: Dict[str, PPOLearner] = {}
        for pid in sorted(set(self._mapping.values())):
            any_agent = next(a for a, p in self._mapping.items() if p == pid)
            import zlib

            # crc32, not hash(): hash() is salted per process and would
            # defeat config.seed reproducibility
            params = init_policy_params(
                int(np.asarray(obs[any_agent]).size),
                int(env.num_actions), hidden=tuple(config.hidden),
                seed=config.seed + zlib.crc32(pid.encode()) % 1000)
            self.learners[pid] = PPOLearner(
                params, lr=config.lr, clip=config.clip,
                vf_coeff=config.vf_coeff,
                entropy_coeff=config.entropy_coeff,
                num_epochs=config.num_epochs,
                minibatch_size=config.minibatch_size, seed=config.seed,
                device=config.learner_device)
        self._to_train = set(config.policies_to_train
                             or self.learners.keys())

        remote_runner = ray_tpu_torch.remote(MultiAgentEnvRunner)
        actors = [
            remote_runner.remote(config.env, self._mapping,
                                 seed=config.seed, worker_index=i)
            for i in range(config.num_env_runners)
        ]
        self.env_runner_group = FaultTolerantActorManager(actors)

    def get_weights(self) -> Dict[str, Any]:
        return {pid: lr.get_weights() for pid, lr in self.learners.items()}

    def training_step(self) -> Dict[str, Any]:
        self._maybe_restore_runners()
        weights = self.get_weights()
        version = self._weights_version
        self.env_runner_group.foreach_actor(
            lambda a: a.set_weights.remote(weights, version))
        results = self.env_runner_group.foreach_actor(
            lambda a: a.sample.remote(self.config.rollout_fragment_length))
        fragments = [r.value for r in results if r.ok]
        if not fragments:
            raise RuntimeError("no healthy env runners produced samples")

        returns: List[float] = []
        learner_metrics: Dict[str, Dict] = {}
        for pid in self.learners:
            if pid not in self._to_train:
                continue
            # one fragment per (runner, agent) trajectory of this policy
            frags = [af for f in fragments
                     for af in f["agents"].values()
                     if af["policy_id"] == pid]
            if not frags:
                continue
            advs, targets = [], []
            for f in frags:
                a, vt = compute_gae(
                    f["rewards"], f["values"], f["dones"], f["last_value"],
                    gamma=self.config.gamma, lam=self.config.lam)
                advs.append(a)
                targets.append(vt)
            batch = {
                "obs": np.concatenate([f["obs"] for f in frags]),
                "actions": np.concatenate([f["actions"] for f in frags]),
                "logp_old": np.concatenate([f["logp"] for f in frags]),
                "advantages": np.concatenate(advs),
                "value_targets": np.concatenate(targets),
            }
            adv = batch["advantages"]
            batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
            learner_metrics[pid] = self.learners[pid].update(batch)
        for f in fragments:
            returns.extend(f["episode_returns"])
        self._weights_version += 1
        self._return_window = (self._return_window + returns)[-100:]
        return {
            "env_runners": {
                "episode_return_mean": self.episode_return_mean(),
                "num_episodes": len(returns),
                "num_healthy_workers":
                    self.env_runner_group.num_healthy_actors(),
            },
            "learners": learner_metrics,
        }


@dataclasses.dataclass
class MultiAgentPPOConfig(AlgorithmConfig):
    lam: float = 0.95
    clip: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 4
    minibatch_size: int = 128
    policy_mapping_fn: Callable[[str], str] = lambda agent_id: agent_id
    policies_to_train: Optional[List[str]] = None
    algo_class = MultiAgentPPO

    def multi_agent(self, *, policy_mapping_fn=None,
                    policies_to_train=None) -> "MultiAgentPPOConfig":
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        if policies_to_train is not None:
            self.policies_to_train = policies_to_train
        return self
