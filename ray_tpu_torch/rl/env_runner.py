"""EnvRunner: rollout actor (port of ``ray_tpu/rl/env_runner.py``;
reference ``rllib/env/single_agent_env_runner.py:68``, ``sample:147``).

Numpy-only process (it imports neither torch nor CUDA): steps its env
with the inference copy of the policy, keeps env state across sample()
calls (truncation-free stitching), returns fixed-size rollout fragments
plus completed-episode returns for metrics.

Stateful modules (rl/module.py contract): the runner carries per-episode
recurrent state across sample() calls, flags ``is_first`` rows so the
module resets exactly at episode starts, and emits per-step ``state_in``
columns (the PRE-step carried state) plus ``is_first`` in every fragment —
sequence learners inject the recorded state at window starts instead of
burning in.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np

from ray_tpu_torch.rl.envs import make_env
from ray_tpu_torch.rl.module import Params, np_sample_action


def _make_connector(c):
    """Accept a Connector instance, a Connector subclass, or a zero-arg
    factory — factories/classes build per-runner instances (stateful
    connectors must not share state across runners by accident)."""
    from ray_tpu_torch.rl.connectors import Connector

    if isinstance(c, Connector):
        return c
    return c()


class EnvRunner:
    def __init__(self, env_spec: Union[str, Any] = "CartPole-v1",
                 seed: int = 0, worker_index: int = 0,
                 connectors=None, num_envs: int = 1,
                 module_to_env_connectors=None,
                 record_next_obs: bool = False):
        from ray_tpu_torch.rl.connectors import ConnectorPipeline

        self.num_envs = max(1, num_envs)
        # Off-policy TD consumers (DQN/SAC replay) need the TRUE successor
        # state per step; it doubles the fragment's obs payload, so it is
        # recorded only when the algorithm asks (on-policy GAE/v-trace and
        # the offline writer never read it).
        self._record_next_obs = record_next_obs
        # Vectorization (reference rllib/env/vector/): N env copies stepped
        # in lockstep with ONE batched policy forward per step — sampling
        # throughput stops walling on per-env matmul overhead.
        self.envs = [make_env(env_spec,
                              seed=seed + worker_index * 1000 + i)
                     for i in range(self.num_envs)]
        self.env = self.envs[0]  # back-compat alias
        self._rng = np.random.default_rng(seed * 100003 + worker_index)
        self._params: Optional[Params] = None
        # env-to-module pipeline: raw obs -> what the policy consumes
        # (reference connector_v2 env-runner pipeline)
        self._pipeline = ConnectorPipeline(
            [_make_connector(c) for c in (connectors or [])])
        # module-to-env pipeline: policy action -> env action
        self._m2e = ConnectorPipeline(
            [_make_connector(c) for c in (module_to_env_connectors or [])])
        obs0 = []
        for i, env in enumerate(self.envs):
            raw, _ = env.reset(seed=seed + worker_index * 1000 + i)
            obs0.append(self._pipeline(raw))
        self._obs = obs0[0]
        self._obs_vec = np.stack(obs0)
        self._episode_return = 0.0
        self._episode_returns_vec = np.zeros(self.num_envs)
        self._weights_version = -1
        # recurrent-module state: carried across sample() calls, reset
        # per env on is_first (lazily sized once params are known)
        self._policy_state = None
        self._is_first_vec = np.ones(self.num_envs, bool)

    def get_connector_state(self):
        if self._m2e.connectors:
            return {"env_to_module": self._pipeline.get_state(),
                    "module_to_env": self._m2e.get_state()}
        return self._pipeline.get_state()

    def set_connector_state(self, state) -> bool:
        if isinstance(state, dict) and "env_to_module" in state:
            self._pipeline.set_state(state["env_to_module"])
            self._m2e.set_state(state.get("module_to_env", {}))
        else:
            self._pipeline.set_state(state)
        return True

    def ping(self) -> bool:
        return True

    def set_weights(self, params: Params, version: int = 0) -> bool:
        self._params = params
        self._weights_version = version
        return True

    def get_weights_version(self) -> int:
        return self._weights_version

    def sample(self, num_steps: int):
        """One fragment dict for num_envs == 1 (back-compat), else a LIST
        of per-env fragment dicts — each a normal fragment, so every
        consumer (GAE, aggregators, v-trace) is unchanged. Stateful
        modules always take the vector path (state is batched per env)."""
        from ray_tpu_torch.rl.module import is_stateful

        stateful = self._params is not None and is_stateful(self._params)
        if self.num_envs > 1 or stateful:
            if self.num_envs == 1:
                self._episode_returns_vec[0] = self._episode_return
            frags = self._sample_vector(num_steps)
            if self.num_envs == 1:
                # keep the single-env aliases fresh in case a later
                # weights broadcast switches back to a feedforward module
                self._obs = self._obs_vec[0]
                self._episode_return = float(self._episode_returns_vec[0])
                return frags[0]
            return frags
        frag = self._sample_single(num_steps)
        self._obs_vec[0] = self._obs
        self._episode_returns_vec[0] = self._episode_return
        return frag

    def _ensure_policy_state(self):
        """(Re)allocate carried state when params first arrive or change
        family/shape; fresh state restarts every env as is_first."""
        from ray_tpu_torch.rl.module import get_initial_state

        init = get_initial_state(self._params, self.num_envs)
        cur = self._policy_state
        if (cur is None or set(cur) != set(init)
                or any(cur[k].shape != init[k].shape for k in init)):
            self._policy_state = init
            self._is_first_vec = np.ones(self.num_envs, bool)

    def _sample_vector(self, num_steps: int):
        from ray_tpu_torch.rl.module import (
            action_spec, is_continuous, is_stateful, np_forward,
            np_sample_actions_batch, np_sample_continuous_batch,
            np_stateful_sample_batch, np_stateful_values)

        assert self._params is not None, "set_weights first"
        N = self.num_envs
        cont = is_continuous(self._params)
        stateful = is_stateful(self._params)
        a_shape, a_dtype = action_spec(self._params)
        sampler = (np_sample_continuous_batch if cont
                   else np_sample_actions_batch)
        obs_buf = np.empty((N, num_steps) + self._obs_vec.shape[1:],
                           np.float32)
        act_buf = np.empty((N, num_steps) + a_shape, a_dtype)
        rew_buf = np.empty((N, num_steps), np.float32)
        done_buf = np.empty((N, num_steps), np.bool_)
        term_buf = np.empty((N, num_steps), np.bool_)
        next_obs_buf = (np.empty_like(obs_buf) if self._record_next_obs
                        else None)
        logp_buf = np.empty((N, num_steps), np.float32)
        val_buf = np.empty((N, num_steps), np.float32)
        episode_returns = [[] for _ in range(N)]
        state_bufs = first_buf = None
        if stateful:
            self._ensure_policy_state()
            state_bufs = {
                k: np.empty((N, num_steps) + v.shape[1:], np.float32)
                for k, v in self._policy_state.items()}
            first_buf = np.empty((N, num_steps), np.bool_)

        for t in range(num_steps):
            if stateful:
                # record the PRE-step carried state + is_first flag; the
                # module applies its own reset internally, and sequence
                # learners replay the exact same reset from these columns
                first_buf[:, t] = self._is_first_vec
                for k, v in self._policy_state.items():
                    state_bufs[k][:, t] = v
                actions, logps, values, self._policy_state = \
                    np_stateful_sample_batch(
                        self._params, self._obs_vec, self._policy_state,
                        self._is_first_vec, self._rng)
                self._is_first_vec[:] = False
            else:
                actions, logps, values = sampler(
                    self._params, self._obs_vec, self._rng)
            obs_buf[:, t] = self._obs_vec
            act_buf[:, t] = actions
            logp_buf[:, t] = logps
            val_buf[:, t] = values
            for i, env in enumerate(self.envs):
                raw, reward, terminated, truncated, _ = env.step(
                    self._m2e(actions[i] if cont else int(actions[i])))
                self._obs_vec[i] = self._pipeline(raw)
                rew_buf[i, t] = reward
                done_buf[i, t] = terminated or truncated
                # TD consumers need the TRUE successor state (pre-reset)
                # and termination distinct from time-limit truncation
                term_buf[i, t] = terminated
                if next_obs_buf is not None:
                    next_obs_buf[i, t] = self._obs_vec[i]
                self._episode_returns_vec[i] += reward
                if terminated or truncated:
                    episode_returns[i].append(
                        float(self._episode_returns_vec[i]))
                    self._episode_returns_vec[i] = 0.0
                    if self.num_envs == 1:
                        # single-env semantics (stateful modules route
                        # here too): episodic connectors flush exactly
                        # as in _sample_single. With N > 1 the pipeline
                        # is shared across envs, so per-env resets stay
                        # undefined (pre-existing vector behavior).
                        self._pipeline.reset()
                        self._m2e.reset()
                    raw, _ = env.reset()
                    self._obs_vec[i] = self._pipeline(raw)
                    self._is_first_vec[i] = True

        if cont:     # off-policy consumers bootstrap from their critics
            last_vals = np.zeros(N, np.float32)
        elif stateful:
            last_vals = np_stateful_values(
                self._params, self._obs_vec, self._policy_state,
                self._is_first_vec)
        else:
            _, last_vals = np_forward(self._params, self._obs_vec)
        out = []
        for i in range(N):
            frag = {"obs": obs_buf[i], "actions": act_buf[i],
                    "rewards": rew_buf[i], "dones": done_buf[i],
                    "terminated": term_buf[i],
                    "logp": logp_buf[i], "values": val_buf[i],
                    "last_value": float(last_vals[i]),
                    "episode_returns": episode_returns[i],
                    "weights_version": self._weights_version}
            if next_obs_buf is not None:
                frag["next_obs"] = next_obs_buf[i]
            if stateful:
                frag["state_in"] = {k: v[i] for k, v in state_bufs.items()}
                frag["is_first"] = first_buf[i]
            out.append(frag)
        return out

    def _sample_single(self, num_steps: int) -> Dict[str, Any]:
        from ray_tpu_torch.rl.module import (
            action_spec, is_continuous, np_sample_continuous_batch)

        assert self._params is not None, "set_weights first"
        cont = is_continuous(self._params)
        a_shape, a_dtype = action_spec(self._params)
        obs_buf = np.empty((num_steps,) + self._obs.shape, np.float32)
        act_buf = np.empty((num_steps,) + a_shape, a_dtype)
        rew_buf = np.empty(num_steps, np.float32)
        done_buf = np.empty(num_steps, np.bool_)      # episode boundary
        term_buf = np.empty(num_steps, np.bool_)      # true termination
        next_obs_buf = (np.empty_like(obs_buf) if self._record_next_obs
                        else None)
        logp_buf = np.empty(num_steps, np.float32)
        val_buf = np.empty(num_steps, np.float32)
        episode_returns = []

        for t in range(num_steps):
            if cont:
                a_b, lp_b, v_b = np_sample_continuous_batch(
                    self._params, self._obs[None], self._rng)
                action, logp, value = a_b[0], float(lp_b[0]), float(v_b[0])
            else:
                action, logp, value = np_sample_action(
                    self._params, self._obs, self._rng)
            obs_buf[t] = self._obs
            act_buf[t] = action
            logp_buf[t] = logp
            val_buf[t] = value
            raw, reward, terminated, truncated, _ = self.env.step(
                self._m2e(action))
            self._obs = self._pipeline(raw)
            rew_buf[t] = reward
            # Truncation treated as termination for GAE (standard
            # simplification: no next-state bootstrap at the cut); TD
            # consumers get the distinct `terminated` flag + the TRUE
            # (pre-reset) successor state instead.
            done_buf[t] = terminated or truncated
            term_buf[t] = terminated
            if next_obs_buf is not None:
                next_obs_buf[t] = self._obs
            self._episode_return += reward
            if terminated or truncated:
                episode_returns.append(self._episode_return)
                self._episode_return = 0.0
                self._pipeline.reset()
                self._m2e.reset()
                raw, _ = self.env.reset()
                self._obs = self._pipeline(raw)

        # Bootstrap value for the (possibly mid-episode) final state.
        from ray_tpu_torch.rl.module import np_forward

        if cont:     # off-policy consumers bootstrap from their critics
            last_val = np.zeros(1, np.float32)
        else:
            _, last_val = np_forward(self._params, self._obs[None])
        frag = {
            "obs": obs_buf, "actions": act_buf, "rewards": rew_buf,
            "dones": done_buf, "terminated": term_buf,
            "logp": logp_buf, "values": val_buf,
            "last_value": float(last_val[0]),
            "episode_returns": episode_returns,
            "weights_version": self._weights_version,
        }
        if next_obs_buf is not None:
            frag["next_obs"] = next_obs_buf
        return frag
