"""Algorithm: the sample→learn control loop (port of
``ray_tpu/rl/algorithm.py``).

Reference: ``rllib/algorithms/algorithm.py:207`` (Algorithm),
``algorithm_config.py`` (builder-style config), PPO ``training_step`` at
``rllib/algorithms/ppo/ppo.py:388``: fan out sampling to the EnvRunner
fleet via FaultTolerantActorManager, update the learner, broadcast weights.
The env runners are numpy-only actors; the in-process learner runs on CUDA
unless ``learner_device`` asks for the CPU (the JAX package's learner runs
on its default device).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ray_tpu_torch.rl.actor_manager import FaultTolerantActorManager
from ray_tpu_torch.rl.env_runner import EnvRunner
from ray_tpu_torch.rl.learner import PPOLearner, build_ppo_batch, compute_gae  # noqa: F401 — compute_gae re-exported for existing importers
from ray_tpu_torch.rl.module import init_lstm_policy_params, init_policy_params


@dataclasses.dataclass
class AlgorithmConfig:
    env: Union[str, Any] = "CartPole-v1"
    # factories producing fresh Connector instances per env runner
    connectors: tuple = ()
    # module-to-env (action-path) connector factories per env runner
    module_to_env_connectors: tuple = ()
    # learner-side batch connectors (applied just before each update)
    learner_connectors: tuple = ()
    num_env_runners: int = 2
    # vectorized envs per runner (reference num_envs_per_env_runner +
    # rllib/env/vector/): N env copies per actor, one batched policy
    # forward per step; sample() then returns N per-env fragments
    num_envs_per_env_runner: int = 1
    rollout_fragment_length: int = 256
    # record the true successor state per step in fragments (doubles the
    # obs payload; off-policy configs turn it on, on-policy never read it)
    record_next_obs: bool = False
    gamma: float = 0.99
    lr: float = 3e-4
    seed: int = 0
    # network
    hidden: tuple = (64, 64)
    # restart dead env runners on the next step
    restart_failed_env_runners: bool = True
    # the in-process learner's device: None is CUDA, "cpu" the CPU
    learner_device: Optional[str] = None

    def environment(self, env) -> "AlgorithmConfig":
        self.env = env
        return self

    def env_runners(self, num_env_runners: int,
                    num_envs_per_env_runner: Optional[int] = None
                    ) -> "AlgorithmConfig":
        self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown training param {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "Algorithm":
        return self.algo_class(self)  # type: ignore[attr-defined]


class Algorithm:
    """Base sample→learn loop driver (reference ``Algorithm.step:986``)."""

    def __init__(self, config: AlgorithmConfig):
        import ray_tpu_torch

        self.config = config
        self.iteration = 0
        self._weights_version = 0
        self._env_probe = _probe_env(config.env, config.connectors)
        remote_runner = ray_tpu_torch.remote(EnvRunner)
        actors = [
            remote_runner.remote(
                config.env, seed=config.seed, worker_index=i,
                connectors=list(config.connectors),
                num_envs=getattr(config, "num_envs_per_env_runner", 1),
                module_to_env_connectors=list(
                    getattr(config, "module_to_env_connectors", ())),
                record_next_obs=getattr(config, "record_next_obs", False))
            for i in range(config.num_env_runners)
        ]
        self.env_runner_group = FaultTolerantActorManager(actors)
        self._return_window: List[float] = []
        from ray_tpu_torch.rl.connectors import LearnerConnectorPipeline

        self._learner_pipeline = LearnerConnectorPipeline([
            c if not isinstance(c, type) else c()
            for c in getattr(config, "learner_connectors", ())])

    # -------------------------------------------------------------- train
    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        self.iteration += 1
        results = self.training_step()
        results.setdefault("training_iteration", self.iteration)
        results["time_this_iter_s"] = time.perf_counter() - t0
        return results

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def _maybe_restore_runners(self):
        if self.config.restart_failed_env_runners:
            self.env_runner_group.probe_health()

    def _sample_fragments(self) -> List[Dict[str, Any]]:
        self._maybe_restore_runners()
        version = self._weights_version
        weights = self.get_weights()
        self.env_runner_group.foreach_actor(
            lambda a: a.set_weights.remote(weights, version))
        results = self.env_runner_group.foreach_actor(
            lambda a: a.sample.remote(self.config.rollout_fragment_length))
        if self.config.connectors:
            # sync stateful connector stats (e.g. obs-normalizer running
            # mean/var) runner 0 -> fleet, so policies see one distribution
            states = self.env_runner_group.foreach_actor(
                lambda a: a.get_connector_state.remote())
            good = [r.value for r in states if r.ok]
            if good:
                self.env_runner_group.foreach_actor(
                    lambda a: a.set_connector_state.remote(good[0]))
        out: List[Dict[str, Any]] = []
        for r in results:
            if not r.ok:
                continue
            # vectorized runners return a LIST of per-env fragments
            out.extend(r.value if isinstance(r.value, list) else [r.value])
        return out

    def episode_return_mean(self) -> float:
        if not self._return_window:
            return float("nan")
        return float(np.mean(self._return_window[-100:]))

    def get_weights(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    # ---------------------------------------------------------- checkpoints
    def save_checkpoint(self, path: str) -> str:
        """Component-tree checkpoint (reference: Checkpointable mixin,
        rllib/utils/checkpoints.py — Algorithm -> Learner weights +
        connector states on BOTH the env-runner and learner sides)."""
        import os
        import pickle

        os.makedirs(path, exist_ok=True)
        runner_states = [
            r.value for r in self.env_runner_group.foreach_actor(
                lambda a: a.get_connector_state.remote())
            if r.ok
        ]
        state = {
            "weights": self.get_weights(),
            "iteration": self.iteration,
            "weights_version": self._weights_version,
            "return_window": list(self._return_window),
            "env_runner_connector_state": (runner_states[0]
                                           if runner_states else None),
            "learner_connector_state": self._learner_pipeline.get_state(),
        }
        # learners with state beyond the policy weights (SAC: critics,
        # targets, α, optimizer moments) checkpoint it all
        learner = getattr(self, "learner", None)
        if learner is not None and hasattr(learner, "get_state"):
            state["learner_state"] = learner.get_state()
        fname = os.path.join(path, "algorithm_state.pkl")
        with open(fname, "wb") as f:
            pickle.dump(state, f)
        return fname

    def restore_from_checkpoint(self, path: str) -> None:
        import os
        import pickle

        fname = (path if path.endswith(".pkl")
                 else os.path.join(path, "algorithm_state.pkl"))
        with open(fname, "rb") as f:
            state = pickle.load(f)
        learner = getattr(self, "learner", None)
        if state.get("learner_state") is not None and learner is not None \
                and hasattr(learner, "set_state"):
            learner.set_state(state["learner_state"])
        self.set_weights(state["weights"])
        self.iteration = state["iteration"]
        self._weights_version = state["weights_version"]
        self._return_window = list(state["return_window"])
        if state.get("env_runner_connector_state") is not None:
            cs = state["env_runner_connector_state"]
            self.env_runner_group.foreach_actor(
                lambda a: a.set_connector_state.remote(cs))
        self._learner_pipeline.set_state(
            state.get("learner_connector_state", {}))

    def set_weights(self, weights: Dict[str, np.ndarray]) -> None:
        learner = getattr(self, "learner", None)
        group = getattr(self, "learner_group", None)
        if group is not None:
            group.set_weights(weights)
        elif learner is not None:
            learner.set_weights(weights)
        else:
            raise NotImplementedError

    def stop(self):
        for i in list(self.env_runner_group.actors):
            self.env_runner_group.remove_actor(i)

    # ------------------------------------------------------------ scale-out
    def scale_out(self, podracer: "Any"):
        """Podracer scale-out (rl/podracer.py): Sebulba mode returns a
        live :class:`~ray_tpu_torch.rl.podracer.SebulbaHandle` streaming
        fragments from dedicated runner actors into a learner actor (on a
        GPU lease when the learner device is CUDA); Anakin mode returns an
        :class:`~ray_tpu_torch.rl.podracer.Anakin` running in-device
        updates.  ``stop()``/``train()`` fold the trained weights back
        into this algorithm."""
        from ray_tpu_torch.rl.podracer import scale_out as _scale_out

        return _scale_out(self, podracer)


class PPO(Algorithm):
    def __init__(self, config: "PPOConfig"):
        super().__init__(config)
        if getattr(config, "module", "mlp") == "lstm":
            # recurrent policy (rl/module.py stateful contract); width is
            # the first entry of `hidden` — one cell, not a stack
            params = init_lstm_policy_params(
                self._env_probe["obs_size"],
                self._env_probe["num_actions"],
                hidden=int(config.hidden[0]), seed=config.seed)
        else:
            params = init_policy_params(
                self._env_probe["obs_size"],
                self._env_probe["num_actions"],
                hidden=tuple(config.hidden), seed=config.seed)
        self.learner = PPOLearner(
            params, lr=config.lr, clip=config.clip,
            vf_coeff=config.vf_coeff, entropy_coeff=config.entropy_coeff,
            num_epochs=config.num_epochs,
            minibatch_size=config.minibatch_size, seed=config.seed,
            device=config.learner_device)

    def get_weights(self):
        return self.learner.get_weights()

    def training_step(self) -> Dict[str, Any]:
        fragments = self._sample_fragments()
        if not fragments:
            raise RuntimeError("no healthy env runners produced samples")
        batch, returns, env_steps = build_ppo_batch(
            fragments, gamma=self.config.gamma, lam=self.config.lam,
            seq_len=self.config.seq_len)
        batch = self._learner_pipeline(batch)
        metrics = self.learner.update(batch)
        self._weights_version += 1
        self._return_window = (self._return_window + returns)[-100:]
        return {
            "env_runners": {
                "episode_return_mean": self.episode_return_mean(),
                "num_episodes": len(returns),
                "num_env_steps_sampled": env_steps,
                "num_healthy_workers":
                    self.env_runner_group.num_healthy_actors(),
            },
            "learners": {"default_policy": metrics},
        }


@dataclasses.dataclass
class PPOConfig(AlgorithmConfig):
    lam: float = 0.95
    clip: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 4
    minibatch_size: int = 128
    # module family: "mlp" (feedforward twin towers) or "lstm" (stateful
    # recurrent policy; training then uses (B, seq_len) windows)
    module: str = "mlp"
    seq_len: int = 16
    algo_class = PPO


def _probe_env(env_spec, connectors=()) -> Dict[str, int]:
    from ray_tpu_torch.rl.connectors import ConnectorPipeline
    from ray_tpu_torch.rl.envs import make_env

    env = make_env(env_spec)
    obs, _ = env.reset(seed=0)
    obs_size = int(np.asarray(obs).size)
    if connectors:
        from ray_tpu_torch.rl.env_runner import _make_connector

        # size-only computation (output_size chains transformed_size):
        # running instances on a real obs would mutate stateful connector
        # INSTANCES that then ship contaminated to every runner
        pipeline = ConnectorPipeline([_make_connector(c)
                                      for c in connectors])
        obs_size = pipeline.output_size(obs_size)
    num_actions = getattr(env, "num_actions", None)
    if num_actions is None:
        space = getattr(env, "action_space", None)
        num_actions = getattr(space, "n", None)
    if num_actions is None:
        # continuous env: action_dim (+ symmetric bound) instead of a
        # discrete count (reference: Box vs Discrete action spaces)
        action_dim = getattr(env, "action_dim", None)
        if action_dim is None:
            raise ValueError(
                f"env {env_spec!r} exposes neither num_actions nor "
                "action_dim")
        return {"obs_size": obs_size, "continuous": True,
                "action_dim": int(action_dim),
                "action_scale": float(getattr(env, "action_high", 1.0))}
    return {"obs_size": obs_size, "num_actions": int(num_actions)}
