"""DQN: off-policy Q-learning with replay and a target network (port of
``ray_tpu/rl/dqn.py``).

Reference: ``rllib/algorithms/dqn/`` (replay-buffer driven
``training_step``, double-Q target, periodic target-net sync). The update
is one double-DQN step over a replayed minibatch on the learner's device
(None means CUDA, and raises without it); replay sampling stays in numpy
on the host. Its Adam is optax's ``adam(lr)`` written out
(``rl/learner.py::_Adam``).

Exploration: env runners sample categorically from softmax(outputs)
(see module.np_sample_action), so running them on Q-values gives
Boltzmann (soft-Q) exploration — one of the reference's stock DQN
exploration strategies — with no runner-side special casing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.learner import _Adam, _tensors, value_and_grad
from ray_tpu_torch.rl.replay import (  # noqa: F401  (re-export)
    ReplayBuffer,
    transitions_from_fragment,
)
from ray_tpu_torch.rl.module import init_policy_params, torch_forward


class DQNLearner:
    """Double-DQN update with Huber loss + periodic target sync."""

    def __init__(self, params: Dict[str, np.ndarray], *, lr: float,
                 gamma: float, target_update_freq: int, device=None):
        from ray_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self._params = _tensors(dict(params), self.device)
        self._target = dict(self._params)
        self._gamma = gamma
        self._freq = max(1, target_update_freq)
        self._updates = 0
        self._opt = _Adam(lr, None)
        self._opt_state = self._opt.init(self._params)

    def _loss(self, params, batch):
        import torch

        q, _ = torch_forward(params, batch["obs"])
        q_next_online, _ = torch_forward(params, batch["next_obs"])
        q_next_target, _ = torch_forward(self._target, batch["next_obs"])
        # double-DQN: online net picks the action, target net rates it
        next_a = q_next_online.argmax(dim=-1)
        next_q = q_next_target.gather(1, next_a[:, None])[:, 0]
        td_target = batch["rewards"] + self._gamma * next_q * (
            1.0 - batch["dones"])
        q_taken = q.gather(1, batch["actions"][:, None].long())[:, 0]
        err = q_taken - td_target.detach()
        huber = torch.where(err.abs() <= 1.0, 0.5 * err * err,
                            err.abs() - 0.5)
        return huber.mean(), {"td_error_mean": err.abs().mean(),
                              "q_mean": q_taken.mean()}

    def step(self, batch) -> Dict[str, Any]:
        """One update from a batch of tensors on the device; metrics stay
        tensors (no host sync)."""
        loss, aux, grads = value_and_grad(self._loss, self._params, batch)
        self._params, self._opt_state = self._opt.update(
            grads, self._opt_state, self._params)
        self._updates += 1
        if self._updates % self._freq == 0:
            self._target = self._params
        return {"loss": loss, **aux}

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        tb = _tensors(batch, self.device)
        tb["rewards"] = tb["rewards"].float()
        tb["dones"] = tb["dones"].float()
        return {k: float(v) for k, v in self.step(tb).items()}

    def get_weights(self) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() for k, v in self._params.items()}


class DQN(Algorithm):
    """Sample → replay → N minibatch updates per iteration."""

    def __init__(self, config: "DQNConfig"):
        super().__init__(config)
        params = init_policy_params(
            self._env_probe["obs_size"], self._env_probe["num_actions"],
            hidden=tuple(config.hidden), seed=config.seed)
        self.learner = DQNLearner(
            params, lr=config.lr, gamma=config.gamma,
            target_update_freq=config.target_update_freq,
            device=config.learner_device)
        self.replay = ReplayBuffer(config.replay_capacity,
                                   seed=config.seed)

    def get_weights(self):
        return self.learner.get_weights()

    def training_step(self) -> Dict[str, Any]:
        cfg: DQNConfig = self.config  # type: ignore[assignment]
        fragments = self._sample_fragments()
        if not fragments:
            raise RuntimeError("no healthy env runners produced samples")
        returns: List[float] = []
        for f in fragments:
            self.replay.add_fragment(transitions_from_fragment(f))
            returns.extend(f["episode_returns"])
        metrics: Dict[str, float] = {}
        if len(self.replay) >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iteration):
                metrics = self.learner.update(
                    self.replay.sample(cfg.train_batch_size))
        self._weights_version += 1
        self._return_window = (self._return_window + returns)[-100:]
        return {
            "env_runners": {
                "episode_return_mean": self.episode_return_mean(),
                "num_episodes": len(returns),
                "num_env_steps_sampled": sum(
                    len(f["obs"]) for f in fragments),
                "num_healthy_workers":
                    self.env_runner_group.num_healthy_actors(),
            },
            "learners": {"default_policy": metrics},
            "replay_buffer_size": len(self.replay),
        }


@dataclasses.dataclass
class DQNConfig(AlgorithmConfig):
    lr: float = 1e-3
    record_next_obs: bool = True   # off-policy TD needs true successors
    replay_capacity: int = 50_000
    learning_starts: int = 500
    train_batch_size: int = 64
    updates_per_iteration: int = 16
    target_update_freq: int = 32
    algo_class = DQN
