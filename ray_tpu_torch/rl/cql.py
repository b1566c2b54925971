"""CQL: conservative Q-learning for offline RL (port of
``ray_tpu/rl/cql.py``).

Reference: ``rllib/algorithms/cql/cql.py`` (CQL(H) on top of SAC: the
twin critics additionally minimize a conservative regularizer
``logsumexp_a Q(s, a) - Q(s, a_data)`` so out-of-distribution actions
cannot carry inflated values — the failure mode of running plain SAC on
a fixed dataset).

:class:`CQLLearner` is :class:`SACLearner` with the
``_conservative_penalty`` hook filled in. Its out-of-distribution
actions are draws too: ``cql_rand`` (N uniform actions per state in
[-scale, scale)), ``cql_eps_pi`` and ``cql_eps_pin`` (the normals of the
policy's actions at s and s'), made by :meth:`CQLLearner.draws` beside
SAC's, or passed in.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ray_tpu_torch.rl.replay import ReplayBuffer, transitions_from_fragment
from ray_tpu_torch.rl.offline import JsonReader
from ray_tpu_torch.rl.sac import SACLearner


class CQLLearner(SACLearner):
    def __init__(self, *args, cql_alpha: float = 1.0,
                 cql_n_actions: int = 4, **kwargs):
        self.cql_alpha = cql_alpha
        self.cql_n_actions = cql_n_actions
        super().__init__(*args, **kwargs)

    def draws(self, n: int) -> Dict[str, Any]:
        import torch

        out = super().draws(n)
        shape = (n, self.action_dim)
        scale = self.actor["action_scale"]
        u = torch.rand((self.cql_n_actions,) + shape, generator=self._gen,
                       device=self.device)
        out["cql_rand"] = u * (2 * scale) - scale
        for k in ("cql_eps_pi", "cql_eps_pin"):
            out[k] = torch.randn(shape, generator=self._gen,
                                 device=self.device)
        return out

    def _conservative_penalty(self, qs, actor, batch, draws):
        """logsumexp over {uniform, pi(s), pi(s')} actions minus the
        dataset action's Q, per critic (CQL(H), ``cql.py`` cql_loss)."""
        import torch

        p1, p2 = qs
        qf, sample = self._q_forward, self._sample_squashed
        obs = batch["obs"]
        rand = draws["cql_rand"]
        samples = []  # each: (q1_vals, q2_vals) of shape (n,)
        for i in range(self.cql_n_actions):
            samples.append((qf(p1, obs, rand[i]), qf(p2, obs, rand[i])))
        with torch.no_grad():
            a_pi, _ = sample(actor, obs, draws["cql_eps_pi"])
            a_pin, _ = sample(actor, batch["next_obs"], draws["cql_eps_pin"])
        samples.append((qf(p1, obs, a_pi), qf(p2, obs, a_pi)))
        samples.append((qf(p1, obs, a_pin), qf(p2, obs, a_pin)))

        q1_cat = torch.stack([s[0] for s in samples])  # (k, n)
        q2_cat = torch.stack([s[1] for s in samples])
        q1_data = qf(p1, obs, batch["actions"])
        q2_data = qf(p2, obs, batch["actions"])
        pen1 = (torch.logsumexp(q1_cat, dim=0) - q1_data).mean()
        pen2 = (torch.logsumexp(q2_cat, dim=0) - q2_data).mean()
        return self.cql_alpha * (pen1 + pen2)


@dataclasses.dataclass
class CQLConfig:
    input_path: str = ""
    cql_alpha: float = 1.0
    cql_n_actions: int = 4
    lr: float = 3e-4                      # actor
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    train_batch_size: int = 256
    updates_per_iteration: int = 100
    hidden: tuple = (64, 64)
    seed: int = 0
    env: Union[str, Any] = "Pendulum-v1"  # only needed for evaluate()
    # the learner's device: None is CUDA, "cpu" the CPU
    learner_device: Optional[str] = None

    def build(self) -> "CQL":
        return CQL(self)


class CQL:
    """Offline training loop: dataset -> replay minibatches -> conservative
    SAC updates. No environment interaction."""

    def __init__(self, config: CQLConfig):
        self.config = config
        frags: List[dict] = list(JsonReader(config.input_path))
        if not frags:
            raise ValueError(f"no data under {config.input_path}")
        obs_dim = np.asarray(frags[0]["obs"], np.float32).shape[-1]
        act = np.asarray(frags[0]["actions"])
        if act.dtype.kind in "iub":
            raise ValueError("CQL is continuous-control (got int actions)")
        action_dim = 1 if act.ndim == 1 else act.shape[-1]
        # action bound from the data (the env's scale isn't in the log)
        a_max = max(float(np.abs(np.asarray(f["actions"])).max())
                    for f in frags)
        self.replay = ReplayBuffer(
            capacity=sum(len(f["actions"]) for f in frags),
            seed=config.seed)
        for f in frags:
            t = transitions_from_fragment(f)
            if t["actions"].ndim == 1:
                t["actions"] = t["actions"][:, None]
            self.replay.add_fragment(t)
        self.learner = CQLLearner(
            obs_dim, action_dim, hidden=tuple(config.hidden),
            actor_lr=config.lr, critic_lr=config.critic_lr,
            alpha_lr=config.alpha_lr, gamma=config.gamma, tau=config.tau,
            action_scale=max(a_max, 1e-3), seed=config.seed,
            cql_alpha=config.cql_alpha,
            cql_n_actions=config.cql_n_actions,
            device=config.learner_device)
        self.iteration = 0

    def train(self) -> Dict[str, Any]:
        from ray_tpu_torch.rl.learner import _tensors

        self.iteration += 1
        learner = self.learner
        agg: Dict[str, List[Any]] = {}
        for _ in range(self.config.updates_per_iteration):
            batch = _tensors(self.replay.sample(
                self.config.train_batch_size), learner.device)
            batch["rewards"] = batch["rewards"].float()
            m = learner.step(batch, learner.draws(len(batch["obs"])))
            for k, v in m.items():
                agg.setdefault(k, []).append(v)
        metrics = {k: float(np.mean([float(x) for x in v]))
                   for k, v in agg.items()}
        metrics["training_iteration"] = self.iteration
        metrics["dataset_size"] = len(self.replay)
        return metrics

    def evaluate(self, num_episodes: int = 5,
                 seed: int = 100) -> Dict[str, float]:
        """Deterministic (mean-action) rollouts of the learned actor."""
        from ray_tpu_torch.rl.envs import make_env
        from ray_tpu_torch.rl.module import np_continuous_dist

        env = make_env(self.config.env, seed=seed)
        actor = self.learner.get_weights()
        returns = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=seed + ep)
            total, done = 0.0, False
            while not done:
                mu, _ = np_continuous_dist(actor, np.asarray(obs)[None])
                a = np.tanh(mu[0]) * actor["action_scale"]
                obs, r, term, trunc, _ = env.step(a)
                total += r
                done = term or trunc
            returns.append(total)
        return {"episode_return_mean": float(np.mean(returns))}
