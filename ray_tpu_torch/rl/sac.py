"""SAC: off-policy maximum-entropy actor-critic for continuous control
(port of ``ray_tpu/rl/sac.py``).

Reference: ``rllib/algorithms/sac/sac.py`` (+ ``sac_learner.py`` /
``default_sac_rl_module.py``): twin soft Q-functions with polyak-averaged
targets, a tanh-squashed Gaussian actor, and learned entropy temperature
α against a -|A| target entropy. The whole update (critic, actor, α,
polyak) runs on the learner's device (None means CUDA) with no host sync;
replay sampling stays host-side numpy (same split as DQN).

The JAX step draws its normals from ``jax.random`` inside the jitted
function. torch cannot reproduce those draws, so :meth:`SACLearner.step`
is a function of its draws (``eps_next`` for the target's next-state
actions, ``eps_pi`` for the actor's), which :meth:`SACLearner.draws`
makes from the learner's ``torch.Generator`` on its device; a caller
holding the JAX draws passes them in instead.

Runner side: the actor's weights are module.py continuous-policy params,
so stock :class:`EnvRunner` actors sample exploration actions from the
squashed Gaussian with no SAC-specific code.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.learner import _Adam, _tensors, value_and_grad
from ray_tpu_torch.rl.replay import ReplayBuffer, transitions_from_fragment
from ray_tpu_torch.rl.module import (
    LOGSTD_MAX, LOGSTD_MIN, init_continuous_policy_params)

_LOG_2PI = math.log(2 * math.pi)


def _init_q_params(obs_size: int, action_dim: int, hidden, seed: int,
                   prefix: str) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    params = {}
    sizes = (obs_size + action_dim,) + tuple(hidden)
    for i in range(len(hidden)):
        params[f"{prefix}{i}_w"] = (
            rng.standard_normal((sizes[i], sizes[i + 1]))
            * np.sqrt(2.0 / sizes[i])).astype(np.float32)
        params[f"{prefix}{i}_b"] = np.zeros(sizes[i + 1], np.float32)
    params[f"{prefix}h_w"] = (rng.standard_normal((sizes[-1], 1))
                              * 0.01).astype(np.float32)
    params[f"{prefix}h_b"] = np.zeros(1, np.float32)
    return params


def _host(tree):
    """A dict of tensors (nested one level for optimizer states) as numpy."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return tree


def _join(q1, q2):
    """The twin critics as one dict (optax's ``(q1, q2)`` tuple: Adam is
    per leaf, so the keys only name the leaves)."""
    return {**{"1/" + k: v for k, v in q1.items()},
            **{"2/" + k: v for k, v in q2.items()}}


def _split(qs):
    return ({k[2:]: v for k, v in qs.items() if k.startswith("1/")},
            {k[2:]: v for k, v in qs.items() if k.startswith("2/")})


class SACLearner:
    """Twin-Q + squashed-Gaussian-actor + α update."""

    def __init__(self, obs_size: int, action_dim: int, *,
                 hidden=(64, 64), actor_lr: float = 3e-4,
                 critic_lr: float = 3e-4, alpha_lr: float = 3e-4,
                 gamma: float = 0.99, tau: float = 0.005,
                 action_scale: float = 1.0, seed: int = 0,
                 target_entropy: float = None, device=None):
        import torch

        from ray_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self.gamma = gamma
        self.tau = tau
        self.action_dim = action_dim
        self.target_entropy = (-float(action_dim) if target_entropy is None
                               else target_entropy)
        dev = self.device
        self.actor = _tensors(init_continuous_policy_params(
            obs_size, action_dim, hidden=tuple(hidden), seed=seed,
            action_scale=action_scale), dev)
        self.q1 = _tensors(_init_q_params(obs_size, action_dim, hidden,
                                          seed + 1, "q"), dev)
        self.q2 = _tensors(_init_q_params(obs_size, action_dim, hidden,
                                          seed + 2, "q"), dev)
        self.q1_target = dict(self.q1)
        self.q2_target = dict(self.q2)
        self.log_alpha = torch.zeros((), dtype=torch.float32, device=dev)
        self._opt_actor = _Adam(actor_lr, None)
        self._opt_critic = _Adam(critic_lr, None)
        self._opt_alpha = _Adam(alpha_lr, None)
        # action_scale is a bound, not a weight: freeze it
        self._actor_opt_state = self._opt_actor.init(self._trainable(
            self.actor))
        self._critic_opt_state = self._opt_critic.init(_join(self.q1,
                                                             self.q2))
        self._alpha_opt_state = self._opt_alpha.init(
            {"log_alpha": self.log_alpha})
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(seed + 7)
        self._n_updates = 0

    @staticmethod
    def _trainable(actor):
        return {k: v for k, v in actor.items() if k != "action_scale"}

    @staticmethod
    def _q_forward(params, obs, act):
        import torch

        x = torch.cat([obs, act], dim=1)
        i = 0
        while f"q{i}_w" in params:
            x = torch.tanh(x @ params[f"q{i}_w"] + params[f"q{i}_b"])
            i += 1
        return (x @ params["qh_w"] + params["qh_b"])[:, 0]

    @staticmethod
    def _actor_dist(actor, obs):
        import torch

        x = obs
        i = 0
        while f"c{i}_w" in actor:
            x = torch.tanh(x @ actor[f"c{i}_w"] + actor[f"c{i}_b"])
            i += 1
        mu = x @ actor["mu_w"] + actor["mu_b"]
        logstd = torch.clamp(x @ actor["ls_w"] + actor["ls_b"],
                             LOGSTD_MIN, LOGSTD_MAX)
        return mu, logstd

    @classmethod
    def _sample_squashed(cls, actor, obs, eps):
        """Reparameterized tanh-Gaussian sample at the normal draw
        ``eps`` → (action, logp)."""
        import torch

        mu, logstd = cls._actor_dist(actor, obs)
        std = torch.exp(logstd)
        pre = mu + std * eps
        scale = actor["action_scale"]
        act = torch.tanh(pre) * scale
        logp = (-0.5 * (eps ** 2 + _LOG_2PI) - logstd
                - torch.log(scale * (1 - torch.tanh(pre) ** 2) + 1e-6)
                ).sum(dim=1)
        return act, logp

    # ------------------------------------------------------------ draws
    def draws(self, n: int) -> Dict[str, Any]:
        """The step's random draws for a batch of ``n``, from the
        learner's generator on its device."""
        import torch

        shape = (n, self.action_dim)
        return {k: torch.randn(shape, generator=self._gen,
                               device=self.device)
                for k in ("eps_next", "eps_pi")}

    def _conservative_penalty(self, qs, actor, batch, draws):
        """Critic-loss addend hook; CQLLearner overrides (sac stays 0)."""
        return None

    # ------------------------------------------------------------- step
    def step(self, batch, draws) -> Dict[str, Any]:
        """One update from a batch of tensors on the device and the
        step's draws; metrics stay tensors (no host sync)."""
        import torch

        gamma, tau, tgt_ent = self.gamma, self.tau, self.target_entropy
        qf, sample = self._q_forward, self._sample_squashed
        actor = self.actor
        alpha = torch.exp(self.log_alpha)

        # ---- critics: y = r + γ(1-d)(min Q'(s', a') - α logπ(a'|s'))
        with torch.no_grad():
            a_next, logp_next = sample(actor, batch["next_obs"],
                                       draws["eps_next"])
            q_next = torch.minimum(
                qf(self.q1_target, batch["next_obs"], a_next),
                qf(self.q2_target, batch["next_obs"], a_next))
            nonterm = 1.0 - batch["dones"].float()
            y = batch["rewards"] + gamma * nonterm * (
                q_next - alpha * logp_next)

        def critic_loss(qs):
            p1, p2 = _split(qs)
            l1 = ((qf(p1, batch["obs"], batch["actions"]) - y) ** 2).mean()
            l2 = ((qf(p2, batch["obs"], batch["actions"]) - y) ** 2).mean()
            pen = self._conservative_penalty((p1, p2), actor, batch, draws)
            total = l1 + l2 if pen is None else l1 + l2 + pen
            if pen is None:
                pen = torch.zeros((), device=l1.device)
            return total, {"l1": l1, "l2": l2, "pen": pen}

        qs = _join(self.q1, self.q2)
        closs, caux, cgrads = value_and_grad(critic_loss, qs)
        qs, self._critic_opt_state = self._opt_critic.update(
            cgrads, self._critic_opt_state, qs)
        q1, q2 = _split(qs)

        # ---- actor: max E[min Q(s, a~π) - α logπ]
        scale = actor["action_scale"]

        def actor_loss(a_train):
            a_full = dict(a_train, action_scale=scale)
            a_new, logp = sample(a_full, batch["obs"], draws["eps_pi"])
            q_new = torch.minimum(qf(q1, batch["obs"], a_new),
                                  qf(q2, batch["obs"], a_new))
            return (alpha * logp - q_new).mean(), {"logp": logp}

        a_train = self._trainable(actor)
        aloss, aaux, agrads = value_and_grad(actor_loss, a_train)
        a_train, self._actor_opt_state = self._opt_actor.update(
            agrads, self._actor_opt_state, a_train)
        logp_new = aaux["logp"]

        # ---- temperature: push E[logπ] toward -target_entropy
        def alpha_loss(p):
            return -(p["log_alpha"] * (logp_new + tgt_ent)).mean(), {}

        alloss, _, algrads = value_and_grad(
            alpha_loss, {"log_alpha": self.log_alpha})
        la, self._alpha_opt_state = self._opt_alpha.update(
            algrads, self._alpha_opt_state, {"log_alpha": self.log_alpha})

        # ---- polyak targets
        self.q1_target = {k: (1 - tau) * t + tau * q1[k]
                          for k, t in self.q1_target.items()}
        self.q2_target = {k: (1 - tau) * t + tau * q2[k]
                          for k, t in self.q2_target.items()}
        self.actor = dict(a_train, action_scale=scale)
        self.q1, self.q2 = q1, q2
        self.log_alpha = la["log_alpha"]
        self._n_updates += 1
        return {"critic_loss": closs, "q1_loss": caux["l1"],
                "q2_loss": caux["l2"], "actor_loss": aloss,
                "alpha_loss": alloss, "alpha": alpha,
                "cql_penalty": caux["pen"], "entropy": -logp_new.mean()}

    def update(self, batch: Dict[str, np.ndarray],
               draws: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
        """One update from a numpy batch; ``draws`` (arrays or tensors)
        defaults to :meth:`draws` from the learner's generator."""
        tb = _tensors(batch, self.device)
        tb["rewards"] = tb["rewards"].float()
        draws = (self.draws(len(batch["obs"])) if draws is None
                 else _tensors(draws, self.device))
        return {k: float(v) for k, v in self.step(tb, draws).items()}

    def get_weights(self) -> Dict[str, np.ndarray]:
        """Exploration-policy weights for env runners (actor only)."""
        return _host(self.actor)

    def set_weights(self, weights: Dict[str, np.ndarray]) -> None:
        self.actor = _tensors(dict(weights), self.device)

    def get_state(self) -> Dict[str, Any]:
        """FULL trainable state — critics, targets, α, optimizer states —
        for checkpointing (get_weights alone would resume the restored
        actor against fresh critics and destroy it within updates)."""
        return {"actor": _host(self.actor), "q1": _host(self.q1),
                "q2": _host(self.q2), "q1_target": _host(self.q1_target),
                "q2_target": _host(self.q2_target),
                "log_alpha": _host(self.log_alpha),
                "actor_opt": _host(self._actor_opt_state),
                "critic_opt": _host(self._critic_opt_state),
                "alpha_opt": _host(self._alpha_opt_state),
                "n_updates": self._n_updates}

    def set_state(self, state: Dict[str, Any]) -> None:
        import torch

        def dev(tree):
            if isinstance(tree, dict):
                return {k: dev(v) for k, v in tree.items()}
            if isinstance(tree, (int, float)):
                return tree
            return torch.as_tensor(np.array(tree), device=self.device)

        self.actor = dev(state["actor"])
        self.q1 = dev(state["q1"])
        self.q2 = dev(state["q2"])
        self.q1_target = dev(state["q1_target"])
        self.q2_target = dev(state["q2_target"])
        self.log_alpha = dev(state["log_alpha"])
        self._actor_opt_state = dev(state["actor_opt"])
        self._critic_opt_state = dev(state["critic_opt"])
        self._alpha_opt_state = dev(state["alpha_opt"])
        self._n_updates = state.get("n_updates", 0)


class SAC(Algorithm):
    def __init__(self, config: "SACConfig"):
        super().__init__(config)
        probe = self._env_probe
        if not probe.get("continuous"):
            raise ValueError("SAC requires a continuous-action env "
                             "(action_dim attribute)")
        self.learner = SACLearner(
            probe["obs_size"], probe["action_dim"],
            hidden=tuple(config.hidden), actor_lr=config.lr,
            critic_lr=config.critic_lr, alpha_lr=config.alpha_lr,
            gamma=config.gamma, tau=config.tau,
            action_scale=probe.get("action_scale", 1.0),
            seed=config.seed, device=config.learner_device)
        self.replay = ReplayBuffer(config.replay_capacity,
                                   seed=config.seed)
        self._env_steps = 0

    def get_weights(self):
        return self.learner.get_weights()

    def training_step(self) -> Dict[str, Any]:
        fragments = self._sample_fragments()
        if not fragments:
            raise RuntimeError("no healthy env runners produced samples")
        returns: List[float] = []
        new_steps = 0
        for f in fragments:
            self.replay.add_fragment(transitions_from_fragment(f))
            returns.extend(f["episode_returns"])
            new_steps += len(f["obs"])
        self._env_steps += new_steps

        metrics: Dict[str, float] = {}
        if len(self.replay) >= self.config.learning_starts:
            n_updates = max(1, int(new_steps
                                   * self.config.updates_per_env_step))
            for _ in range(n_updates):
                metrics = self.learner.update(
                    self.replay.sample(self.config.train_batch_size))
        self._weights_version += 1
        self._return_window = (self._return_window + returns)[-100:]
        return {
            "env_runners": {
                "episode_return_mean": self.episode_return_mean(),
                "num_episodes": len(returns),
                "num_env_steps_sampled": self._env_steps,
                "num_healthy_workers":
                    self.env_runner_group.num_healthy_actors(),
            },
            "learners": {"default_policy": metrics},
        }


@dataclasses.dataclass
class SACConfig(AlgorithmConfig):
    env: Any = "Pendulum-v1"
    lr: float = 3e-4                      # actor
    record_next_obs: bool = True   # off-policy TD needs true successors
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    tau: float = 0.005
    replay_capacity: int = 100_000
    train_batch_size: int = 256
    learning_starts: int = 1_000
    updates_per_env_step: float = 1.0
    rollout_fragment_length: int = 128
    algo_class = SAC
