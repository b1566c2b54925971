"""MARWIL: monotonic advantage re-weighted imitation learning (port of
``ray_tpu/rl/marwil.py``).

Reference: ``rllib/algorithms/marwil/marwil.py`` — offline learning that
interpolates between behavior cloning (beta=0) and advantage-filtered
imitation (beta>0): each logged action's log-likelihood is weighted by
``exp(beta * A(s, a) / c)`` where A comes from a value function trained
on the logged returns and ``c`` is a running advantage norm (the
reference's moving-average normalizer, ``marwil.py`` vf/beta losses).

The port: one update on the shared policy+value MLP (``rl/module.py`` —
the same net PPO uses, so the value head is free) on the learner's
device (None means CUDA); the running advantage norm stays a tensor on
that device, so an update holds no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ray_tpu_torch.rl.offline import JsonReader


def returns_to_go(rewards: np.ndarray, dones: np.ndarray,
                  gamma: float) -> np.ndarray:
    """Per-step discounted return to go, cut at episode boundaries;
    fragment tails bootstrap 0 (standard offline simplification)."""
    out = np.zeros_like(rewards, dtype=np.float32)
    acc = 0.0
    for t in range(len(rewards) - 1, -1, -1):
        if dones[t]:
            acc = 0.0
        acc = float(rewards[t]) + gamma * acc
        out[t] = acc
    return out


@dataclasses.dataclass
class MARWILConfig:
    input_path: str = ""
    beta: float = 1.0              # 0 = plain behavior cloning
    lr: float = 1e-3
    vf_coeff: float = 1.0
    gamma: float = 0.99
    num_epochs: int = 1
    minibatch_size: int = 256
    # running advantage normalizer momentum (reference moving-average)
    norm_momentum: float = 1e-2
    hidden: tuple = (64, 64)
    seed: int = 0
    env: Union[str, Any] = "CartPole-v1"  # only needed for evaluate()
    # the learner's device: None is CUDA, "cpu" the CPU
    learner_device: Optional[str] = None

    def build(self) -> "MARWIL":
        return MARWIL(self)


class MARWIL:
    def __init__(self, config: MARWILConfig):
        import torch

        from ray_tpu_torch import resolve_device
        from ray_tpu_torch.rl.learner import _Adam, _tensors
        from ray_tpu_torch.rl.module import init_policy_params

        self.config = config
        self.device = resolve_device(config.learner_device)
        obs_l: List[np.ndarray] = []
        act_l: List[np.ndarray] = []
        ret_l: List[np.ndarray] = []
        for frag in JsonReader(config.input_path):
            obs_l.append(np.asarray(frag["obs"], np.float32))
            act_l.append(np.asarray(frag["actions"], np.int32))
            ret_l.append(returns_to_go(
                np.asarray(frag["rewards"], np.float32),
                np.asarray(frag["dones"], np.bool_), config.gamma))
        self._obs = np.concatenate(obs_l)
        self._actions = np.concatenate(act_l)
        self._returns = np.concatenate(ret_l)
        self.params = _tensors(init_policy_params(
            self._obs.shape[-1], int(self._actions.max()) + 1,
            hidden=tuple(config.hidden), seed=config.seed), self.device)
        self._opt = _Adam(config.lr, None)
        self._opt_state = self._opt.init(self.params)
        # running E[A^2] — the advantage scale c in exp(beta * A / c).
        # Seeded from the return variance so the first minibatches don't
        # see exp(beta * A / 1) blow-ups while the average warms up.
        var0 = float(np.mean((self._returns - self._returns.mean()) ** 2))
        self._ms_adv = torch.tensor(np.float32(var0 if var0 > 0 else 1.0),
                                    device=self.device)
        self.iteration = 0
        self._rng = np.random.default_rng(config.seed)

    def _loss(self, params, obs, actions, rets, ms_adv):
        import torch

        from ray_tpu_torch.rl.module import torch_forward

        c = self.config
        beta, vf_c, mom = c.beta, c.vf_coeff, c.norm_momentum
        logits, value = torch_forward(params, obs)
        adv = rets - value
        vf_loss = (adv ** 2).mean()
        ms_new = (1 - mom) * ms_adv + mom * (adv.detach() ** 2).mean()
        scale = torch.sqrt(ms_new) + 1e-8
        w = torch.exp(torch.clamp(beta * adv.detach() / scale, -10.0, 10.0))
        logp = torch.log_softmax(logits, dim=-1)
        logp_a = logp.gather(1, actions[:, None].long())[:, 0]
        pi_loss = -(w * logp_a).mean()
        return pi_loss + vf_c * vf_loss, {"pi_loss": pi_loss,
                                          "vf_loss": vf_loss,
                                          "ms_new": ms_new}

    def step(self, obs, actions, rets):
        """One update from device tensors: (loss, pi_loss, vf_loss) as
        tensors; the advantage norm advances on the device."""
        from ray_tpu_torch.rl.learner import value_and_grad

        loss, aux, grads = value_and_grad(self._loss, self.params, obs,
                                          actions, rets, self._ms_adv)
        self.params, self._opt_state = self._opt.update(
            grads, self._opt_state, self.params)
        self._ms_adv = aux["ms_new"]
        return loss, aux["pi_loss"], aux["vf_loss"]

    def train(self) -> Dict[str, Any]:
        from ray_tpu_torch.rl.learner import _tensor

        self.iteration += 1
        n = len(self._obs)
        mb = min(self.config.minibatch_size, n)
        out = []
        for _ in range(self.config.num_epochs):
            order = self._rng.permutation(n)
            for i in range(0, n - mb + 1, mb):
                idx = order[i:i + mb]
                out.append(self.step(
                    *(_tensor(a[idx], self.device) for a in (
                        self._obs, self._actions, self._returns))))
        tot, pi, vf = ([float(v[i]) for v in out] for i in range(3))
        return {"training_iteration": self.iteration,
                "total_loss": float(np.mean(tot)),
                "policy_loss": float(np.mean(pi)),
                "vf_loss": float(np.mean(vf)),
                "advantage_norm": float(np.sqrt(float(self._ms_adv)))}

    def action_probs(self, obs: np.ndarray) -> np.ndarray:
        from ray_tpu_torch.rl.module import np_forward
        from ray_tpu_torch.rl.offline import torch_to_np

        logits, _ = np_forward(torch_to_np(self.params),
                               np.asarray(obs, np.float32))
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    def evaluate(self, num_episodes: int = 5,
                 seed: int = 100) -> Dict[str, float]:
        from ray_tpu_torch.rl.envs import make_env
        from ray_tpu_torch.rl.module import np_forward
        from ray_tpu_torch.rl.offline import torch_to_np

        env = make_env(self.config.env, seed=seed)
        params = torch_to_np(self.params)
        returns = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=seed + ep)
            total, done = 0.0, False
            while not done:
                logits, _ = np_forward(params, np.asarray(obs)[None])
                obs, r, term, trunc, _ = env.step(int(logits[0].argmax()))
                total += r
                done = term or trunc
            returns.append(total)
        return {"episode_return_mean": float(np.mean(returns))}
