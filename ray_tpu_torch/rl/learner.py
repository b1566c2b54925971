"""Learner: the PPO SGD step in torch (port of ``ray_tpu/rl/learner.py``;
reference ``rllib/core/learner/learner.py:107``).

The learner holds the policy's parameters as f32 tensors on its device
(None means CUDA, and raises without it; ``device="cpu"`` asks for the
CPU). The optimizer is an own copy of the JAX package's optax chain
``chain(clip_by_global_norm(grad_clip), adam(lr))`` (optax 0.2.6):

- the global norm is taken over every leaf, and the gradients are left as
  they are below ``grad_clip``, else scaled by ``grad_clip / norm``;
- Adam's moments are ``(1 - b) g + b m`` and ``(1 - b2) g² + b2 v``, bias
  corrected with the step count t (from 1), and the update is
  ``-lr · m̂ / (sqrt(v̂) + eps)``, eps 1e-8 outside the square root.

Multi-learner groups allreduce between :meth:`PPOLearner.compute_gradients`
and :meth:`PPOLearner.apply_gradients` through the collective library
(``rl/learner_group.py``).

Stateful modules: when the param dict carries a recurrent family marker
(rl/module.py), PPO batches arrive as (B, L) sequence windows with
injected window-start state (``state_in_*``) and ``is_first`` flags; the
window unrolls in one loop over L (:func:`torch_lstm_forward_seq`) and the
clipped-surrogate loss is taken over the flattened (B·L) steps.
Minibatching permutes WHOLE windows so state injection stays aligned with
its window; the permutation comes from a numpy generator of ``seed``, so
the JAX package's learner of the same seed sees the same minibatches.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch.rl.module import torch_forward, torch_lstm_forward_seq


class _Adam:
    """optax's ``chain(clip_by_global_norm(max_norm), adam(lr))`` over a
    dict of tensors (its leaves in sorted key order, as ``jax.tree``
    flattens a dict); ``max_norm=None`` is optax's plain ``adam(lr)``."""

    def __init__(self, lr: float, max_norm: Optional[float],
                 b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.max_norm = lr, max_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        import torch

        return {"count": 0,
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(self, grads, state, params):
        """New params (a new dict) and state after one step."""
        import torch

        keys = sorted(params)
        if self.max_norm is not None:
            g_norm = torch.sqrt(sum(grads[k].square().sum() for k in keys))
            clip = g_norm >= self.max_norm
        count = state["count"] + 1
        # the bias corrections in f32 on the host: a host scalar moved to
        # the device would synchronize the step
        bc1 = float(np.float32(1) - np.float32(self.b1) ** count)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** count)
        new, mu, nu = {}, {}, {}
        for k in keys:
            g = grads[k]
            if self.max_norm is not None:
                g = torch.where(clip, g / g_norm.to(g.dtype) * self.max_norm,
                                g)
            mu[k] = (1 - self.b1) * g + self.b1 * state["mu"][k]
            nu[k] = (1 - self.b2) * g.square() + self.b2 * state["nu"][k]
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
            new[k] = params[k] + (-self.lr) * u
        return new, {"count": count, "mu": mu, "nu": nu}


def value_and_grad(loss_fn: Callable, params, *args):
    """``(loss, aux, grads)`` of ``loss_fn(params, *args) -> (loss, aux)``
    at ``params`` (a dict of tensors), as ``jax.value_and_grad(...,
    has_aux=True)`` gives them (zeros for a leaf the loss does not use);
    loss and aux come back detached."""
    import torch

    keys = sorted(params)
    leaves = [params[k].detach().requires_grad_() for k in keys]
    with torch.enable_grad():
        loss, aux = loss_fn(dict(zip(keys, leaves)), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            dict(zip(keys, grads)))


def _tensor(value, device):
    """``value`` (a tensor, or an array: copied, since arrays from the
    object store are read-only) on ``device``."""
    import torch

    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.array(value))
    return value.to(device)


def _tensors(batch, device):
    return {k: _tensor(v, device) for k, v in batch.items()}


class PPOLearner:
    """Clipped-surrogate PPO update (reference ``rllib/algorithms/ppo/``)."""

    def __init__(self, params: Dict[str, np.ndarray], *,
                 lr: float = 3e-4, clip: float = 0.2, vf_coeff: float = 0.5,
                 entropy_coeff: float = 0.01, num_epochs: int = 4,
                 minibatch_size: int = 128, grad_clip: float = 0.5,
                 seed: int = 0, device=None):
        from ray_tpu_torch import resolve_device

        self.clip = clip
        self.vf_coeff = vf_coeff
        self.entropy_coeff = entropy_coeff
        self.num_epochs = num_epochs
        self.minibatch_size = minibatch_size
        self._rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self._optimizer = _Adam(lr, grad_clip)
        self.set_weights(params)
        self._opt_state = self._optimizer.init(self._params)

    # ---------------------------------------------------------------- loss
    def _loss(self, params, batch):
        import torch

        clip = self.clip
        if "lstm_wx" in params:
            # sequence window batch: (B, L, ...) + window-start state; one
            # loop over L, then the standard surrogate on the flat steps
            state = {k[len("state_in_"):]: v for k, v in batch.items()
                     if k.startswith("state_in_")}
            logits, values = torch_lstm_forward_seq(
                params, batch["obs"], state, batch["is_first"])
            logits = logits.reshape(-1, logits.shape[-1])
            values = values.reshape(-1)
            actions = batch["actions"].reshape(-1)
            logp_old = batch["logp_old"].reshape(-1)
            adv = batch["advantages"].reshape(-1)
            value_targets = batch["value_targets"].reshape(-1)
        else:
            logits, values = torch_forward(params, batch["obs"])
            actions = batch["actions"]
            logp_old = batch["logp_old"]
            adv = batch["advantages"]
            value_targets = batch["value_targets"]
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, actions[:, None].long())[:, 0]
        ratio = torch.exp(logp - logp_old)
        surr = torch.minimum(ratio * adv,
                             torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
        pi_loss = -surr.mean()
        vf_loss = ((values - value_targets) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(dim=1).mean()
        total = (pi_loss + self.vf_coeff * vf_loss
                 - self.entropy_coeff * entropy)
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy,
                       "clip_frac": ((ratio - 1.0).abs() > clip).float()
                       .mean()}

    def _grads(self, batch):
        """(grads dict, aux dict with total_loss) at the current params."""
        total, aux, grads = value_and_grad(self._loss, self._params, batch)
        aux["total_loss"] = total
        return grads, aux

    def _apply(self, grads):
        self._params, self._opt_state = self._optimizer.update(
            grads, self._opt_state, self._params)

    # ------------------------------------------------------------- update
    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Minibatched multi-epoch PPO update. Batch keys: obs, actions,
        logp_old, advantages, value_targets — flat (N, ...) for
        feedforward modules, (B, L, ...) windows + state_in_*/is_first
        for stateful ones (minibatches then index whole windows, and
        minibatch_size counts STEPS, so B·L per minibatch stays
        comparable across module families)."""
        from ray_tpu_torch.rl.module import get_initial_state, is_stateful

        n = len(batch["obs"])
        mb_size = self.minibatch_size
        if is_stateful(self._params):
            if "lstm_wx" not in self._params:
                raise ValueError(
                    "PPOLearner supports the LSTM stateful family only; "
                    "RSSM acting towers are inference-only exports "
                    "(trained by DreamerV3Learner), not PPO-trainable")
            obs = np.asarray(batch["obs"])
            if obs.ndim != 3:
                raise ValueError(
                    "stateful module requires a (B, L, obs) sequence "
                    f"batch (see window_sequences); got shape {obs.shape}")
            # zero-state fallback for externally built windows without
            # recorded acting state
            batch = dict(batch)
            if "is_first" not in batch:
                first = np.zeros(obs.shape[:2], bool)
                first[:, 0] = True
                batch["is_first"] = first
            for k, v in get_initial_state(self._params, n).items():
                batch.setdefault("state_in_" + k, np.asarray(v))
            mb_size = max(1, self.minibatch_size // obs.shape[1])
        metrics = {}
        for _ in range(self.num_epochs):
            perm = self._rng.permutation(n)
            for lo in range(0, n, mb_size):
                idx = perm[lo:lo + mb_size]
                mb = _tensors({k: np.asarray(v)[idx]
                               for k, v in batch.items()}, self.device)
                grads, aux = self._grads(mb)
                self._apply(grads)
            metrics = {k: float(v) for k, v in aux.items()}
        return metrics

    # --------------------------------------------- multi-learner grad split
    def compute_gradients(self, batch: Dict[str, np.ndarray]):
        """Gradients on this shard WITHOUT applying them; pair with
        :meth:`apply_gradients` around an allreduce (LearnerGroup)."""
        return self._grads(_tensors(
            {k: v for k, v in batch.items() if k != "episode_returns"},
            self.device))

    def apply_gradients(self, grads) -> None:
        """One optimizer step from ``grads`` (a dict of tensors or numpy
        arrays keyed as the parameters)."""
        self._apply(_tensors(grads, self.device))
        self.updates = getattr(self, "updates", 0) + 1

    def get_weights(self) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() for k, v in self._params.items()}

    def set_weights(self, params: Dict[str, np.ndarray]):
        self._params = _tensors(dict(params), self.device)


def build_ppo_batch(fragments, *, gamma: float = 0.99, lam: float = 0.95,
                    seq_len: int = None):
    """Assemble the PPO train batch from rollout fragments: per-fragment
    GAE, column stacking ((F, T, ...) + ``window_sequences`` for
    stateful modules, flat concatenation otherwise), and advantage
    normalization.

    Returns ``(batch, episode_returns, env_steps)``.
    """
    advs, targets, returns = [], [], []
    for f in fragments:
        a, vt = compute_gae(
            f["rewards"], f["values"], f["dones"], f["last_value"],
            gamma=gamma, lam=lam)
        advs.append(a)
        targets.append(vt)
        returns.extend(f["episode_returns"])
    stateful = "state_in" in fragments[0]
    if stateful:
        # keep time structure: (F, T, ...) columns, GAE per fragment as
        # above, then cut into (B, L) windows with the recorded state at
        # window starts (burn-in-free injection)
        batch = {
            "obs": np.stack([f["obs"] for f in fragments]),
            "actions": np.stack([f["actions"] for f in fragments]),
            "logp_old": np.stack([f["logp"] for f in fragments]),
            "advantages": np.stack(advs),
            "value_targets": np.stack(targets),
            "is_first": np.stack([f["is_first"] for f in fragments]),
        }
        for k in fragments[0]["state_in"]:
            batch["state_in_" + k] = np.stack(
                [f["state_in"][k] for f in fragments])
    else:
        batch = {
            "obs": np.concatenate([f["obs"] for f in fragments]),
            "actions": np.concatenate([f["actions"] for f in fragments]),
            "logp_old": np.concatenate([f["logp"] for f in fragments]),
            "advantages": np.concatenate(advs),
            "value_targets": np.concatenate(targets),
        }
    adv = batch["advantages"]
    batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
    if stateful:
        from ray_tpu_torch.rl.connectors import window_sequences

        if seq_len is None:
            raise ValueError("stateful fragments need seq_len")
        batch = window_sequences(batch, seq_len)
    env_steps = sum(len(f["obs"]) for f in fragments)
    return batch, returns, env_steps


def compute_gae(rewards, values, dones, last_value, *,
                gamma: float = 0.99, lam: float = 0.95
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Generalized advantage estimation over a rollout fragment."""
    T = len(rewards)
    adv = np.zeros(T, np.float32)
    next_value = last_value
    gae = 0.0
    # dones[t] == episode ended AT step t → no bootstrap/propagation across
    # the t → t+1 boundary.
    for t in range(T - 1, -1, -1):
        nonterminal = 0.0 if dones[t] else 1.0
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        gae = delta + gamma * lam * nonterminal * gae
        adv[t] = gae
        next_value = values[t]
    value_targets = adv + values
    return adv, value_targets
