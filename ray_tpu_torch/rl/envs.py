"""Built-in environments (port of ``ray_tpu/rl/envs.py``; gymnasium API
shape: reset → (obs, info), step → (obs, reward, terminated, truncated,
info)).

The reference depends on external gym; this image has none, and rollout
workers shouldn't need an accelerator runtime anyway — these are pure
numpy. ``make_env`` also accepts any user callable returning an object
with the same API, so external gymnasium envs plug straight in.

Anakin's in-device env is :class:`TorchCartPole` (exported under the JAX
package's name ``JaxCartPole`` too): the same CartPole as batched tensor
functions on the learner's device, registered for Anakin with
``register_jax_env`` and found with ``get_jax_env``. ``make_env`` also
builds the multi-agent coordination game (``rl/multi_agent.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np


class CartPoleEnv:
    """Classic cart-pole (dynamics per Barto-Sutton-Anderson / gym
    CartPole-v1: termination at |x|>2.4, |θ|>12°, truncation at 500)."""

    observation_size = 4
    num_actions = 2
    max_episode_steps = 500

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE = 10.0
    DT = 0.02
    X_LIMIT = 2.4
    THETA_LIMIT = 12 * np.pi / 180

    def __init__(self, seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros(4)
        self._steps = 0

    def reset(self, seed: Optional[int] = None) -> Tuple[np.ndarray, Dict]:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._steps = 0
        return self._state.astype(np.float32).copy(), {}

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE if action == 1 else -self.FORCE
        total_mass = self.CART_MASS + self.POLE_MASS
        pole_ml = self.POLE_MASS * self.POLE_HALF_LEN
        cos_t, sin_t = np.cos(theta), np.sin(theta)
        temp = (force + pole_ml * theta_dot**2 * sin_t) / total_mass
        theta_acc = (self.GRAVITY * sin_t - cos_t * temp) / (
            self.POLE_HALF_LEN
            * (4.0 / 3.0 - self.POLE_MASS * cos_t**2 / total_mass))
        x_acc = temp - pole_ml * theta_acc * cos_t / total_mass
        self._state = np.array([
            x + self.DT * x_dot,
            x_dot + self.DT * x_acc,
            theta + self.DT * theta_dot,
            theta_dot + self.DT * theta_acc,
        ])
        self._steps += 1
        terminated = bool(abs(self._state[0]) > self.X_LIMIT
                          or abs(self._state[2]) > self.THETA_LIMIT)
        truncated = self._steps >= self.max_episode_steps
        return (self._state.astype(np.float32).copy(), 1.0, terminated,
                truncated, {})


class CartPoleMaskedVelocityEnv(CartPoleEnv):
    """CartPole POMDP: observations expose only the POSITIONS (x, θ) —
    velocities are masked. The standard memory benchmark for recurrent
    policies (Duan et al. '16 "masked-velocity" control suite): a
    feedforward policy cannot distinguish a pole swinging left from one
    swinging right through the upright, so it cannot stabilize; a
    stateful policy recovers the velocities from two consecutive
    observations. Initial VELOCITIES are drawn wider than stock CartPole
    so the hidden state genuinely varies and cannot be assumed zero."""

    observation_size = 2

    def _mask(self, obs: np.ndarray) -> np.ndarray:
        return obs[[0, 2]]

    def reset(self, seed: Optional[int] = None) -> Tuple[np.ndarray, Dict]:
        obs, info = super().reset(seed=seed)
        # re-draw velocities from a wider range (positions stay stock)
        self._state[1] = self._rng.uniform(-0.5, 0.5)
        self._state[3] = self._rng.uniform(-0.5, 0.5)
        return self._mask(self._state.astype(np.float32)), info

    def step(self, action: int):
        obs, reward, terminated, truncated, info = super().step(action)
        return self._mask(obs), reward, terminated, truncated, info


class PendulumEnv:
    """Classic underactuated pendulum swing-up (gym Pendulum-v1
    dynamics): obs (cosθ, sinθ, θ̇), one continuous torque in
    [-2, 2], reward -(θ² + 0.1·θ̇² + 0.001·a²), 200-step episodes.
    The stock continuous-control testbed for SAC-class algorithms
    (reference: rllib/tuned_examples/sac/pendulum_sac.py)."""

    observation_size = 3
    action_dim = 1                    # continuous: no num_actions
    action_low = -2.0
    action_high = 2.0
    max_episode_steps = 200

    GRAVITY = 10.0
    MASS = 1.0
    LENGTH = 1.0
    DT = 0.05
    MAX_SPEED = 8.0

    def __init__(self, seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed)
        self._theta = 0.0
        self._theta_dot = 0.0
        self._steps = 0

    def _obs(self) -> np.ndarray:
        return np.array([np.cos(self._theta), np.sin(self._theta),
                         self._theta_dot], np.float32)

    def reset(self, seed: Optional[int] = None) -> Tuple[np.ndarray, Dict]:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._theta = self._rng.uniform(-np.pi, np.pi)
        self._theta_dot = self._rng.uniform(-1.0, 1.0)
        self._steps = 0
        return self._obs(), {}

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          self.action_low, self.action_high))
        th, thdot = self._theta, self._theta_dot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = thdot + self.DT * (
            3 * self.GRAVITY / (2 * self.LENGTH) * np.sin(th)
            + 3.0 / (self.MASS * self.LENGTH ** 2) * u)
        thdot = float(np.clip(thdot, -self.MAX_SPEED, self.MAX_SPEED))
        th = th + self.DT * thdot
        self._theta, self._theta_dot = th, thdot
        self._steps += 1
        truncated = self._steps >= self.max_episode_steps
        return self._obs(), -float(cost), False, truncated, {}


def _uniform(draw, shape):
    """The reset distribution U(-0.05, 0.05) over ``shape``: drawn from
    ``draw`` when it is a ``torch.Generator`` (on its device), else
    ``draw`` itself, values already drawn (a tensor of ``shape``)."""
    import torch

    if isinstance(draw, torch.Generator):
        u = torch.rand(shape, generator=draw, device=draw.device)
        return u * 0.1 - 0.05
    if tuple(draw.shape) != tuple(shape):
        raise ValueError(f"uniforms of shape {tuple(draw.shape)}, want "
                         f"{tuple(shape)}")
    return draw.float()


class TorchCartPole:
    """Functional, batched CartPole on device tensors for in-device
    (Anakin) training: ``reset``/``step`` are pure functions over a state
    dict of tensors, with no host sync, so a whole unroll stays on the
    card (the JAX package's ``JaxCartPole``, ``ray_tpu/rl/envs.py``,
    whose functions run under ``jax.jit``/``lax.scan``). Dynamics,
    termination bounds and the reset distribution are
    :class:`CartPoleEnv`'s; ``step`` auto-resets done envs in place (the
    returned obs is the NEXT policy input, so a fresh episode starts
    without leaving the device). Where the JAX env takes a PRNG key, this
    one takes a ``torch.Generator`` or the uniforms themselves (values
    in [-0.05, 0.05) of the reset's shape). torch is imported inside the
    functions: this module stays importable in numpy-only runners."""

    observation_size = 4
    num_actions = 2
    max_episode_steps = 500

    @staticmethod
    def reset(draw, batch_size: int):
        """-> (state, obs): state {"s": (B, 4), "steps": (B,) int32}."""
        import torch

        s = _uniform(draw, (batch_size, 4))
        return ({"s": s, "steps": torch.zeros(batch_size, dtype=torch.int32,
                                              device=s.device)},
                s.float())

    @staticmethod
    def physics(s, action):
        """One Euler step of the cart-pole dynamics, batched: ``s``
        (B, 4), ``action`` (B,) in {0, 1} -> next (B, 4).  Same
        equations, same constants as ``CartPoleEnv.step``."""
        import torch

        E = CartPoleEnv
        x, x_dot, theta, theta_dot = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
        force = torch.where(action == 1, E.FORCE, -E.FORCE).to(s.dtype)
        total_mass = E.CART_MASS + E.POLE_MASS
        pole_ml = E.POLE_MASS * E.POLE_HALF_LEN
        cos_t, sin_t = torch.cos(theta), torch.sin(theta)
        temp = (force + pole_ml * theta_dot**2 * sin_t) / total_mass
        theta_acc = (E.GRAVITY * sin_t - cos_t * temp) / (
            E.POLE_HALF_LEN
            * (4.0 / 3.0 - E.POLE_MASS * cos_t**2 / total_mass))
        x_acc = temp - pole_ml * theta_acc * cos_t / total_mass
        return torch.stack([
            x + E.DT * x_dot,
            x_dot + E.DT * x_acc,
            theta + E.DT * theta_dot,
            theta_dot + E.DT * theta_acc,
        ], dim=1)

    @staticmethod
    def step(state, action, draw):
        """-> (state', obs, reward, done); done envs are re-drawn from
        the reset distribution in place (their obs is the new episode's
        first observation)."""
        import torch

        E = CartPoleEnv
        s2 = TorchCartPole.physics(state["s"], action)
        steps = state["steps"] + 1
        terminated = ((s2[:, 0].abs() > E.X_LIMIT)
                      | (s2[:, 2].abs() > E.THETA_LIMIT))
        truncated = steps >= TorchCartPole.max_episode_steps
        done = terminated | truncated
        fresh = _uniform(draw, tuple(s2.shape))
        s_next = torch.where(done[:, None], fresh, s2)
        steps = torch.where(done, torch.zeros_like(steps), steps)
        reward = torch.ones(s2.shape[0], dtype=torch.float32,
                            device=s2.device)
        return ({"s": s_next, "steps": steps}, s_next.float(), reward,
                done)


JaxCartPole = TorchCartPole  # the JAX package's name

_JAX_REGISTRY: Dict[str, Any] = {
    "CartPole-v1": TorchCartPole,
}


def register_jax_env(name: str, env_cls: Any) -> None:
    """Register a functional in-device env (TorchCartPole-shaped
    ``reset(draw, batch)`` / ``step(state, action, draw)``) for
    Anakin."""
    _JAX_REGISTRY[name] = env_cls


def get_jax_env(spec: Union[str, Any]):
    """Resolve an Anakin in-device env: registered name, or any object
    already exposing the functional reset/step surface."""
    if isinstance(spec, str):
        if spec not in _JAX_REGISTRY:
            raise KeyError(
                f"no in-device env registered for {spec!r}; register one "
                "with register_jax_env() or use Sebulba mode. Known: "
                f"{sorted(_JAX_REGISTRY)}")
        return _JAX_REGISTRY[spec]
    if hasattr(spec, "reset") and hasattr(spec, "step"):
        return spec
    raise TypeError(f"{spec!r} is not an in-device env")


def _coordination_factory(seed=None):
    from ray_tpu_torch.rl.multi_agent import CoordinationGameEnv

    return CoordinationGameEnv(seed=seed)


_REGISTRY: Dict[str, Callable[..., Any]] = {
    "CartPole-v1": CartPoleEnv,
    "CartPoleMaskedVelocity-v1": CartPoleMaskedVelocityEnv,
    "Pendulum-v1": PendulumEnv,
    "coordination": _coordination_factory,
}


def register_env(name: str, factory: Callable[..., Any]) -> None:
    _REGISTRY[name] = factory


def make_env(spec: Union[str, Callable[..., Any]], seed: Optional[int] = None):
    factory = _REGISTRY[spec] if isinstance(spec, str) else spec
    try:
        return factory(seed=seed)
    except TypeError:
        return factory()
