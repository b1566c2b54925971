"""Built-in environments (port of ``ray_tpu/rl/envs.py``; gymnasium API
shape: reset → (obs, info), step → (obs, reward, terminated, truncated,
info)).

The reference depends on external gym; this image has none, and rollout
workers shouldn't need an accelerator runtime anyway — these are pure
numpy. ``make_env`` also accepts any user callable returning an object
with the same API, so external gymnasium envs plug straight in.

The JAX package's in-graph envs for Anakin (``JaxCartPole``,
``register_jax_env``, ``get_jax_env``) come with Podracer in a later
slice and refuse until then (``WAITING["rl_anakin"]``), as does the
multi-agent coordination game.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np

from ray_tpu_torch.common.status import not_ported


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


def register_jax_env(name: str, env_cls: Any) -> None:
    """Anakin's in-graph env registry: refuses until Podracer is
    ported."""
    raise not_ported("rl_anakin")


def get_jax_env(spec: Union[str, Any]):
    """Anakin's in-graph env lookup: refuses until Podracer is ported."""
    raise not_ported("rl_anakin")


def __getattr__(name):
    if name == "JaxCartPole":
        raise not_ported("rl_anakin")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _coordination_factory(seed=None):
    raise not_ported("rl_later")  # rl/multi_agent.py's coordination game


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
