"""Connector pipelines — composable observation/batch transforms (port of
``ray_tpu/rl/connectors.py``; numpy, as there).

Reference: ``rllib/connectors/connector_v2.py`` (ConnectorV2 pieces wired
into env runners and learners) — the idea: preprocessing lives in small,
stateful, checkpointable pieces owned by the pipeline, not hard-coded into
the env runner or the model.

Env-to-module connectors transform a raw observation before the policy
sees it (normalization, frame stacking); their state ships with weights
broadcasts so rollout and learner sides stay consistent.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np


class Connector:
    """One transform. Stateful connectors override get/set_state."""

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass

    def reset(self) -> None:
        """Called at episode boundaries (frame stacks flush, etc.)."""


class ConnectorPipeline(Connector):
    def __init__(self, connectors: Optional[List[Connector]] = None):
        self.connectors = list(connectors or [])

    def __call__(self, obs):
        for c in self.connectors:
            obs = c(obs)
        return obs

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def prepend(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.insert(0, connector)
        return self

    def insert_before(self, cls: type, connector: Connector):
        for i, c in enumerate(self.connectors):
            if isinstance(c, cls):
                self.connectors.insert(i, connector)
                return self
        raise ValueError(f"no connector of type {cls.__name__}")

    def reset(self):
        for c in self.connectors:
            c.reset()

    def get_state(self):
        return {i: c.get_state() for i, c in enumerate(self.connectors)}

    def set_state(self, state):
        for i, c in enumerate(self.connectors):
            if i in state:
                c.set_state(state[i])

    def output_size(self, obs_size: int) -> int:
        for c in self.connectors:
            obs_size = c.transformed_size(obs_size) \
                if hasattr(c, "transformed_size") else obs_size
        return obs_size


class Lambda(Connector):
    """Stateless functional transform."""

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray]):
        self._fn = fn

    def __call__(self, obs):
        return self._fn(obs)


class ObsNormalizer(Connector):
    """Running mean/std normalization (Welford). The running stats are
    part of the connector state: the algorithm broadcasts them with the
    weights so every env runner normalizes identically."""

    def __init__(self, eps: float = 1e-8, clip: float = 10.0,
                 update: bool = True):
        self.eps = eps
        self.clip = clip
        self.update = update
        self._count = 0.0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def __call__(self, obs):
        obs = np.asarray(obs, np.float64)
        if self._mean is None:
            self._mean = np.zeros_like(obs)
            self._m2 = np.ones_like(obs)
        if self.update:
            self._count += 1.0
            delta = obs - self._mean
            self._mean = self._mean + delta / self._count
            self._m2 = self._m2 + delta * (obs - self._mean)
        var = self._m2 / max(self._count, 1.0)
        out = (obs - self._mean) / np.sqrt(var + self.eps)
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def get_state(self):
        return {"count": self._count, "mean": self._mean, "m2": self._m2}

    def set_state(self, state):
        self._count = state["count"]
        self._mean = state["mean"]
        self._m2 = state["m2"]


class FrameStack(Connector):
    """Concatenate the last k observations (zero-padded at episode start)."""

    def __init__(self, k: int = 4):
        self.k = k
        self._frames: List[np.ndarray] = []

    def __call__(self, obs):
        obs = np.asarray(obs, np.float32)
        if not self._frames:
            self._frames = [np.zeros_like(obs) for _ in range(self.k)]
        self._frames = self._frames[1:] + [obs]
        return np.concatenate(self._frames, axis=-1)

    def reset(self):
        self._frames = []

    def transformed_size(self, obs_size: int) -> int:
        return obs_size * self.k


# ---------------------------------------------------------- module-to-env
class ModuleToEnvConnector(Connector):
    """Action-path transform: what the policy emitted → what the env
    steps on (reference: rllib module-to-env connector pipeline). Same
    state/checkpoint contract as the obs side."""

    def __call__(self, action):
        raise NotImplementedError


class ActionLambda(ModuleToEnvConnector):
    def __init__(self, fn: Callable[[Any], Any]):
        self._fn = fn

    def __call__(self, action):
        return self._fn(action)


class ActionRepeat(ModuleToEnvConnector):
    """Sticky actions: repeat the previous action with prob p (the
    standard Atari stochasticity knob; state = last action)."""

    def __init__(self, p: float = 0.25, seed: int = 0):
        self.p = p
        self._rng = np.random.default_rng(seed)
        self._last = None

    def __call__(self, action):
        if self._last is not None and self._rng.random() < self.p:
            return self._last
        self._last = action
        return action

    def reset(self):
        self._last = None

    def get_state(self):
        return {"last": self._last}

    def set_state(self, state):
        self._last = state.get("last")


# ------------------------------------------------------------ learner side
class LearnerConnector:
    """Batch-level transform applied just before the learner update
    (reference: rllib learner connector pipeline). Operates on the whole
    train-batch dict; stateful pieces are checkpointable like the env
    side."""

    def __call__(self, batch: Dict[str, np.ndarray]
                 ) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class LearnerConnectorPipeline(LearnerConnector):
    def __init__(self, connectors: Optional[List[LearnerConnector]] = None):
        self.connectors = list(connectors or [])

    def __call__(self, batch):
        for c in self.connectors:
            batch = c(batch)
        return batch

    def get_state(self):
        return {i: c.get_state() for i, c in enumerate(self.connectors)}

    def set_state(self, state):
        for i, c in enumerate(self.connectors):
            if i in state:
                c.set_state(state[i])


class BatchLambda(LearnerConnector):
    def __init__(self, fn: Callable[[Dict], Dict]):
        self._fn = fn

    def __call__(self, batch):
        return self._fn(batch)


class AdvantageStandardizer(LearnerConnector):
    """Zero-mean/unit-std advantages per train batch (the standard PPO
    stabilizer, expressed as a connector so it is composable/removable)."""

    def __init__(self, key: str = "advantages", eps: float = 1e-8):
        self.key = key
        self.eps = eps

    def __call__(self, batch):
        if self.key in batch:
            adv = batch[self.key]
            batch = dict(batch)
            batch[self.key] = (adv - adv.mean()) / (adv.std() + self.eps)
        return batch


class RewardClip(LearnerConnector):
    """Clip rewards into [lo, hi] at train time (DQN-style stabilization)."""

    def __init__(self, lo: float = -1.0, hi: float = 1.0,
                 key: str = "rewards"):
        self.lo, self.hi, self.key = lo, hi, key

    def __call__(self, batch):
        if self.key in batch:
            batch = dict(batch)
            batch[self.key] = np.clip(batch[self.key], self.lo, self.hi)
        return batch


# --------------------------------------------------------------- sequences
def window_sequences(batch: Dict[str, np.ndarray], seq_len: int
                     ) -> Dict[str, np.ndarray]:
    """Cut a time-major batch of fragments into fixed-length training
    windows for recurrent learners (reference: the AddStatesFromEpisodes
    learner-connector piece + RNNSequencing).

    Input columns are (F, T, ...) — F whole rollout fragments of T steps —
    except ``state_in_*`` columns, which are the PER-STEP recorded
    recurrent state (F, T, ...). Output: every non-state column becomes
    (B, L, ...) with B = F * (T // L); each ``state_in_*`` column is
    sliced AT WINDOW STARTS only → (B, ...), so the learner injects the
    exact carried state the policy acted with (burn-in-free) and replays
    mid-window resets from the ``is_first`` column. A trailing remainder
    of T % L steps is dropped."""
    F, T = next(iter(batch.values())).shape[:2]
    L = int(seq_len)
    W = T // L
    if W == 0:
        raise ValueError(f"seq_len {L} exceeds fragment length {T}")
    out: Dict[str, np.ndarray] = {}
    for k, v in batch.items():
        v = np.asarray(v)[:, :W * L]
        if k.startswith("state_in_"):
            out[k] = v[:, ::L].reshape((F * W,) + v.shape[2:])
        else:
            out[k] = v.reshape((F * W, L) + v.shape[2:])
    return out


class SequenceWindower(LearnerConnector):
    """``window_sequences`` as a composable learner-connector piece."""

    def __init__(self, seq_len: int = 16):
        self.seq_len = seq_len

    def __call__(self, batch):
        return window_sequences(batch, self.seq_len)
