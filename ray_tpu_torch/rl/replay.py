"""Replay utilities shared by the off-policy algorithms (DQN, SAC) and
the sequence learners (DreamerV3, recurrent policies) (port of
``ray_tpu/rl/replay.py``: numpy on the host, copied as it is, so a buffer
of the same seed samples the same indices in both packages).

Reference: ``rllib/utils/replay_buffers/`` (buffer), the
episode-to-transition conversion the reference does in its off-policy
learner connector pipelines, and DreamerV3's episodic sequence replay.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


def transitions_from_fragment(frag: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Rollout fragment → replayable transitions for off-policy TD.

    Runners record the TRUE successor state per step (``next_obs``,
    pre-reset at episode boundaries) and a ``terminated`` flag distinct
    from time-limit truncation — so the TD target bootstraps through
    truncations from the real final state (gym distinction the reference
    preserves; a truncated Pendulum episode still has future cost) and is
    cut only at genuine terminations. Fallback for externally produced
    fragments without those keys: shift obs for next_obs and drop the
    fragment's (next-obs-less) tail — never fabricate a self-transition."""
    obs = np.asarray(frag["obs"])
    if "next_obs" in frag:
        dones = np.asarray(frag.get("terminated", frag["dones"]),
                           dtype=np.float32)
        return {"obs": obs,
                "actions": np.asarray(frag["actions"]),
                "rewards": np.asarray(frag["rewards"], dtype=np.float32),
                "next_obs": np.asarray(frag["next_obs"]),
                "dones": dones}
    dones = np.asarray(frag["dones"], dtype=np.float32)
    return {"obs": obs[:-1],
            "actions": np.asarray(frag["actions"])[:-1],
            "rewards": np.asarray(frag["rewards"], dtype=np.float32)[:-1],
            "next_obs": obs[1:],
            "dones": dones[:-1]}


class ReplayBuffer:
    """Uniform ring replay of transitions (numpy, host-side).
    Reference: ``rllib/utils/replay_buffers/``."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._rng = np.random.default_rng(seed)
        self._storage: Dict[str, np.ndarray] = {}
        self._next = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def add_fragment(self, frag: Dict[str, np.ndarray]) -> None:
        """Append a rollout fragment of transitions (obs, actions,
        rewards, next_obs, dones)."""
        n = len(frag["obs"])
        if not self._storage:
            for k in ("obs", "actions", "rewards", "next_obs", "dones"):
                v = np.asarray(frag[k])
                self._storage[k] = np.zeros((self.capacity,) + v.shape[1:],
                                            dtype=v.dtype)
        for k, buf in self._storage.items():
            v = np.asarray(frag[k])
            idx = (self._next + np.arange(n)) % self.capacity
            buf[idx] = v
        self._next = (self._next + n) % self.capacity
        self._size = min(self.capacity, self._size + n)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        return {k: buf[idx] for k, buf in self._storage.items()}


class SequenceReplay:
    """Fragment-preserving replay sampling (B, L) windows with is_first
    markers (reference: DreamerV3's episodic replay).

    Stateful-module support (rl/module.py contract): fragments produced
    by env runners carry per-step ``state_in`` columns (the recurrent
    state the policy actually acted with) and true ``is_first`` flags.
    Both are stored, and :meth:`sample` ships each window's recorded
    state AT THE WINDOW START as flat ``state_in_<k>`` columns — the
    learner injects it into its scan instead of burning in from zeros,
    and mid-window resets replay from the flags. Fragments without
    recorded state (externally produced) still work: no state columns
    are emitted and learners fall back to zero initial state."""

    _BASE = ("obs", "actions", "rewards", "terminated", "is_first")

    def __init__(self, capacity_steps: int, seq_len: int, seed: int = 0):
        self._frags: List[Dict[str, np.ndarray]] = []
        self._steps = 0
        self._cap = capacity_steps
        self._L = seq_len
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return self._steps

    def add_fragment(self, frag: Dict[str, Any]) -> None:
        n = len(frag["obs"])
        if n < 2:
            return
        keep = {
            "obs": np.asarray(frag["obs"], np.float32),
            "actions": np.asarray(frag["actions"]),
            "rewards": np.asarray(frag["rewards"], np.float32),
            "terminated": np.asarray(
                frag.get("terminated", frag["dones"]), np.float32),
        }
        if "is_first" in frag:
            # runner-recorded flags: a fragment starting mid-episode stays
            # False at index 0, so windows resume from the injected state
            # instead of fabricating an episode boundary
            keep["is_first"] = np.asarray(frag["is_first"], bool).copy()
        else:
            # episode starts inside the fragment: step AFTER a done
            dones = np.asarray(frag["dones"], bool)
            keep["is_first"] = np.zeros(n, bool)
            keep["is_first"][0] = True
            keep["is_first"][1:] |= dones[:-1]
        for k, v in (frag.get("state_in") or {}).items():
            keep["state_in_" + k] = np.asarray(v, np.float32)
        self._frags.append(keep)
        self._steps += n
        while self._steps - len(self._frags[0]["obs"]) >= self._cap \
                and len(self._frags) > 1:
            self._steps -= len(self._frags.pop(0)["obs"])

    def _state_keys(self) -> List[str]:
        """State columns present in EVERY stored fragment (mixed buffers
        would otherwise produce ragged batches)."""
        if not self._frags:
            return []
        return [k for k in self._frags[0]
                if k.startswith("state_in_")
                and all(k in f for f in self._frags)]

    def sample(self, batch: int) -> Dict[str, np.ndarray]:
        L = self._L
        state_keys = self._state_keys()
        cols: Dict[str, List[np.ndarray]] = {
            k: [] for k in self._BASE + tuple(state_keys)}
        sizes = np.array([len(f["obs"]) for f in self._frags])
        ok = np.flatnonzero(sizes >= L)
        probs = sizes[ok] / sizes[ok].sum()
        for _ in range(batch):
            f = self._frags[ok[self._rng.choice(len(ok), p=probs)]]
            n = len(f["obs"])
            s = int(self._rng.integers(0, n - L + 1))
            for k in self._BASE:
                cols[k].append(f[k][s:s + L])
            for k in state_keys:      # flat state at the window start
                cols[k].append(f[k][s])
        return {k: np.stack(v) for k, v in cols.items()}

    def has_sequences(self, batch: int) -> bool:
        return any(len(f["obs"]) >= self._L for f in self._frags) \
            and self._steps >= batch * self._L
