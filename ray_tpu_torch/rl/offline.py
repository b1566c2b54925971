"""Offline RL: experience datasets on disk + behavior cloning (port of
``ray_tpu/rl/offline.py``).

Reference: ``rllib/offline/`` (JsonWriter/JsonReader sample IO,
``rllib/algorithms/bc/bc.py`` behavior cloning on logged actions). The
JSON lines are the JAX package's, byte for byte, so a file written by
either package reads the same in the other. ``to_dataset`` bridges into
``ray_tpu_torch.data``, one row per transition.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np


class JsonWriter:
    """Append rollout fragments as JSONL (one fragment per line)."""

    def __init__(self, path: str, max_file_size: int = 64 * 1024 * 1024):
        self._dir = path
        os.makedirs(path, exist_ok=True)
        self._max = max_file_size
        self._index = 0
        self._file = None

    def _rotate(self):
        if self._file is not None:
            self._file.close()
        name = os.path.join(self._dir, f"output-{self._index:05d}.jsonl")
        self._index += 1
        self._file = open(name, "a")

    def write(self, fragment: Dict[str, Any]) -> None:
        if self._file is None or self._file.tell() > self._max:
            self._rotate()
        row = {}
        for k, v in fragment.items():
            row[k] = v.tolist() if isinstance(v, np.ndarray) else v
        self._file.write(json.dumps(row) + "\n")
        self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


class JsonReader:
    """Read fragments back as numpy column dicts."""

    # actions: None = infer (int32 for discrete logs, float32 continuous)
    _ARRAY_DTYPES = {"obs": np.float32, "actions": None,
                     "rewards": np.float32, "dones": np.bool_,
                     "terminated": np.bool_, "next_obs": np.float32,
                     "logp": np.float32, "values": np.float32}

    def __init__(self, path: str):
        self._files = sorted(glob.glob(os.path.join(path, "*.jsonl"))) \
            if os.path.isdir(path) else [path]
        if not self._files:
            raise FileNotFoundError(f"no .jsonl files under {path}")

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for fn in self._files:
            with open(fn) as f:
                for line in f:
                    if not line.strip():
                        continue
                    row = json.loads(line)
                    for k, dt in self._ARRAY_DTYPES.items():
                        if k not in row:
                            continue
                        if dt is None:
                            arr = np.asarray(row[k])
                            dt = (np.int32 if arr.dtype.kind in "iub"
                                  else np.float32)
                            row[k] = arr.astype(dt)
                        else:
                            row[k] = np.asarray(row[k], dt)
                    yield row

    def read_all(self) -> Dict[str, np.ndarray]:
        cols: Dict[str, List[np.ndarray]] = {}
        for row in self:
            for k, v in row.items():
                if isinstance(v, np.ndarray):
                    cols.setdefault(k, []).append(v)
        return {k: np.concatenate(v) for k, v in cols.items()}


def to_dataset(path: str):
    """Bridge into ray_tpu_torch.data: one block row per transition."""
    from ray_tpu_torch import data

    cols = JsonReader(path).read_all()
    n = len(cols["actions"])
    return data.from_items([
        {k: cols[k][i].tolist() if cols[k][i].ndim else cols[k][i].item()
         for k in cols} for i in range(n)
    ])


def collect(env_spec, policy_params, path: str, *, num_steps: int = 2048,
            seed: int = 0, record_next_obs: bool = False) -> str:
    """Roll out a policy and persist the experience (reference
    ``rllib ... output`` config): the offline-data entry point.
    ``record_next_obs`` persists true successors + the terminated flag —
    what offline TD consumers (CQL) need."""
    from ray_tpu_torch.rl.env_runner import EnvRunner

    runner = EnvRunner(env_spec, seed=seed, record_next_obs=record_next_obs)
    runner.set_weights(policy_params)
    writer = JsonWriter(path)
    wrote = 0
    while wrote < num_steps:
        frag = runner.sample(min(512, num_steps - wrote))
        writer.write({k: v for k, v in frag.items()
                      if k in JsonReader._ARRAY_DTYPES})
        wrote += len(frag["actions"])
    writer.close()
    return path


@dataclasses.dataclass
class BCConfig:
    input_path: str = ""
    lr: float = 1e-3
    num_epochs: int = 1
    minibatch_size: int = 256
    hidden: tuple = (64, 64)
    seed: int = 0
    env: Union[str, Any] = "CartPole-v1"  # only needed for evaluate()
    # the learner's device: None is CUDA, "cpu" the CPU
    learner_device: Optional[str] = None

    def build(self) -> "BC":
        return BC(self)


class BC:
    """Behavior cloning: maximize log π(a_logged | s) over the dataset
    (reference ``rllib/algorithms/bc``). The simplest offline algorithm —
    and the correctness anchor for the offline data path."""

    def __init__(self, config: BCConfig):
        from ray_tpu_torch import resolve_device
        from ray_tpu_torch.rl.learner import _Adam, _tensors
        from ray_tpu_torch.rl.module import init_policy_params

        self.config = config
        self.device = resolve_device(config.learner_device)
        data = JsonReader(config.input_path).read_all()
        self._obs = np.asarray(data["obs"], np.float32)
        self._actions = np.asarray(data["actions"], np.int32)
        self.params = _tensors(init_policy_params(
            self._obs.shape[-1], int(self._actions.max()) + 1,
            hidden=tuple(config.hidden), seed=config.seed), self.device)
        self._opt = _Adam(config.lr, None)
        self._opt_state = self._opt.init(self.params)
        self.iteration = 0
        self._rng = np.random.default_rng(config.seed)

    @staticmethod
    def _loss(params, obs, actions):
        import torch

        from ray_tpu_torch.rl.module import torch_forward

        logits, _ = torch_forward(params, obs)
        logp = torch.log_softmax(logits, dim=-1)
        return (-logp.gather(1, actions[:, None].long())).mean(), {}

    def step(self, obs, actions):
        """One update from device tensors; the loss stays a tensor."""
        from ray_tpu_torch.rl.learner import value_and_grad

        loss, _, grads = value_and_grad(self._loss, self.params, obs,
                                        actions)
        self.params, self._opt_state = self._opt.update(
            grads, self._opt_state, self.params)
        return loss

    def train(self) -> Dict[str, Any]:
        from ray_tpu_torch.rl.learner import _tensor

        self.iteration += 1
        n = len(self._obs)
        mb = min(self.config.minibatch_size, n)
        losses = []
        for _ in range(self.config.num_epochs):
            order = self._rng.permutation(n)
            for i in range(0, n - mb + 1, mb):
                idx = order[i:i + mb]
                losses.append(self.step(
                    _tensor(self._obs[idx], self.device),
                    _tensor(self._actions[idx], self.device)))
        return {"training_iteration": self.iteration,
                "bc_loss": float(np.mean([float(v) for v in losses]))}

    def evaluate(self, num_episodes: int = 5,
                 seed: int = 100) -> Dict[str, float]:
        from ray_tpu_torch.rl.envs import make_env
        from ray_tpu_torch.rl.module import np_forward

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


def torch_to_np(params):
    """A dict of tensors (or arrays) as numpy arrays on the host (the JAX
    package's ``jax_to_np``)."""
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                else np.asarray(v)) for k, v in params.items()}
