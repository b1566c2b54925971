"""IMPALA: asynchronous sample/learn with aggregator actors and V-trace
(port of ``ray_tpu/rl/impala.py``).

Reference: ``rllib/algorithms/impala/impala.py:599`` (async training_step)
and ``:634-650`` (aggregator actors building train batches from episode
refs ahead of the learner). Architecture here:

- EnvRunner actors sample continuously; the driver keeps one ``sample()``
  call in flight per runner and NEVER blocks the learner on sampling.
- Completed fragment REFS are handed to :class:`Aggregator` actors (the
  fragment bytes flow runner→aggregator through the object plane, not
  through the driver), which concatenate fragments into train batches.
- The learner applies **V-trace** off-policy correction (Espeholt et al.,
  2018): sampling continues under stale weights, and the clipped
  importance-sampling reverse scan corrects the value targets and
  policy-gradient advantages.

The port's learner runs on its device (None means CUDA). The JAX
package's reverse ``lax.scan`` runs element by element over the whole
concatenated batch; here the batch is laid out as (fragments, T) from
its host-side ``fragment_end`` flags (padded where fragments differ in
length), and the scan loops over T with one fused multiply-add per step
on all fragments at once, under ``no_grad`` (the corrections carry no
gradient): T + a few launches an update, not one a batch element.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.learner import (_Adam, _tensors, value_and_grad)
from ray_tpu_torch.rl.module import init_policy_params, torch_forward


class Aggregator:
    """Batch-building actor (reference impala.py:634 aggregator actors):
    receives rollout fragments (by ref — the data plane bypasses the
    driver), concatenates them into fixed train batches."""

    def __init__(self, train_batch_size: int):
        import threading

        self._size = train_batch_size
        self._buffer: List[Dict[str, np.ndarray]] = []
        self._steps = 0
        # max_concurrency > 1 runs these sync methods on multiple threads
        self._lock = threading.Lock()

    def add_fragment(self, fragment) -> int:
        # vectorized runners ship a LIST of per-env fragments in one call
        frags = fragment if isinstance(fragment, list) else [fragment]
        with self._lock:
            for f in frags:
                self._buffer.append(f)
                self._steps += len(f["obs"])
            return self._steps

    def get_ready_batch(self) -> Optional[Dict[str, Any]]:
        """A concatenated batch of >= train_batch_size steps, else None."""
        with self._lock:
            if self._steps < self._size:
                return None
            frags, self._buffer = self._buffer, []
            self._steps = 0
        keys = ("obs", "actions", "logp", "rewards", "values", "dones")
        batch = {k: np.concatenate([f[k] for f in frags]) for k in keys}
        # fragment boundaries never propagate values across: mark the last
        # step of each fragment with its bootstrap value
        bootstrap = np.zeros(len(batch["obs"]), np.float32)
        is_last = np.zeros(len(batch["obs"]), bool)
        off = 0
        for f in frags:
            n = len(f["obs"])
            bootstrap[off + n - 1] = f["last_value"]
            is_last[off + n - 1] = True
            off += n
        batch["bootstrap_value"] = bootstrap
        batch["fragment_end"] = is_last
        batch["episode_returns"] = np.asarray(
            [r for f in frags for r in f["episode_returns"]], np.float32)
        return batch


def fragment_layout(fragment_end) -> Tuple[Tuple[int, int], Any]:
    """The (fragments, T) layout of a concatenated batch from its numpy
    ``fragment_end`` flags: a fragment ends at each flag (and at the last
    element). Returns ``((F, T), index)``, where ``index`` is None when
    every fragment has T elements (a plain reshape), else an (F, T) array
    of batch positions, ``n`` (one past the end) where a row is padded."""
    fe = np.asarray(fragment_end, bool)
    n = len(fe)
    ends = np.flatnonzero(fe)
    if len(ends) == 0 or ends[-1] != n - 1:
        ends = np.append(ends, n - 1)
    starts = np.concatenate([[0], ends[:-1] + 1])
    lens = ends - starts + 1
    T = int(lens.max())
    if (lens == T).all():
        return (len(lens), T), None
    index = np.full((len(lens), T), n, np.int64)
    for i, (s, m) in enumerate(zip(starts, lens)):
        index[i, :m] = np.arange(s, s + m)
    return (len(lens), T), index


def _reverse_scan(delta, coef, layout):
    """corr_t = delta_t + coef_t · corr_{t+1} within each fragment (corr
    past a fragment's end is 0), looped over T on (F, T) rows."""
    import torch

    (F, T), index = layout
    if index is None:
        d, k = delta.reshape(F, T), coef.reshape(F, T)
    else:
        pos = torch.as_tensor(index, device=delta.device)
        zero = delta.new_zeros(1)
        d = torch.cat([delta, zero])[pos]
        k = torch.cat([coef, zero])[pos]
    acc = delta.new_zeros(F)
    out = []
    for t in range(T - 1, -1, -1):
        acc = torch.addcmul(d[:, t], k[:, t], acc)
        out.append(acc)
    corr = torch.stack(out[::-1], dim=1)
    if index is None:
        return corr.reshape(-1)
    return corr.reshape(-1)[torch.as_tensor(
        index.reshape(-1) < len(delta), device=delta.device)]


def vtrace_corrections(values, batch, rho, *, gamma, rho_bar, c_bar,
                       layout=None):
    """V-trace (Espeholt et al., 2018) value targets + pg advantages over
    a batch of concatenated fragments. The reverse-scan carry zeroes at
    fragment boundaries: concatenated fragments come from unrelated
    trajectories, so corr_{t+1} of the NEXT fragment must not leak into
    this fragment's targets. Returns (vs, pg_adv); callers detach `rho`
    themselves. Shared by IMPALA and APPO losses. ``layout`` is
    :func:`fragment_layout` of the batch's flags (read from the batch,
    a host copy, when not given)."""
    import torch

    if layout is None:
        layout = fragment_layout(
            batch["fragment_end"].detach().cpu().numpy())
    with torch.no_grad():
        values_sg = values.detach()
        fe = batch["fragment_end"].bool()
        nonterm = 1.0 - batch["dones"].float()
        # next-step values: train-time values shifted left; fragment
        # tails use the runner's bootstrap value
        next_values = torch.where(fe, batch["bootstrap_value"],
                                  torch.roll(values_sg, -1))
        rho_c = torch.clamp(rho, max=rho_bar)
        c = torch.clamp(rho, max=c_bar)
        delta = rho_c * (batch["rewards"] + gamma * nonterm * next_values
                         - values_sg)
        # cut across fragments: no carry into a fragment's last step
        coef = gamma * nonterm * c * (~fe).float()
        vs = values_sg + _reverse_scan(delta, coef, layout)
        vs_next = torch.where(fe, batch["bootstrap_value"],
                              torch.roll(vs, -1))
        pg_adv = rho_c * (batch["rewards"] + gamma * nonterm * vs_next
                          - values_sg)
    return vs, pg_adv


class IMPALALearner:
    """Policy gradient with V-trace targets (reference: rllib vtrace)."""

    def __init__(self, params, *, lr: float = 5e-4, gamma: float = 0.99,
                 vf_coeff: float = 0.5, entropy_coeff: float = 0.01,
                 rho_bar: float = 1.0, c_bar: float = 1.0,
                 grad_clip: float = 40.0, device=None):
        from ray_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self.gamma = gamma
        self.vf_coeff, self.entropy_coeff = vf_coeff, entropy_coeff
        self.rho_bar, self.c_bar = rho_bar, c_bar
        self._optimizer = _Adam(lr, grad_clip)
        self._params = _tensors(dict(params), self.device)
        self._opt_state = self._optimizer.init(self._params)
        self.updates = 0

    def _logp(self, params, batch):
        import torch

        logits, values = torch_forward(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, batch["actions"][:, None].long())[:, 0]
        entropy = -(torch.exp(logp_all) * logp_all).sum(dim=1).mean()
        return logp, values, entropy

    def _loss(self, params, batch, layout):
        """Loss hook: APPO overrides ONLY this (reference structure:
        appo_learner.py subclasses the IMPALA learner, swapping the
        surrogate while sharing v-trace and the update scaffolding)."""
        import torch

        logp, values, entropy = self._logp(params, batch)
        rho = torch.exp(logp - batch["logp"]).detach()
        vs, pg_adv = vtrace_corrections(
            values, batch, rho, gamma=self.gamma, rho_bar=self.rho_bar,
            c_bar=self.c_bar, layout=layout)
        pi_loss = -(logp * pg_adv).mean()
        vf_loss = ((values - vs) ** 2).mean()
        total = (pi_loss + self.vf_coeff * vf_loss
                 - self.entropy_coeff * entropy)
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "mean_rho": rho.mean()}

    def _device_batch(self, batch):
        layout = fragment_layout(batch["fragment_end"])
        return _tensors({k: v for k, v in batch.items()
                         if k != "episode_returns"}, self.device), layout

    def step(self, batch, layout) -> Dict[str, Any]:
        """One update from a device batch and its layout; metrics stay
        tensors (no host sync)."""
        grads, aux = self._grad(batch, layout)
        self._apply(grads)
        return aux

    def _grad(self, batch, layout):
        total, aux, grads = value_and_grad(self._loss, self._params, batch,
                                           layout)
        aux["total_loss"] = total
        return grads, aux

    def _apply(self, grads):
        self._params, self._opt_state = self._optimizer.update(
            grads, self._opt_state, self._params)
        self.updates += 1

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        return {k: float(v) for k, v in self.step(
            *self._device_batch(batch)).items()}

    # Split pair for LearnerGroup gradient sync (reference Learner API:
    # compute_gradients:464 / apply_gradients:607).
    def compute_gradients(self, batch: Dict[str, np.ndarray]):
        return self._grad(*self._device_batch(batch))

    def apply_gradients(self, grads) -> None:
        self._apply(_tensors(grads, self.device))

    def set_weights(self, params: Dict[str, np.ndarray]):
        self._params = _tensors(dict(params), self.device)

    def get_weights(self) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() for k, v in self._params.items()}


@dataclasses.dataclass
class IMPALAConfig(AlgorithmConfig):
    train_batch_size: int = 512
    num_aggregators: int = 1
    lr: float = 5e-4
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    # max learner updates pulled per training_step() call
    max_updates_per_step: int = 8
    broadcast_interval: int = 1  # weight push every N learner updates
    # >1 → LearnerGroup: N learner actors, batch sharded across them,
    # gradients mean-allreduced per update (reference learner_group.py:100).
    # "kv" syncs over the GCS KV store (CPU hosts); "xla" over ICI meshes.
    num_learners: int = 1
    learner_backend: str = "kv"
    # async update pipeline depth per LearnerGroup (IMPALA's update queue)
    max_inflight_updates: int = 4

    @property
    def algo_class(self):
        return IMPALA

    # learner construction hooks so APPO reuses the whole async driver
    # with a different loss (reference: APPO subclasses IMPALA,
    # rllib/algorithms/appo/appo.py:40)
    def learner_cls(self):
        return IMPALALearner

    def learner_kwargs(self) -> dict:
        return dict(lr=self.lr, gamma=self.gamma, vf_coeff=self.vf_coeff,
                    entropy_coeff=self.entropy_coeff,
                    device=self.learner_device)


class IMPALA(Algorithm):
    """Async IMPALA driver (reference impala.py:599 training_step)."""

    def __init__(self, config: IMPALAConfig):
        import ray_tpu_torch

        super().__init__(config)
        params = init_policy_params(
            self._env_probe["obs_size"], self._env_probe["num_actions"],
            hidden=tuple(config.hidden), seed=config.seed)
        self.learner = None
        self.learner_group = None
        self._learner_updates = 0
        learner_cls = config.learner_cls()
        learner_kwargs = config.learner_kwargs()
        if config.num_learners > 1:
            from ray_tpu_torch.rl.learner_group import LearnerGroup

            def factory(_p=params, _cls=learner_cls, _kw=learner_kwargs):
                return _cls(_p, **_kw)

            self.learner_group = LearnerGroup(
                factory, num_learners=config.num_learners,
                backend=config.learner_backend,
                max_inflight_updates=config.max_inflight_updates)
        else:
            self.learner = learner_cls(params, **learner_kwargs)
        agg_cls = ray_tpu_torch.remote(Aggregator)
        self._aggregators = [
            agg_cls.options(max_concurrency=4).remote(config.train_batch_size)
            for _ in range(config.num_aggregators)]
        self._agg_rr = 0
        self._inflight: Dict[Any, int] = {}   # sample ref -> runner index
        self._steps_sampled = 0
        self._steps_trained = 0
        self._push_weights()
        self._kick_all_runners()

    # ------------------------------------------------------------ async loop
    def get_weights(self):
        if self.learner_group is not None:
            return self.learner_group.get_weights()
        return self.learner.get_weights()

    @property
    def _num_learner_updates(self) -> int:
        if self.learner_group is not None:
            return self._learner_updates
        return self.learner.updates

    def _push_weights(self):
        self._weights_version += 1
        weights = self.get_weights()
        self.env_runner_group.foreach_actor(
            lambda a: a.set_weights.remote(weights, self._weights_version))

    def _kick_all_runners(self):
        actors = self.env_runner_group.actors
        for idx in self.env_runner_group.healthy_actor_ids():
            if not any(i == idx for i in self._inflight.values()):
                self._kick_runner(idx, actors[idx])

    def _kick_runner(self, idx, actor):
        ref = actor.sample.remote(self.config.rollout_fragment_length)
        self._inflight[ref] = idx

    def _route_completed_samples(self, timeout: float):
        """Move finished fragments runner→aggregator and resample; the
        learner never waits on any individual runner."""
        import ray_tpu_torch

        if not self._inflight:
            self._kick_all_runners()
            if not self._inflight:
                raise RuntimeError("no healthy env runners")
        ready, _ = ray_tpu_torch.wait(list(self._inflight),
                                num_returns=1, timeout=timeout)
        for ref in ready:
            idx = self._inflight.pop(ref)
            agg = self._aggregators[self._agg_rr % len(self._aggregators)]
            self._agg_rr += 1
            # fragment bytes travel runner→aggregator via the ref
            agg.add_fragment.remote(ref)
            self._steps_sampled += (
                self.config.rollout_fragment_length
                * getattr(self.config, "num_envs_per_env_runner", 1))
            if idx in self.env_runner_group.healthy_actor_ids():
                self._kick_runner(idx, self.env_runner_group.actors[idx])

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch

        self._maybe_restore_runners()
        updates = 0
        metrics: Dict[str, float] = {}
        returns: List[float] = []
        deadline = time.monotonic() + 30.0
        while updates < self.config.max_updates_per_step \
                and time.monotonic() < deadline:
            self._route_completed_samples(timeout=0.05)
            got_batch = False
            for agg in self._aggregators:
                batch = ray_tpu_torch.get(agg.get_ready_batch.remote(), timeout=60)
                if batch is None:
                    continue
                got_batch = True
                if self.learner_group is not None:
                    # async update queue (reference impala.py:599): enqueue
                    # without waiting; drain whatever finished. A full
                    # pipeline drops the batch (classic IMPALA backpressure).
                    if self.learner_group.async_update(batch):
                        self._steps_trained += len(batch["obs"])
                        returns.extend(batch["episode_returns"].tolist())
                    for m in self.learner_group.poll_updates():
                        metrics = m
                        updates += 1
                        self._learner_updates += 1
                        if self._learner_updates \
                                % self.config.broadcast_interval == 0:
                            self._push_weights()
                else:
                    metrics = self.learner.update(batch)
                    self._steps_trained += len(batch["obs"])
                    returns.extend(batch["episode_returns"].tolist())
                    updates += 1
                    if self.learner.updates \
                            % self.config.broadcast_interval == 0:
                        self._push_weights()
            if not got_batch:
                continue  # keep routing samples; learner stays decoupled
        self._return_window = (self._return_window
                               + [float(r) for r in returns])[-100:]
        return {
            "env_runners": {
                "episode_return_mean": self.episode_return_mean(),
                "num_episodes": len(returns),
                "num_env_steps_sampled": self._steps_sampled,
                "num_healthy_workers":
                    self.env_runner_group.num_healthy_actors(),
            },
            "learners": {"default_policy": dict(
                metrics, num_updates=self._num_learner_updates,
                num_env_steps_trained=self._steps_trained)},
        }
