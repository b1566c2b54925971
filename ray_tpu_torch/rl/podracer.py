"""Podracer RL scale-out: Sebulba (split acting/learning) + Anakin (port
of ``ray_tpu/rl/podracer.py``).

Reference: "Podracer architectures for scalable Reinforcement Learning"
(Hessel et al., arXiv 2104.06272). Two architectures, both driven from a
:class:`PodracerConfig` via ``algo.scale_out(...)``:

- **Sebulba** splits acting and learning onto separate actor fleets (on
  real meshes, separate device slices via
  ``parallel.stage_device_slices``).  N runner actors each wrap a
  vectorized :class:`~ray_tpu_torch.rl.env_runner.EnvRunner` and stream rollout
  fragments as ONE sealed :class:`FragmentBatch` fused object per sample
  (the data/shuffle.py ``FusedPartitions`` pattern: stacked columns are
  the out-of-band pickle-5 buffers, so the learner maps them zero-copy
  from the shm arena).  Only the small object REF crosses the
  runner→queue→learner hop, over depth-1
  :class:`~ray_tpu_torch.graph.channels.ShmChannel` edges with every loop
  parked as a resident actor call (train/pipeline.py's topology) — the
  steady state costs zero per-fragment driver RPCs.  Policy params flow
  the other way as a broadcast object: the learner ``put``s its weights
  once per update and fans the (version, ref) pair out on per-runner
  param channels; fragments carry the version they were acted under, so
  the learner measures policy lag per batch and can bound it
  (``max_policy_lag``) by dropping stale fragments.
  The learner actor takes a GPU (``num_gpus=1``) when the algorithm's
  learner device is CUDA; runners stay numpy-only, and no CUDA tensor
  crosses a channel.
- **Anakin** is the in-device act+learn step for in-device envs
  (``rl/envs.py`` ``TorchCartPole``): one update runs a loop over env
  step + policy step, a reverse GAE loop and the PPO update, with
  params, optimizer state, env state and the generator on the device and
  no host sync between ``train(n)``'s start and its weight fold-back —
  no object plane on the hot path.

Failure contract (chaos-hardened, ``common/faults.py`` points
``rl.fragment.push`` / ``rl.params.broadcast``): a dropped handoff is
counted and skipped, never fatal; a SIGKILLed runner surfaces as a typed
event on the driver, which re-spawns a replacement onto the SAME channel
segments (the shm robust mutex recovers an owner-died lock, and the
param channel retains the last broadcast, so the replacement re-reads
current weights without a fresh round-trip); a dead learner or queue
raises :class:`PodracerError` from the driver's watched waits instead of
hanging a channel read.  The synchronous ``Algorithm.train()`` loop is
the parity oracle: ``sync_weights=True`` runs the same lock-step
schedule over this substrate and must reproduce its updates exactly.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.common import faults
from ray_tpu_torch.core_worker import serialization as _ser
from ray_tpu_torch.graph.channels import NO_MESSAGE, ChannelClosed, ShmChannel

__all__ = [
    "PodracerConfig",
    "PodracerError",
    "FragmentBatch",
    "SebulbaHandle",
    "Anakin",
    "scale_out",
]

_BROADCAST_TIMEOUT_S = 0.25  # per-runner param write before skipping


class PodracerError(RuntimeError):
    """A Sebulba stage died or a Podracer op exceeded its deadline."""


@dataclasses.dataclass
class PodracerConfig:
    """Scale-out plan consumed by ``algo.scale_out(...)``.

    Sebulba knobs: ``num_runners`` actors each running
    ``envs_per_runner`` envs (defaults to the algo config's
    ``num_envs_per_env_runner``); the learner updates once per
    ``fragments_per_update`` per-env fragments (default: one full round,
    ``num_runners * envs_per_runner`` — the sync loop's batch).
    ``queue_policy`` is ``"block"`` (lossless backpressure) or
    ``"drop_oldest"`` (replay-buffer semantics: acting never stalls on a
    busy learner; the freshest ``queue_capacity`` batches survive).
    ``max_policy_lag`` drops fragments more than that many weight
    versions stale; ``sync_weights=True`` is the lock-step parity-oracle
    schedule (runners block for each new broadcast, lag is always 0).
    Anakin knobs: ``batch_envs`` in-device env copies per update.
    """

    mode: str = "sebulba"  # "sebulba" | "anakin"
    num_runners: int = 2
    envs_per_runner: Optional[int] = None
    fragment_length: Optional[int] = None
    fragments_per_update: Optional[int] = None
    queue_capacity: int = 8
    queue_policy: str = "block"
    max_policy_lag: Optional[int] = None
    sync_weights: bool = False
    channel_capacity: int = 1 << 20
    io_timeout_s: float = 120.0
    # anakin
    batch_envs: int = 32


# ---------------------------------------------------------------------------
# FragmentBatch: one sealed fused object per runner sample
# ---------------------------------------------------------------------------

class FragmentBatch:
    """All per-env fragments of one runner ``sample()`` in ONE object.

    ``columns`` stacks each fragment column over the runner's F envs —
    ``(F, T, ...)`` arrays (plus ``last_value`` as ``(F,)``) — and ships
    as the object's out-of-band pickle-5 buffers: the runner's ``put``
    is one memcpy into the shm arena and the learner's ``get`` aliases
    the shared pages (read-only views; batch assembly copies out of
    them, so no alias outlives the update).  ``meta`` carries the weight
    version the fragments were acted under, the producing runner index,
    per-env episode returns, and the runner's cumulative counters.
    """

    __slots__ = ("columns", "meta")

    _STACKED = ("obs", "actions", "rewards", "dones", "terminated",
                "logp", "values", "next_obs", "is_first")

    def __init__(self, columns: Dict[str, np.ndarray], meta: Dict[str, Any]):
        self.columns = columns
        self.meta = meta

    @classmethod
    def from_fragments(cls, fragments: List[Dict[str, Any]], *,
                       runner: int, counters: Dict[str, int]
                       ) -> "FragmentBatch":
        columns = {k: np.stack([f[k] for f in fragments])
                   for k in cls._STACKED if k in fragments[0]}
        columns["last_value"] = np.asarray(
            [f["last_value"] for f in fragments], np.float32)
        if "state_in" in fragments[0]:
            for k in fragments[0]["state_in"]:
                columns["state_in_" + k] = np.stack(
                    [f["state_in"][k] for f in fragments])
        meta = {
            "version": int(fragments[0]["weights_version"]),
            "runner": int(runner),
            "episode_returns": [[float(r) for r in f["episode_returns"]]
                                for f in fragments],
            "counters": {k: int(v) for k, v in counters.items()},
        }
        return cls(columns, meta)

    @property
    def num_fragments(self) -> int:
        return len(self.columns["last_value"])

    def to_fragments(self) -> List[Dict[str, Any]]:
        """Per-env fragment dicts exactly as ``EnvRunner.sample()``
        returns them — columns are VIEWS aliasing the fused payload."""
        state_keys = [k for k in self.columns if k.startswith("state_in_")]
        out = []
        for i in range(self.num_fragments):
            frag = {k: self.columns[k][i]
                    for k in self._STACKED if k in self.columns}
            frag["last_value"] = float(self.columns["last_value"][i])
            frag["episode_returns"] = self.meta["episode_returns"][i]
            frag["weights_version"] = self.meta["version"]
            if state_keys:
                frag["state_in"] = {k[len("state_in_"):]: self.columns[k][i]
                                    for k in state_keys}
            out.append(frag)
        return out

    def __reduce__(self):
        return (FragmentBatch, (self.columns, self.meta))


def _fragment_batch_safe(v, budget) -> bool:
    # columns must be plain non-object ndarrays (the OOB buffers); meta
    # is small scalar/list/dict data the C pickler handles — anything
    # else falls back to the cloudpickle meta path (correct, just not
    # the zero-copy fast frame).
    return (isinstance(v.columns, dict)
            and all(isinstance(a, np.ndarray) and not a.dtype.hasobject
                    for a in v.columns.values())
            and _ser._plain_safe(v.meta, 4, budget))


_ser.register_plain_safe(FragmentBatch, _fragment_batch_safe)


# ---------------------------------------------------------------------------
# Sebulba stage actors (resident loops parked on channel I/O)
# ---------------------------------------------------------------------------

class _SebulbaRunner:
    """Acting stage: wraps a vectorized EnvRunner (inheriting its
    episode/recurrent-state threading across fragment boundaries) and
    streams sealed FragmentBatch refs until its param channel closes."""

    def __init__(self, blob: bytes, worker_index: int):
        import cloudpickle

        from ray_tpu_torch.rl.env_runner import EnvRunner

        spec = cloudpickle.loads(blob)
        self._spec = spec
        self._worker_index = worker_index
        self._runner = EnvRunner(
            spec["env_spec"], seed=spec["seed"], worker_index=worker_index,
            connectors=spec["connectors"], num_envs=spec["num_envs"],
            module_to_env_connectors=spec["module_to_env_connectors"],
            record_next_obs=spec["record_next_obs"])
        self._weights_ref = None  # pins the arena pages our params alias
        self._stats = {"env_steps": 0, "fragments_produced": 0,
                       "push_drops": 0, "param_refreshes": 0,
                       "param_fetch_failures": 0}

    def pid(self) -> int:
        return os.getpid()

    def _refresh_params(self, param_ch: ShmChannel, block: bool) -> bool:
        """Pull the latest broadcast if any; False = channel closed
        (clean stop). A fetch failure (e.g. the broadcast object's
        version was retired before a late/respawned reader resolved it)
        retries on the next poll — never fatal."""
        import ray_tpu_torch

        try:
            if block:
                msg = param_ch.read(timeout_s=self._spec["io_timeout_s"])
            else:
                msg = param_ch.read_nowait()
                if msg is NO_MESSAGE:
                    return True
        except ChannelClosed:
            return False
        try:
            weights = ray_tpu_torch.get(msg["ref"], timeout=30.0)
        except Exception:  # noqa: BLE001 — stale ref; next broadcast heals
            self._stats["param_fetch_failures"] += 1
            return True
        self._runner.set_weights(weights, msg["version"])
        self._weights_ref = msg["ref"]
        self._stats["param_refreshes"] += 1
        return True

    def run_acting(self, param_ch: ShmChannel,
                   frag_ch: ShmChannel) -> Dict[str, int]:
        import ray_tpu_torch

        sync = self._spec["sync_weights"]
        T = self._spec["fragment_length"]
        try:
            ok = self._refresh_params(param_ch, block=True)
            while ok:
                frags = self._runner.sample(T)
                if not isinstance(frags, list):
                    frags = [frags]
                self._stats["fragments_produced"] += len(frags)
                self._stats["env_steps"] += len(frags) * T
                batch = FragmentBatch.from_fragments(
                    frags, runner=self._worker_index, counters=self._stats)
                try:
                    ref = ray_tpu_torch.put(batch)
                    faults.fault_point("rl.fragment.push")
                    frag_ch.write(
                        {"ref": ref, "version": batch.meta["version"],
                         "runner": self._worker_index},
                        timeout_s=self._spec["io_timeout_s"])
                except faults.FaultInjected:
                    self._stats["push_drops"] += len(frags)
                except TimeoutError:
                    # queue wedged past the io deadline: drop the batch
                    # and keep acting — a stalled consumer must not kill
                    # the producer (the driver sees the drop count)
                    self._stats["push_drops"] += len(frags)
                except ChannelClosed:
                    break
                ok = self._refresh_params(param_ch, block=sync)
        finally:
            # closure cascades to the queue whether we stop cleanly or die
            frag_ch.close()
        return dict(self._stats)


class _FragmentQueue:
    """Bounded queue/replay stage between the runner fleet and the
    learner: round-robin drains every runner channel (a dead runner
    simply stops yielding — the learner keeps stepping on the rest),
    then forwards FIFO to the learner with the live queue depth stamped
    on each message.  ``block`` policy stops draining when full
    (backpressure reaches the runners through their depth-1 channels);
    ``drop_oldest`` evicts the stalest batch instead, so acting never
    stalls on a busy learner."""

    def pid(self) -> int:
        return os.getpid()

    def run_queue(self, in_chs: List[ShmChannel], out_ch: ShmChannel,
                  capacity: int, policy: str) -> Dict[str, int]:
        buf: collections.deque = collections.deque()
        live = list(range(len(in_chs)))
        stats = {"forwarded": 0, "dropped": 0, "undelivered": 0}
        try:
            while live or buf:
                progressed = False
                for i in list(live):
                    if policy == "block" and len(buf) >= capacity:
                        break
                    try:
                        msg = in_chs[i].read_nowait()
                    except ChannelClosed:
                        live.remove(i)
                        continue
                    if msg is NO_MESSAGE:
                        continue
                    if len(buf) >= capacity:  # drop_oldest
                        buf.popleft()
                        stats["dropped"] += 1
                    buf.append(msg)
                    progressed = True
                if buf:
                    head = dict(buf[0])
                    head["queue_depth"] = len(buf)
                    try:
                        out_ch.write(head, timeout_s=0.05)
                        buf.popleft()
                        stats["forwarded"] += 1
                        progressed = True
                    except TimeoutError:
                        pass
                    except ChannelClosed:
                        break
                if not progressed:
                    time.sleep(0.002)
        finally:
            stats["undelivered"] += len(buf)
            out_ch.close()
        return stats


class _SebulbaLearner:
    """Learning stage: consumes fused fragment batches zero-copy,
    updates a PPOLearner on its device (the actor's GPU lease when CUDA),
    and broadcasts each new weight version as one put object (numpy, on
    the host) fanned out on the per-runner param channels."""

    def __init__(self, blob: bytes):
        import cloudpickle

        self._cfg = cloudpickle.loads(blob)

    def pid(self) -> int:
        return os.getpid()

    def run_learning(self, queue_ch: ShmChannel,
                     param_chs: List[ShmChannel],
                     result_ch: ShmChannel) -> Dict[str, Any]:
        import ray_tpu_torch

        from ray_tpu_torch.rl.learner import PPOLearner, build_ppo_batch

        c = self._cfg
        learner = PPOLearner(
            c["weights"], lr=c["lr"], clip=c["clip"],
            vf_coeff=c["vf_coeff"], entropy_coeff=c["entropy_coeff"],
            num_epochs=c["num_epochs"], minibatch_size=c["minibatch_size"],
            seed=c["seed"], device=c["device"])
        pipeline = c["learner_pipeline"]
        version = 0
        update_idx = 0
        # the last few broadcast objects stay pinned so a respawned or
        # slow runner resolving an older (version, ref) pair still hits
        # a live object; anything older heals on the next broadcast
        weight_refs: collections.deque = collections.deque(maxlen=4)
        closed = [False] * len(param_chs)
        stats = {"consumed": 0, "lag_dropped": 0, "lost_batches": 0,
                 "broadcast_skips": 0, "broadcast_faults": 0, "drained": 0}
        per_runner: Dict[int, Dict[str, int]] = {}

        def broadcast():
            ref = ray_tpu_torch.put(learner.get_weights())
            weight_refs.append(ref)
            msg = {"version": version, "ref": ref}
            for i, ch in enumerate(param_chs):
                if closed[i]:
                    continue
                try:
                    faults.fault_point("rl.params.broadcast")
                    ch.write(msg, timeout_s=(c["io_timeout_s"]
                                             if c["sync_weights"]
                                             else _BROADCAST_TIMEOUT_S))
                except faults.FaultInjected:
                    stats["broadcast_faults"] += 1
                except TimeoutError:
                    stats["broadcast_skips"] += 1
                except ChannelClosed:
                    closed[i] = True

        broadcast()
        pending: List[tuple] = []  # (runner, env_index, fragment)
        lag_last = queue_depth = 0
        try:
            while True:
                try:
                    msg = queue_ch.read(timeout_s=c["io_timeout_s"])
                except ChannelClosed:
                    break
                queue_depth = msg.get("queue_depth", 0)
                try:
                    fb = ray_tpu_torch.get(msg["ref"], timeout=30.0)
                except Exception:  # noqa: BLE001 — producer died in flight
                    stats["lost_batches"] += 1
                    continue
                per_runner[fb.meta["runner"]] = fb.meta["counters"]
                frags = fb.to_fragments()
                lag_last = version - fb.meta["version"]
                if (c["max_policy_lag"] is not None
                        and lag_last > c["max_policy_lag"]):
                    stats["lag_dropped"] += len(frags)
                    continue
                stats["consumed"] += len(frags)
                pending.extend((fb.meta["runner"], e, f)
                               for e, f in enumerate(frags))
                if len(pending) < c["fragments_per_update"]:
                    continue
                if c["sync_weights"]:
                    # lock-step oracle: deterministic (runner, env) batch
                    # order, matching the sync loop's fan-in order
                    pending.sort(key=lambda t: (t[0], t[1]))
                take = [f for _, _, f in pending]
                pending = []
                batch, returns, env_steps = build_ppo_batch(
                    take, gamma=c["gamma"], lam=c["lam"],
                    seq_len=c["seq_len"] if "state_in" in take[0] else None)
                if pipeline is not None:
                    batch = pipeline(batch)
                metrics = learner.update(batch)
                version += 1
                update_idx += 1
                broadcast()
                agg = {k: sum(r.get(k, 0) for r in per_runner.values())
                       for k in ("env_steps", "fragments_produced",
                                 "push_drops")}
                record = {"update": update_idx, "version": version,
                          "metrics": metrics, "policy_lag": lag_last,
                          "queue_depth": queue_depth,
                          "env_steps_trained": env_steps,
                          "episode_returns": returns,
                          "consumed": stats["consumed"],
                          "lag_dropped": stats["lag_dropped"], **agg}
                try:
                    result_ch.write(record, timeout_s=c["io_timeout_s"])
                except ChannelClosed:
                    break
        finally:
            stats["drained"] = len(pending)
            stats["consumed"] += len(pending)
            result_ch.close()
        return {"weights": learner.get_weights(), "version": version,
                "updates": update_idx, "per_runner": per_runner, **stats}


# ---------------------------------------------------------------------------
# Driver handle
# ---------------------------------------------------------------------------

_METRICS = None


def _instruments():
    global _METRICS
    if _METRICS is None:
        from ray_tpu_torch.util.metrics import Counter, Gauge

        _METRICS = {
            "env_steps": Counter(
                "rt_rl_env_steps_total", "env steps sampled by runners"),
            "fragments_produced": Counter(
                "rt_rl_fragments_produced_total", "fragments sealed"),
            "fragments_consumed": Counter(
                "rt_rl_fragments_consumed_total", "fragments consumed"),
            "fragments_dropped": Counter(
                "rt_rl_fragments_dropped_total",
                "fragments dropped (push faults + policy lag)"),
            "learner_updates": Counter(
                "rt_rl_learner_updates_total", "learner SGD updates"),
            "runner_restarts": Counter(
                "rt_rl_runner_restarts_total", "runner respawns"),
            "queue_depth": Gauge(
                "rt_rl_queue_depth", "fragment queue depth"),
            "policy_lag": Gauge(
                "rt_rl_policy_lag", "weight versions behind, last batch"),
            "env_steps_per_s": Gauge(
                "rt_rl_env_steps_per_s", "acting throughput"),
            "learner_steps_per_s": Gauge(
                "rt_rl_learner_steps_per_s", "learner update throughput"),
        }
    return _METRICS


def _plan_placement(num_runners: int) -> Dict[str, List[str]]:
    """Best-effort acting/learning device split (the paper's Sebulba
    topology): with an even number of GPUs the learner takes one
    contiguous slice and acting the other; a host with one GPU (or none)
    shares, which is recorded rather than hidden."""
    try:
        from ray_tpu_torch.common import gpu_detect
        from ray_tpu_torch.parallel.mesh import stage_device_slices

        devices = [f"cuda:{i}" for i in range(gpu_detect.detect())]
        if len(devices) >= 2 and len(devices) % 2 == 0:
            acting, learning = stage_device_slices(2, devices)
        else:
            acting, learning = devices, devices
        return {"acting": list(acting), "learning": list(learning)}
    except Exception:  # noqa: BLE001 — placement is advisory
        return {"acting": [], "learning": []}


class SebulbaHandle:
    """Driver handle for a running Sebulba session: watch updates,
    inspect ``debug_state()``, ``stop()`` to drain and fold the trained
    weights back into the algorithm.  Runner death is recovered in-place
    (respawn onto the same channels); learner/queue death raises
    :class:`PodracerError` from any watched wait."""

    def __init__(self, algo, cfg: PodracerConfig):
        import cloudpickle

        import ray_tpu_torch
        from ray_tpu_torch import resolve_device
        from ray_tpu_torch.rl.learner import PPOLearner

        if not isinstance(getattr(algo, "learner", None), PPOLearner):
            raise PodracerError(
                "Sebulba scale-out drives a PPOLearner algorithm; got "
                f"{type(getattr(algo, 'learner', None)).__name__}")
        self._algo = algo
        self._cfg = cfg
        ac = algo.config
        self._num_runners = cfg.num_runners
        envs = cfg.envs_per_runner or getattr(
            ac, "num_envs_per_env_runner", 1)
        frag_len = cfg.fragment_length or ac.rollout_fragment_length
        self._fragments_per_update = (cfg.fragments_per_update
                                      or cfg.num_runners * envs)
        self.placement = _plan_placement(cfg.num_runners)
        # the learner actor's device: a CUDA learner takes a GPU lease and
        # runs on the GPU it is granted
        device = resolve_device(getattr(ac, "learner_device", None))
        self.learner_device = str(device)
        tag = uuid.uuid4().hex[:10]
        self._channels: List[ShmChannel] = []

        def make(name):
            ch = ShmChannel(f"/rtrl_{tag}_{name}",
                            capacity=cfg.channel_capacity, num_readers=1)
            ch._handle()  # create before any actor opens it
            self._channels.append(ch)
            return ch

        self._param_chs = [make(f"p{i}") for i in range(cfg.num_runners)]
        self._frag_chs = [make(f"f{i}") for i in range(cfg.num_runners)]
        self._queue_out = make("q")
        self._result_ch = make("r")

        self._runner_blob = cloudpickle.dumps({
            "env_spec": ac.env, "seed": ac.seed, "num_envs": envs,
            "connectors": list(ac.connectors),
            "module_to_env_connectors": list(
                getattr(ac, "module_to_env_connectors", ())),
            "record_next_obs": getattr(ac, "record_next_obs", False),
            "fragment_length": frag_len, "sync_weights": cfg.sync_weights,
            "io_timeout_s": cfg.io_timeout_s,
        })
        learner_blob = cloudpickle.dumps({
            "weights": algo.get_weights(), "lr": ac.lr, "clip": ac.clip,
            "vf_coeff": ac.vf_coeff, "entropy_coeff": ac.entropy_coeff,
            "num_epochs": ac.num_epochs,
            "minibatch_size": ac.minibatch_size, "seed": ac.seed,
            "gamma": ac.gamma, "lam": ac.lam,
            "seq_len": getattr(ac, "seq_len", None),
            "device": None if device.type == "cuda" else str(device),
            "fragments_per_update": self._fragments_per_update,
            "max_policy_lag": (0 if cfg.sync_weights
                               else cfg.max_policy_lag),
            "sync_weights": cfg.sync_weights,
            "io_timeout_s": cfg.io_timeout_s,
            "learner_pipeline": (algo._learner_pipeline
                                 if algo._learner_pipeline.connectors
                                 else None),
        })

        self._remote_runner = ray_tpu_torch.remote(_SebulbaRunner)
        self._runner_refs: Dict[int, Any] = {}
        self._runner_pids: Dict[int, int] = {}
        self._runner_stats: Dict[int, Dict[int, Dict]] = {}
        for i in range(cfg.num_runners):
            self._spawn_runner(i)
        queue_actor = ray_tpu_torch.remote(_FragmentQueue).options(
            num_cpus=0).remote()
        self._queue_ref = queue_actor.run_queue.remote(
            self._frag_chs, self._queue_out, cfg.queue_capacity,
            cfg.queue_policy)
        lease = {"num_gpus": 1} if device.type == "cuda" else {}
        learner_actor = ray_tpu_torch.remote(_SebulbaLearner).options(
            num_cpus=0, **lease).remote(learner_blob)
        self.learner_pid = ray_tpu_torch.get(learner_actor.pid.remote())
        self._learner_ref = learner_actor.run_learning.remote(
            self._queue_out, self._param_chs, self._result_ch)
        self._actors = [queue_actor, learner_actor]

        self.events: List[Dict[str, str]] = []
        self.restarts = 0
        self._stopping = False
        self._stopped = False
        self._summary: Optional[Dict[str, Any]] = None
        self._last_record: Optional[Dict[str, Any]] = None
        self._rate_anchor = None  # (monotonic, env_steps, updates)
        self._totals = {"env_steps": 0, "fragments_produced": 0,
                        "fragments_consumed": 0, "fragments_dropped": 0,
                        "updates": 0}

    # ------------------------------------------------------------- spawning
    def _spawn_runner(self, i: int):
        import ray_tpu_torch

        actor = self._remote_runner.options(num_cpus=0).remote(
            self._runner_blob, i)
        self._runner_pids[i] = ray_tpu_torch.get(actor.pid.remote())
        self._runner_refs[i] = actor.run_acting.remote(
            self._param_chs[i], self._frag_chs[i])
        self._actors = getattr(self, "_actors", []) + [actor]

    # ------------------------------------------------------------- watching
    def _check_loops(self):
        import ray_tpu_torch

        for name, ref in (("queue", self._queue_ref),
                          ("learner", self._learner_ref)):
            done, _ = ray_tpu_torch.wait([ref], timeout=0)
            if done and not self._stopping:
                try:
                    ray_tpu_torch.get(ref)
                    err = "loop exited before stop()"
                except Exception as e:  # noqa: BLE001 — actor death
                    err = f"{type(e).__name__}: {e}"
                self.shutdown()
                raise PodracerError(f"sebulba {name} stage died: {err}")
        for i, ref in list(self._runner_refs.items()):
            done, _ = ray_tpu_torch.wait([ref], timeout=0)
            if not done:
                continue
            try:
                self._runner_stats[i] = ray_tpu_torch.get(ref)
                del self._runner_refs[i]  # clean exit (stop path)
            except Exception as e:  # noqa: BLE001 — runner died
                self.events.append({
                    "type": "runner_died", "runner": str(i),
                    "error": f"{type(e).__name__}: {e}"})
                del self._runner_refs[i]
                if not self._stopping:
                    self._spawn_runner(i)
                    self.restarts += 1
                    self.events.append({"type": "runner_respawned",
                                        "runner": str(i)})
                    _instruments()["runner_restarts"].inc()

    def _watched(self, op, timeout_s: float):
        from ray_tpu_torch.common.retry import Deadline

        deadline = Deadline(timeout_s)
        while True:
            try:
                return op(deadline.remaining(cap=0.2) or 0.0)
            except TimeoutError:
                if deadline.expired():
                    raise
                self._check_loops()

    # -------------------------------------------------------------- updates
    def wait_updates(self, n: int = 1,
                     timeout_s: float = 120.0) -> List[Dict[str, Any]]:
        """Block for the next ``n`` learner update records (each one
        weight version), ingesting them into metrics/debug state."""
        records = []
        for _ in range(n):
            try:
                rec = self._watched(
                    lambda t: self._result_ch.read(timeout_s=t), timeout_s)
            except ChannelClosed:
                # the learner closed its result stream: surface the REAL
                # cause (a dead learner/queue loop) typed before falling
                # back to the generic closed-stream error
                self._check_loops()
                raise PodracerError(
                    "learner result stream closed mid-run") from None
            self._ingest(rec)
            records.append(rec)
        return records

    def _ingest(self, rec: Dict[str, Any]):
        m = _instruments()
        t = self._totals
        deltas = {
            "env_steps": rec["env_steps"] - t["env_steps"],
            "fragments_produced": (rec["fragments_produced"]
                                   - t["fragments_produced"]),
            "fragments_consumed": rec["consumed"] - t["fragments_consumed"],
            "fragments_dropped": (rec["push_drops"] + rec["lag_dropped"]
                                  - t["fragments_dropped"]),
            "updates": rec["update"] - t["updates"],
        }
        t.update(env_steps=rec["env_steps"],
                 fragments_produced=rec["fragments_produced"],
                 fragments_consumed=rec["consumed"],
                 fragments_dropped=rec["push_drops"] + rec["lag_dropped"],
                 updates=rec["update"])
        for key in ("env_steps", "fragments_produced", "fragments_consumed",
                    "fragments_dropped"):
            if deltas[key] > 0:
                m[{"env_steps": "env_steps",
                   "fragments_produced": "fragments_produced",
                   "fragments_consumed": "fragments_consumed",
                   "fragments_dropped": "fragments_dropped"}[key]].inc(
                       deltas[key])
        if deltas["updates"] > 0:
            m["learner_updates"].inc(deltas["updates"])
        m["queue_depth"].set(rec["queue_depth"])
        m["policy_lag"].set(rec["policy_lag"])
        now = time.monotonic()
        if self._rate_anchor is not None:
            t0, steps0, upd0 = self._rate_anchor
            dt = max(now - t0, 1e-9)
            m["env_steps_per_s"].set((rec["env_steps"] - steps0) / dt)
            m["learner_steps_per_s"].set((rec["update"] - upd0) / dt)
        self._rate_anchor = (now, rec["env_steps"], rec["update"])
        self._last_record = rec
        returns = [r for frag in rec["episode_returns"] for r in frag] \
            if rec["episode_returns"] and isinstance(
                rec["episode_returns"][0], list) else rec["episode_returns"]
        self._algo._return_window = (
            self._algo._return_window + list(returns))[-100:]

    # ---------------------------------------------------------- observability
    def debug_state(self) -> Dict[str, Any]:
        from ray_tpu_torch.util.metrics import local_snapshots

        snaps = {s["name"]: s["values"] for s in local_snapshots()
                 if s["name"].startswith("rt_rl_")}
        return {
            "mode": "sebulba",
            "placement": self.placement,
            "num_runners": self._num_runners,
            "live_runner_loops": len(self._runner_refs),
            "fragments_per_update": self._fragments_per_update,
            "restarts": self.restarts,
            "events": list(self.events),
            "totals": dict(self._totals),
            "last_record": self._last_record,
            "metrics": snaps,
        }

    # ----------------------------------------------------------------- stop
    def stop(self, timeout_s: float = 120.0) -> Dict[str, Any]:
        """Clean stop: close the param channels (runners finish their
        fragment, close their frag channels; the queue drains into the
        learner; the learner consumes the drain, closes the result
        stream and returns) — then fold the final weights back into the
        algorithm and return the session summary."""
        import ray_tpu_torch

        from ray_tpu_torch.common.retry import Deadline

        if self._stopped:
            return self._summary
        self._stopping = True
        deadline = Deadline(timeout_s)
        for ch in self._param_chs:
            ch.close()
        try:
            while True:  # drain result records so the learner never blocks
                try:
                    rec = self._result_ch.read(
                        timeout_s=deadline.remaining(cap=0.2) or 0.0)
                    self._ingest(rec)
                except ChannelClosed:
                    break
                except TimeoutError:
                    if deadline.expired():
                        self.shutdown()
                        raise PodracerError(
                            "stop() deadline expired draining results"
                        ) from None
                    self._check_loops()
            loop_out: Dict[str, Any] = {}
            for name, ref in [("queue", self._queue_ref),
                              ("learner", self._learner_ref)] + [
                                  (f"runner_{i}", r)
                                  for i, r in self._runner_refs.items()]:
                try:
                    loop_out[name] = ray_tpu_torch.get(
                        ref, timeout=deadline.remaining() or 0.1)
                except Exception as e:  # noqa: BLE001 — died during stop
                    self.events.append({"type": "stop_loss", "stage": name,
                                        "error": f"{type(e).__name__}: {e}"})
        finally:
            self.shutdown()
        learner_out = loop_out.get("learner")
        if learner_out is not None:
            self._algo.learner.set_weights(learner_out["weights"])
            self._algo._weights_version = learner_out["version"]
        runner_stats = dict(self._runner_stats)
        runner_stats.update({
            int(k.split("_")[1]): v for k, v in loop_out.items()
            if k.startswith("runner_")})
        self._summary = {
            "runners": runner_stats,
            "queue": loop_out.get("queue"),
            "learner": learner_out,
            "restarts": self.restarts,
            "events": list(self.events),
            "totals": dict(self._totals),
        }
        self._stopped = True
        return self._summary

    def shutdown(self):
        """Idempotent teardown: close + unlink channels, kill actors."""
        import ray_tpu_torch

        self._stopping = True
        for ch in self._channels:
            ch.close()
            ch.unlink()
        self._channels = []
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001 — already dead
                pass
        self._actors = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not self._stopped:
            self.shutdown()
        return False

    @property
    def runner_pids(self) -> Dict[int, int]:
        """Live runner OS pids (chaos harnesses SIGKILL these)."""
        return dict(self._runner_pids)


# ---------------------------------------------------------------------------
# Anakin: in-device act+learn for in-device envs
# ---------------------------------------------------------------------------

class Anakin:
    """One in-device program per update: a loop rolls the batched
    in-device env forward under the current policy, a reverse loop
    computes GAE, and ``num_epochs`` full-batch clipped-surrogate steps
    apply — params, optimizer state, env state and the generator all
    live on the learner's device (the algorithm's ``learner_device``,
    None meaning CUDA), and nothing between ``train(n)``'s start and its
    weight fold-back waits on the device, so the object plane never
    touches the hot path (the paper's Anakin: everything on-device)."""

    def __init__(self, algo, cfg: PodracerConfig):
        import torch

        from ray_tpu_torch import resolve_device
        from ray_tpu_torch.rl.envs import get_jax_env
        from ray_tpu_torch.rl.learner import _tensors
        from ray_tpu_torch.rl.module import is_stateful

        ac = algo.config
        weights = algo.get_weights()
        if is_stateful(weights):
            raise PodracerError(
                "Anakin mode supports feedforward modules (the whole "
                "unroll is one loop; recurrent acting state belongs to "
                "the Sebulba runners)")
        self._algo = algo
        self._env = get_jax_env(ac.env)
        self._B = cfg.batch_envs
        self._T = cfg.fragment_length or ac.rollout_fragment_length
        self._hyper = {"gamma": ac.gamma, "lam": ac.lam, "clip": ac.clip,
                       "vf_coeff": ac.vf_coeff,
                       "entropy_coeff": ac.entropy_coeff,
                       "num_epochs": ac.num_epochs, "lr": ac.lr}
        self.device = resolve_device(getattr(ac, "learner_device", None))
        self._step, self._optimizer = _build_anakin_step(
            self._env, self._T, self._hyper)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(ac.seed)
        env_state, obs = self._env.reset(self._gen, self._B)
        params = _tensors(dict(weights), self.device)
        self._carry = (params, self._optimizer.init(params), env_state,
                       obs)
        self.updates = 0
        self.env_steps = 0

    def draws(self) -> Dict[str, Any]:
        """One update's draws: the actions' Gumbel noise (T, B, A) on the
        device, and the generator for the env's resets."""
        from ray_tpu_torch.rl.module import torch_gumbel

        A = int(self._carry[0]["pi_b"].shape[0])
        return {"act": torch_gumbel((self._T, self._B, A), self._gen,
                                    self.device),
                "env": self._gen}

    def train(self, num_updates: int = 1) -> Dict[str, Any]:
        """Run ``num_updates`` in-device act+learn steps; returns
        throughput + learning metrics and folds weights back into the
        algorithm."""
        t0 = time.monotonic()
        metrics = {}
        for _ in range(num_updates):
            *carry, metrics = self._step(*self._carry, self.draws())
            self._carry = tuple(carry)
            self.updates += 1
            self.env_steps += self._B * self._T
        # the fold-back: the loop's one wait on the device
        params = {k: v.detach().cpu().numpy()
                  for k, v in self._carry[0].items()}
        dt = max(time.monotonic() - t0, 1e-9)
        self._algo.learner.set_weights(params)
        self._algo._weights_version += num_updates
        m = _instruments()
        m["env_steps"].inc(num_updates * self._B * self._T)
        m["learner_updates"].inc(num_updates)
        m["env_steps_per_s"].set(num_updates * self._B * self._T / dt)
        m["learner_steps_per_s"].set(num_updates / dt)
        return {"updates": self.updates, "env_steps": self.env_steps,
                "env_steps_per_s": num_updates * self._B * self._T / dt,
                "learner_steps_per_s": num_updates / dt,
                "metrics": {k: float(v) for k, v in metrics.items()}}

    def debug_state(self) -> Dict[str, Any]:
        from ray_tpu_torch.util.metrics import local_snapshots

        return {"mode": "anakin", "batch_envs": self._B,
                "unroll_length": self._T, "updates": self.updates,
                "env_steps": self.env_steps, "device": str(self.device),
                "metrics": {s["name"]: s["values"]
                            for s in local_snapshots()
                            if s["name"].startswith("rt_rl_")}}


def _build_anakin_step(env, unroll: int, hyper: Dict[str, float]):
    """Build the Anakin step + its optimizer (the JAX package's
    ``_build_anakin_step``, whose jitted scans are these loops).
    Signature: ``step(params, opt_state, env_state, obs, draws) ->
    (params, opt_state, env_state, obs, metrics)``, where ``draws`` holds
    ``act``, the actions' Gumbel noise (unroll, B, A), and ``env``, the
    env's draw for each step: a ``torch.Generator``, or a sequence
    indexed by step (the reset uniforms, (unroll, B, 4) for CartPole)."""
    import torch

    from ray_tpu_torch.rl.learner import _Adam, value_and_grad
    from ray_tpu_torch.rl.module import torch_forward

    gamma, lam = hyper["gamma"], hyper["lam"]
    clip, vf_c, ent_c = hyper["clip"], hyper["vf_coeff"], \
        hyper["entropy_coeff"]
    optimizer = _Adam(hyper["lr"], 0.5)

    def gae(rewards, values, dones, last_value):
        # reverse loop over the unroll, masked at episode boundaries —
        # the in-device twin of learner.compute_gae
        g = torch.zeros_like(last_value)
        next_v = last_value
        out = [None] * unroll
        for t in range(unroll - 1, -1, -1):
            nonterm = 1.0 - dones[t]
            delta = rewards[t] + gamma * next_v * nonterm - values[t]
            g = delta + gamma * lam * nonterm * g
            out[t] = g
            next_v = values[t]
        return torch.stack(out)

    def loss_fn(params, batch):
        logits, values = torch_forward(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, batch["actions"][:, None])[:, 0]
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["advantages"]
        surr = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
        pi_loss = -surr.mean()
        vf_loss = ((values - batch["value_targets"]) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(dim=1).mean()
        return pi_loss + vf_c * vf_loss - ent_c * entropy, \
            {"pi_loss": pi_loss, "vf_loss": vf_loss, "entropy": entropy}

    def step(params, opt_state, env_state, obs, draws):
        env_draw = draws["env"]
        traj = {k: [] for k in ("obs", "act", "logp", "val", "rew", "done",
                                "ret_sum", "ret_cnt")}
        with torch.no_grad():
            ep_ret = torch.zeros(obs.shape[0], device=obs.device)
            for t in range(unroll):
                logits, values = torch_forward(params, obs)
                action = (logits + draws["act"][t]).argmax(dim=-1)
                logp = torch.log_softmax(logits, dim=-1).gather(
                    1, action[:, None])[:, 0]
                env_state, next_obs, reward, done = env.step(
                    env_state, action,
                    env_draw if isinstance(env_draw, torch.Generator)
                    else env_draw[t])
                ep_ret = ep_ret + reward
                for k, v in (("obs", obs), ("act", action), ("logp", logp),
                             ("val", values), ("rew", reward),
                             ("done", done.float()),
                             ("ret_sum", torch.where(
                                 done, ep_ret, torch.zeros_like(ep_ret))),
                             ("ret_cnt", done.int())):
                    traj[k].append(v)
                ep_ret = torch.where(done, torch.zeros_like(ep_ret), ep_ret)
                obs = next_obs
            traj = {k: torch.stack(v) for k, v in traj.items()}
            _, last_v = torch_forward(params, obs)
            adv = gae(traj["rew"], traj["val"], traj["done"], last_v)
            targets = adv + traj["val"]
            a = adv.reshape(-1)
            flat = {
                "obs": traj["obs"].reshape((-1,) + traj["obs"].shape[2:]),
                "actions": traj["act"].reshape(-1),
                "logp_old": traj["logp"].reshape(-1),
                "advantages": (a - a.mean()) / (a.std(correction=0) + 1e-8),
                "value_targets": targets.reshape(-1),
            }
        aux = {}
        for _ in range(int(hyper["num_epochs"])):
            _, aux, grads = value_and_grad(loss_fn, params, flat)
            params, opt_state = optimizer.update(grads, opt_state, params)
        n_done = torch.clamp(traj["ret_cnt"].sum(), min=1)
        aux = dict(aux)
        aux["episode_return_mean"] = traj["ret_sum"].sum() / n_done
        aux["episodes_completed"] = traj["ret_cnt"].sum().float()
        return params, opt_state, env_state, obs, aux

    return step, optimizer


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def scale_out(algo, cfg: PodracerConfig):
    """Dispatch ``algo.scale_out(cfg)``: Sebulba returns a live
    :class:`SebulbaHandle` (acting already streaming); Anakin returns an
    :class:`Anakin` whose ``train(n)`` runs in-device updates."""
    if cfg.mode == "sebulba":
        return SebulbaHandle(algo, cfg)
    if cfg.mode == "anakin":
        return Anakin(algo, cfg)
    raise PodracerError(f"unknown podracer mode {cfg.mode!r} "
                        "(want 'sebulba' | 'anakin')")
