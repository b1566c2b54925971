"""Tuner + trial execution + ASHA (port of ``ray_tpu/tune/tuner.py``).

Reference: ``python/ray/tune/tuner.py:43`` (Tuner.fit),
``execution/tune_controller.py:68`` (trial event loop),
``schedulers/async_hyperband.py`` (ASHA). Trials are actors (same harness
shape as Train workers); the controller polls reports, applies the
scheduler's stop decisions, and backfills from the pending queue.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.tune.search import expand_param_space

# --------------------------------------------------------- trial harness

_trial_ctx = threading.local()


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Dict[str, Any]] = None) -> None:
    """Report metrics from inside a trial (reference ``tune.report``).
    ``checkpoint`` is a small state dict kept with the trial — PBT exploit
    clones it into other trials, and experiment restore resumes from it."""
    sink = getattr(_trial_ctx, "sink", None)
    if sink is None:
        raise RuntimeError("tune.report() called outside a trial")
    sink(metrics, checkpoint)


def get_checkpoint() -> Optional[Dict[str, Any]]:
    """Inside a trial: the checkpoint to resume from (None = fresh start).
    Set when PBT exploits another trial or the experiment was restored."""
    return getattr(_trial_ctx, "checkpoint", None)


class TrialActor:
    """Runs the trainable in a thread; controller polls for reports."""

    def __init__(self):
        self._reports: List[dict] = []
        self._lock = threading.Lock()
        self._status = "idle"
        self._error: Optional[str] = None

    def run(self, fn_blob: bytes, config: dict,
            checkpoint: Optional[dict] = None) -> bool:
        import cloudpickle

        fn = cloudpickle.loads(fn_blob)

        def sink(metrics, ckpt=None):
            with self._lock:
                self._reports.append((dict(metrics), ckpt))

        def target():
            _trial_ctx.sink = sink
            _trial_ctx.checkpoint = checkpoint
            try:
                out = fn(config)
                if isinstance(out, dict):
                    sink(out)
                self._status = "finished"
            except BaseException:  # noqa: BLE001
                self._error = traceback.format_exc()
                self._status = "error"
            finally:
                _trial_ctx.sink = None
                _trial_ctx.checkpoint = None

        self._status = "running"
        threading.Thread(target=target, daemon=True, name="trial").start()
        return True

    def poll(self):
        status, error = self._status, self._error
        with self._lock:
            reports, self._reports = self._reports, []
        return {"status": status, "error": error, "reports": reports}


# ------------------------------------------------------------ scheduler


@dataclasses.dataclass
class ASHAScheduler:
    """Async successive halving (reference ASHA): a trial reaching rung r
    must be in the top 1/reduction_factor of completed-rung trials to
    continue."""

    time_attr: str = "training_iteration"
    max_t: int = 100
    grace_period: int = 1
    reduction_factor: int = 3

    def __post_init__(self):
        self._rungs: List[int] = []
        t = self.grace_period
        while t < self.max_t:
            self._rungs.append(t)
            t *= self.reduction_factor
        # rung -> {trial_id: score}
        self._scores: Dict[int, Dict[int, float]] = {r: {}
                                                     for r in self._rungs}

    def on_result(self, trial_id: int, step: int, score: float) -> str:
        """Returns "continue" or "stop".

        Decisions are *retroactive*: every report re-checks the trial's
        recorded score at its highest reached rung against the rung's
        CURRENT population, so an early arrival at an empty rung (whose
        score looked fine against no competition) still gets cut once
        better trials fill the rung in.
        """
        decision = _rung_decision(self._rungs, self._scores, trial_id,
                                  step, score, self.reduction_factor)
        if decision == "stop":
            return "stop"
        return "stop" if step >= self.max_t else "continue"


def _rung_decision(rungs: List[int], scores: Dict[int, Dict[int, float]],
                   trial_id: int, step: int, score: float,
                   factor: int) -> str:
    """Successive-halving core shared by ASHA and HyperBand brackets:
    record the score at each rung crossed (milestone CROSSING, step >=
    rung, not equality — trainables may report non-consecutive
    iterations), then require the trial to sit in the top 1/factor of
    EVERY rung it has passed (checking only the newest rung would
    shield it while that rung is empty)."""
    for rung in rungs:
        if step >= rung and trial_id not in scores[rung]:
            scores[rung][trial_id] = score
    for rung in rungs:
        if rung > step or trial_id not in scores[rung]:
            continue
        population = scores[rung]
        k = max(1, math.ceil(len(population) / factor))
        cutoff = sorted(population.values(), reverse=True)[:k][-1]
        if population[trial_id] < cutoff:
            return "stop"
    return "continue"


@dataclasses.dataclass
class PopulationBasedTraining:
    """PBT (reference ``tune/schedulers/pbt.py``): at each perturbation
    interval, bottom-quantile trials EXPLOIT a top-quantile trial (copy its
    config + latest checkpoint) and EXPLORE (perturb each hyperparameter by
    a factor, or resample from the search space)."""

    time_attr: str = "training_iteration"
    perturbation_interval: int = 4
    quantile_fraction: float = 0.25
    perturbation_factors: tuple = (0.8, 1.2)
    resample_probability: float = 0.25
    # {name: Domain | list} — hyperparams PBT may mutate
    hyperparam_mutations: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    seed: int = 0

    def __post_init__(self):
        import numpy as np

        self._rng = np.random.default_rng(self.seed)
        self._last_perturb: Dict[int, int] = {}
        self._scores: Dict[int, float] = {}

    def on_result(self, trial_id: int, step: int, score: float) -> str:
        """"continue" or "exploit"; the controller then calls
        :meth:`exploit` for the clone instructions."""
        self._scores[trial_id] = score
        # Quantiles over a PARTIAL population mislead: before every trial
        # has reported, the "top quantile" can be another straggler and a
        # bad trial exploits a bad donor (then burns its perturbation
        # window). The controller tells us the population size; hold
        # exploits until the whole population has scores (reference PBT
        # quantiles run over all live trials).
        pop_size = getattr(self, "_population_size", 0)
        if pop_size and len(self._scores) < pop_size:
            return "continue"
        last = self._last_perturb.get(trial_id, 0)
        if step - last < self.perturbation_interval:
            return "continue"
        self._last_perturb[trial_id] = step
        pop = sorted(self._scores.items(), key=lambda kv: kv[1])
        k = max(1, int(len(pop) * self.quantile_fraction))
        if len(pop) < 2 * k:
            return "continue"
        # Quantile membership by SCORE, ties inclusive: with identity-based
        # membership two tied stragglers alternate at pop[0] as their
        # reports interleave and NEITHER ever exploits (each sees the other
        # as "the" bottom trial).
        bottom_cut = pop[k - 1][1]
        top_cut = pop[-k][1]
        if score > bottom_cut or bottom_cut >= top_cut:
            return "continue"  # not a straggler / degenerate flat population
        self._exploit_src = [tid for tid, _ in pop[-k:]]
        return "exploit"

    def exploit(self, trial_id: int, configs: Dict[int, dict]) -> tuple:
        """Returns (source_trial_id, explored_config)."""
        src_tid = int(self._rng.choice(self._exploit_src))
        new_config = self.explore(dict(configs[src_tid]))
        return src_tid, new_config

    def explore(self, config: dict) -> dict:
        from ray_tpu_torch.tune.search import Domain

        for name, domain in self.hyperparam_mutations.items():
            if self._rng.random() < self.resample_probability:
                if isinstance(domain, Domain):
                    config[name] = domain.sample(self._rng)
                else:
                    config[name] = domain[int(self._rng.integers(len(domain)))]
            elif isinstance(config.get(name), (int, float)) and \
                    not isinstance(config.get(name), bool):
                factor = self.perturbation_factors[
                    int(self._rng.integers(len(self.perturbation_factors)))]
                val = config[name] * factor
                config[name] = type(config[name])(val) \
                    if isinstance(config[name], int) else val
            elif isinstance(domain, (list, tuple)):
                config[name] = domain[int(self._rng.integers(len(domain)))]
        return config


@dataclasses.dataclass
class HyperBandScheduler:
    """HyperBand (reference ``tune/schedulers/hyperband.py``): several
    successive-halving brackets run side by side, each trading off
    "many trials, small budget" against "few trials, large budget" —
    the hedge ASHA gives up by fixing one grace period. Trials are
    assigned to brackets round-robin on first report; within a bracket
    a trial must place in the top 1/eta of its rung to continue."""

    time_attr: str = "training_iteration"
    max_t: int = 81
    eta: int = 3

    def __post_init__(self):
        # integer loop, not float log: int(math.log(243, 3)) == 4, which
        # would silently drop the most-exploratory bracket
        s_max = 0
        while self.eta ** (s_max + 1) <= self.max_t:
            s_max += 1
        # bracket s: first rung at max_t * eta^-s, halving every eta
        self._brackets: List[List[int]] = []
        for s in range(s_max, -1, -1):
            first = max(1, int(round(self.max_t * self.eta ** (-s))))
            rungs = []
            t = first
            while t < self.max_t:
                rungs.append(t)
                t *= self.eta
            self._brackets.append(rungs)
        # bracket -> rung -> {trial_id: score}
        self._scores: List[Dict[int, Dict[int, float]]] = [
            {r: {} for r in rungs} for rungs in self._brackets]
        self._assignment: Dict[int, int] = {}
        self._next_bracket = 0

    def _bracket_of(self, trial_id: int) -> int:
        b = self._assignment.get(trial_id)
        if b is None:
            b = self._next_bracket
            self._assignment[trial_id] = b
            self._next_bracket = (self._next_bracket + 1) % \
                len(self._brackets)
        return b

    def on_result(self, trial_id: int, step: int, score: float) -> str:
        b = self._bracket_of(trial_id)
        if _rung_decision(self._brackets[b], self._scores[b], trial_id,
                          step, score, self.eta) == "stop":
            return "stop"
        return "stop" if step >= self.max_t else "continue"


@dataclasses.dataclass
class MedianStoppingRule:
    """Median stopping (reference ``tune/schedulers/median_stopping_
    rule.py``, after Vizier): stop a trial whose best score so far is
    below the median of the other trials' running-average scores.
    Robust default when the rung geometry of ASHA/HyperBand doesn't fit
    the workload."""

    time_attr: str = "training_iteration"
    grace_period: int = 1
    min_samples_required: int = 3
    hard_stop: bool = True

    def __post_init__(self):
        # trial -> list of scores (running mean), trial -> best score
        self._history: Dict[int, List[float]] = {}
        self._best: Dict[int, float] = {}

    def on_result(self, trial_id: int, step: int, score: float) -> str:
        self._history.setdefault(trial_id, []).append(score)
        self._best[trial_id] = max(
            self._best.get(trial_id, float("-inf")), score)
        if step < self.grace_period:
            return "continue"
        means = [sum(h) / len(h) for tid, h in self._history.items()
                 if tid != trial_id and h]
        if len(means) < self.min_samples_required:
            return "continue"
        import statistics

        if self._best[trial_id] < statistics.median(means):
            return "stop" if self.hard_stop else "continue"
        return "continue"


# ---------------------------------------------------------------- tuner


@dataclasses.dataclass
class TuneConfig:
    metric: str = "score"
    mode: str = "max"                  # "max" | "min"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Optional[Any] = None     # ASHAScheduler | HyperBand | PBT | ...
    search_alg: Optional[Any] = None    # search_algo.Searcher (None = random)
    seed: int = 0


@dataclasses.dataclass
class Result:
    config: Dict[str, Any]
    metrics: Dict[str, Any]
    error: Optional[str] = None


class ResultGrid:
    def __init__(self, results: List[Result], metric: str, mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __iter__(self):
        return iter(self._results)

    def get_best_result(self) -> Result:
        ok = [r for r in self._results
              if r.error is None and self._metric in r.metrics]
        if not ok:
            raise RuntimeError("no successful trials")
        sign = 1 if self._mode == "max" else -1
        return max(ok, key=lambda r: sign * r.metrics[self._metric])

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([
            {**r.config, **r.metrics,
             "error": bool(r.error)} for r in self._results])


def _trainer_trainable(trainer) -> Callable[[dict], Any]:
    """Reference ``Tuner(trainer)``: a Trainer instance (the port's
    JaxTrainer / TorchTrainer — anything with ``.fit()`` and a ``config`` dict) as the
    trainable. Each trial shallow-copies the trainer, merges the trial's
    sampled config into ``train_loop_config`` (a nested
    ``train_loop_config`` dict in the sample merges as that subdict;
    flat keys merge directly), runs ``fit()``, and reports the run's
    final metrics once — trial-level early-stopping schedulers see one
    report per trial."""
    import copy

    def run(config):
        from ray_tpu_torch import tune as _tune

        sampled = dict(config)
        nested = sampled.pop("train_loop_config", None)
        merged = dict(getattr(trainer, "config", None) or {})
        if isinstance(nested, dict):
            merged.update(nested)
        merged.update(sampled)
        t = copy.copy(trainer)
        t.config = merged
        result = t.fit()
        metrics = dict(getattr(result, "metrics", None) or {})
        if metrics:
            _tune.report(metrics)

    return run


class Tuner:
    def __init__(self, trainable: Callable[[dict], Any], *,
                 param_space: Dict[str, Any],
                 tune_config: Optional[TuneConfig] = None,
                 storage_path: Optional[str] = None):
        if not callable(trainable) and hasattr(trainable, "fit"):
            trainable = _trainer_trainable(trainable)
        self._trainable = trainable
        self._space = param_space
        self._cfg = tune_config or TuneConfig()
        self._storage_path = storage_path
        self._restored: Optional[dict] = None

    @classmethod
    def restore(cls, storage_path: str,
                trainable: Callable[[dict], Any]) -> "Tuner":
        """Resume an interrupted experiment (reference ``Tuner.restore``):
        completed trials keep their results; unfinished trials re-run from
        their last reported checkpoint."""
        import pickle

        with open(os.path.join(storage_path, "experiment_state.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        tuner = cls(trainable, param_space=state["param_space"],
                    tune_config=state["tune_config"],
                    storage_path=storage_path)
        tuner._restored = state
        return tuner

    def _save_experiment(self, configs, results, steps, checkpoints,
                         last_metrics):
        if self._storage_path is None:
            return
        import pickle

        os.makedirs(self._storage_path, exist_ok=True)
        tmp = os.path.join(self._storage_path, ".experiment_state.tmp")
        with open(tmp, "wb") as f:
            pickle.dump({
                "param_space": self._space,
                "tune_config": self._cfg,
                "configs": configs,
                "results": {tid: (r.config, r.metrics, r.error)
                            for tid, r in results.items()},
                "steps": dict(steps),
                "checkpoints": dict(checkpoints),
                "last_metrics": dict(last_metrics),
            }, f)
        os.replace(tmp, os.path.join(self._storage_path,
                                     "experiment_state.pkl"))

    def fit(self, timeout_s: float = 600.0) -> ResultGrid:
        import cloudpickle

        import ray_tpu_torch as rt

        cfg = self._cfg
        fn_blob = cloudpickle.dumps(self._trainable)
        remote_cls = rt.remote(TrialActor)
        sign = 1 if cfg.mode == "max" else -1

        results: Dict[int, Result] = {}
        steps: Dict[int, int] = {}
        last_metrics: Dict[int, dict] = {}
        checkpoints: Dict[int, Optional[dict]] = {}
        if self._restored is not None:
            st = self._restored
            configs = st["configs"]
            for tid, (rconf, rmet, rerr) in st["results"].items():
                if rerr is None:  # completed trials stay done
                    results[tid] = Result(rconf, rmet)
            steps.update(st["steps"])
            checkpoints.update(st["checkpoints"])
            last_metrics.update(st["last_metrics"])
            pending = [(tid, configs[tid]) for tid in sorted(configs)
                       if tid not in results]
            if cfg.search_alg is not None:
                # re-arm the searcher: replay completed-trial feedback
                # (model-based searchers refit from it) and leave budget
                # for the suggestions the interrupted run never made
                cfg.search_alg.setup(self._space, cfg.metric, cfg.mode)
                for tid, res in results.items():
                    try:
                        cfg.search_alg.on_trial_complete(
                            tid, res.metrics, res.error)
                    except Exception:  # noqa: BLE001
                        pass
        elif cfg.search_alg is not None:
            # searcher-driven: configs are suggested LAZILY at launch so
            # adaptive algorithms see completed-trial feedback first
            cfg.search_alg.setup(self._space, cfg.metric, cfg.mode)
            configs = {}
            pending = []
        else:
            configs = dict(enumerate(
                expand_param_space(self._space, cfg.num_samples, cfg.seed)))
            pending = sorted(configs.items())
        running: Dict[int, dict] = {}   # trial_id -> {actor, config}
        if cfg.scheduler is not None and configs:
            # population-aware schedulers (PBT) gate decisions on full
            # population coverage
            cfg.scheduler._population_size = len(configs)
        if cfg.search_alg is None:
            suggest_budget = 0
        else:  # fresh run: all of num_samples; restore: the unsuggested rest
            suggest_budget = max(0, cfg.num_samples - len(configs))
        deadline = time.monotonic() + timeout_s

        def launch() -> int:
            nonlocal suggest_budget
            while suggest_budget > 0 and \
                    len(pending) + len(running) < cfg.max_concurrent_trials:
                tid = len(configs)
                config = cfg.search_alg.suggest(tid)
                configs[tid] = config
                pending.append((tid, config))
                suggest_budget -= 1
            # start the whole wave in parallel: sequential worker spawn
            # (~0.5s each) would stagger trials against the poll loop
            started = []
            while pending and len(running) < cfg.max_concurrent_trials:
                tid, config = pending.pop(0)
                actor = remote_cls.remote()
                started.append(actor.run.remote(
                    fn_blob, config, checkpoints.get(tid)))
                running[tid] = {"actor": actor, "config": config}
                steps.setdefault(tid, 0)
            if started:
                rt.get(started)
            return len(started)

        def finish(tid, error=None):
            tr = running.pop(tid)
            results[tid] = Result(tr["config"], last_metrics.get(tid, {}),
                                  error=error)
            if cfg.search_alg is not None:
                try:
                    cfg.search_alg.on_trial_complete(
                        tid, last_metrics.get(tid), error)
                except Exception:  # noqa: BLE001 — searcher bug must not
                    pass           # kill the experiment loop
            try:
                rt.kill(tr["actor"])
            except Exception:  # noqa: BLE001
                pass

        launch()
        while running:
            if time.monotonic() > deadline:
                for tid in list(running):
                    finish(tid, error="tune timeout")
                break
            time.sleep(0.05)
            dirty = False
            for tid in list(running):
                tr = running[tid]
                try:
                    st = rt.get([tr["actor"].poll.remote()],
                                     timeout=30.0)[0]
                except Exception as e:  # noqa: BLE001 — trial actor died
                    finish(tid, error=f"trial actor died: {e}")
                    dirty = True
                    continue
                decision = "continue"
                if st["reports"]:
                    dirty = True
                for rep in st["reports"]:
                    rep, ckpt = rep if isinstance(rep, tuple) else (rep, None)
                    steps[tid] += 1
                    rep.setdefault("training_iteration", steps[tid])
                    last_metrics[tid] = rep
                    if ckpt is not None:
                        checkpoints[tid] = ckpt
                    if cfg.scheduler and cfg.metric in rep:
                        decision = cfg.scheduler.on_result(
                            tid, rep["training_iteration"],
                            sign * rep[cfg.metric])
                        if decision != "continue":
                            break  # later reports are past the decision
                if decision == "exploit" and st["status"] != "running":
                    # the trainable already returned: there is nothing to
                    # relaunch — exploiting would re-run the whole function
                    decision = "continue"
                if decision == "stop":
                    finish(tid)
                elif decision == "exploit":
                    # PBT: clone a top trial's config+checkpoint, explore,
                    # and relaunch this trial in-place (same trial id).
                    all_configs = {t: r["config"]
                                   for t, r in running.items()}
                    all_configs.update(
                        {t: results[t].config for t in results})
                    all_configs[tid] = tr["config"]
                    src_tid, new_config = cfg.scheduler.exploit(
                        tid, all_configs)
                    src_ckpt = checkpoints.get(src_tid)
                    try:
                        rt.kill(tr["actor"])
                    except Exception:  # noqa: BLE001
                        pass
                    actor = remote_cls.remote()
                    rt.get([actor.run.remote(
                        fn_blob, new_config, src_ckpt)])
                    running[tid] = {"actor": actor, "config": new_config}
                    configs[tid] = new_config
                    if src_ckpt is not None:
                        checkpoints[tid] = src_ckpt
                elif st["status"] == "finished":
                    finish(tid)
                    dirty = True
                elif st["status"] == "error":
                    finish(tid, error=st["error"])
                    dirty = True
            if launch():
                dirty = True
            if dirty:  # ~20 Hz poll loop: only persist actual progress
                self._save_experiment(configs, results, steps, checkpoints,
                                      last_metrics)

        self._save_experiment(configs, results, steps, checkpoints,
                              last_metrics)
        ordered = [results[tid] for tid in sorted(results)]
        return ResultGrid(ordered, cfg.metric, cfg.mode)
