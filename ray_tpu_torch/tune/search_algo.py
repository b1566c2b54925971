"""Pluggable search algorithms (port of ``ray_tpu/tune/search_algo.py``;
reference: ``python/ray/tune/search/``
— Searcher base class + adapters for optuna/hyperopt/etc.).

A Searcher proposes configs one trial at a time and receives completion
feedback, which is what lets model-based methods (TPE, GP) adapt. The
Tuner consults ``TuneConfig.search_alg`` lazily at launch time, so a
suggestion made after N completions has seen all N results.

Shipped searchers:

- :class:`HaltonSearch` — native, dependency-free quasi-random search.
  Scrambled Halton points cover the space far more evenly than iid
  sampling at small budgets (the common tune regime), and need no
  fitting step.
- :class:`OptunaSearch` — adapter to the optuna TPE sampler, gated on
  the optional dependency (raises a clear ImportError when absent,
  matching the reference's optional-integration pattern).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

from ray_tpu_torch.tune.search import Domain, GridSearch


class Searcher:
    """Interface consumed by the Tuner."""

    def setup(self, space: Dict[str, Any], metric: str, mode: str) -> None:
        self._space = space
        self._metric = metric
        self._mode = mode

    def suggest(self, trial_id: int) -> Dict[str, Any]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: int,
                          metrics: Optional[Dict[str, Any]],
                          error: Optional[str] = None) -> None:
        """Feedback hook; default no-op for non-adaptive searchers."""


def _primes(n: int):
    out, c = [], 2
    while len(out) < n:
        if all(c % p for p in out):
            out.append(c)
        c += 1
    return out


def _halton(index: int, base: int) -> float:
    f, r = 1.0, 0.0
    i = index
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


class HaltonSearch(Searcher):
    """Quasi-random (low-discrepancy) search over the Domain-typed
    dimensions of the space; non-Domain values pass through fixed,
    GridSearch dimensions cycle."""

    def __init__(self, seed: int = 0):
        self._seed = seed

    def setup(self, space, metric, mode):
        super().setup(space, metric, mode)
        self._dims = [k for k, v in space.items() if isinstance(v, Domain)]
        self._bases = _primes(max(1, len(self._dims)))

    def _unit_to_domain(self, u: float, d: Domain):
        if d.kind == "uniform":
            lo, hi = d.args
            return lo + u * (hi - lo)
        if d.kind == "loguniform":
            lo, hi = d.args
            return math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        if d.kind == "randint":
            lo, hi = d.args
            # floor, not int(): int() truncates toward zero, which for
            # lo < 0 double-weights 0 and can never emit lo
            return min(hi - 1, math.floor(lo + u * (hi - lo)))
        if d.kind == "choice":
            opts = d.args[0]
            return opts[min(len(opts) - 1, int(u * len(opts)))]
        raise ValueError(f"unknown domain kind {d.kind!r}")

    def suggest(self, trial_id: int) -> Dict[str, Any]:
        # index offset by seed: different seeds give shifted sequences
        idx = trial_id + 1 + self._seed * 7919
        config = {}
        for k, v in self._space.items():
            if isinstance(v, Domain):
                base = self._bases[self._dims.index(k)]
                config[k] = self._unit_to_domain(_halton(idx, base), v)
            elif isinstance(v, GridSearch):
                config[k] = v.values[trial_id % len(v.values)]
            else:
                config[k] = v
        return config


class TPESearch(Searcher):
    """Native, dependency-free Tree-structured Parzen Estimator
    (reference role: ``tune/search/bohb`` — BOHB's model; pairing this
    with the HyperBand scheduler reproduces BOHB's search behavior, and
    unlike :class:`OptunaSearch` it needs no optional dependency).

    After ``n_initial`` quasi-random points, completed trials split into
    good/bad by the ``gamma`` quantile of the objective; each dimension
    gets a 1-D Parzen model per side (Gaussian KDE for continuous —
    log-space for loguniform — and smoothed counts for categorical).
    ``n_candidates`` configs are sampled from the good model and the one
    maximizing the density ratio l(x)/g(x) is suggested."""

    def __init__(self, seed: int = 0, n_initial: int = 10,
                 gamma: float = 0.25, n_candidates: int = 24):
        self._seed = seed
        self._n_initial = n_initial
        self._gamma = gamma
        self._n_candidates = n_candidates

    def setup(self, space, metric, mode):
        import numpy as np

        super().setup(space, metric, mode)
        self._rng = np.random.default_rng(self._seed)
        self._halton = HaltonSearch(seed=self._seed)
        self._halton.setup(space, metric, mode)
        self._configs: Dict[int, Dict[str, Any]] = {}
        self._obs: list = []  # (config, score) — score always MAXIMIZED

    # ---------------------------------------------------------- dimensions
    def _to_unit(self, v, d: Domain) -> float:
        """Map a value into the model's working space (continuous dims)."""
        if d.kind == "uniform":
            lo, hi = d.args
            return (v - lo) / (hi - lo)
        if d.kind == "loguniform":
            lo, hi = d.args
            return ((math.log(v) - math.log(lo))
                    / (math.log(hi) - math.log(lo)))
        if d.kind == "randint":
            lo, hi = d.args
            return (v - lo) / max(1, hi - lo)
        raise ValueError(d.kind)

    def _from_unit(self, u: float, d: Domain):
        u = min(1.0, max(0.0, u))
        if d.kind == "uniform":
            lo, hi = d.args
            return lo + u * (hi - lo)
        if d.kind == "loguniform":
            lo, hi = d.args
            return math.exp(math.log(lo)
                            + u * (math.log(hi) - math.log(lo)))
        if d.kind == "randint":
            lo, hi = d.args
            return min(hi - 1, math.floor(lo + u * (hi - lo)))
        raise ValueError(d.kind)

    @staticmethod
    def _kde_logdensity(x: float, pts, bw: float) -> float:
        import numpy as np

        pts = np.asarray(pts)
        z = (x - pts) / bw
        return float(np.log(np.mean(np.exp(-0.5 * z * z)) + 1e-12))

    def _split(self):
        import numpy as np

        scores = np.asarray([s for _, s in self._obs])
        n_good = max(1, int(math.ceil(self._gamma * len(scores))))
        order = np.argsort(-scores)  # descending: best first
        good = [self._obs[i][0] for i in order[:n_good]]
        bad = [self._obs[i][0] for i in order[n_good:]] or good
        return good, bad

    def suggest(self, trial_id: int) -> Dict[str, Any]:
        import numpy as np

        if len(self._obs) < self._n_initial:
            config = self._halton.suggest(trial_id)
            self._configs[trial_id] = config
            return config
        good, bad = self._split()
        best_cfg, best_ratio = None, -math.inf
        for _ in range(self._n_candidates):
            cfg, log_ratio = {}, 0.0
            for k, v in self._space.items():
                if isinstance(v, Domain) and v.kind == "choice":
                    opts = list(v.args[0])
                    # smoothed categorical Parzen per side
                    def probs(obs_list):
                        c = np.ones(len(opts))
                        for o in obs_list:
                            c[opts.index(o[k])] += 1.0
                        return c / c.sum()

                    pg, pb = probs(good), probs(bad)
                    i = int(self._rng.choice(len(opts), p=pg))
                    cfg[k] = opts[i]
                    log_ratio += math.log(pg[i]) - math.log(pb[i])
                elif isinstance(v, Domain):
                    g_pts = [self._to_unit(o[k], v) for o in good]
                    b_pts = [self._to_unit(o[k], v) for o in bad]
                    # Silverman bandwidth with a floor: tiny good sets
                    # must still explore
                    bw = max(0.08, 1.06 * (np.std(g_pts) + 1e-3)
                             * len(g_pts) ** -0.2)
                    u = float(self._rng.choice(g_pts)
                              + self._rng.normal(0.0, bw))
                    u = min(1.0, max(0.0, u))
                    cfg[k] = self._from_unit(u, v)
                    log_ratio += (self._kde_logdensity(u, g_pts, bw)
                                  - self._kde_logdensity(u, b_pts, bw))
                elif isinstance(v, GridSearch):
                    cfg[k] = v.values[trial_id % len(v.values)]
                else:
                    cfg[k] = v
            if log_ratio > best_ratio:
                best_cfg, best_ratio = cfg, log_ratio
        self._configs[trial_id] = best_cfg
        return best_cfg

    def on_trial_complete(self, trial_id, metrics, error=None):
        config = self._configs.pop(trial_id, None)
        if config is None or error is not None or not metrics \
                or self._metric not in metrics:
            return
        score = float(metrics[self._metric])
        if self._mode == "min":
            score = -score
        self._obs.append((config, score))


class OptunaSearch(Searcher):
    """Adapter to optuna's TPE (reference: ``tune/search/optuna``).
    Optional dependency: constructing this without optuna installed
    raises ImportError immediately, not at first suggest."""

    def __init__(self, seed: int = 0):
        try:
            import optuna  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "OptunaSearch requires the 'optuna' package, which is not "
                "installed in this environment; use HaltonSearch or the "
                "built-in random/grid search instead") from e
        self._seed = seed
        self._trials: Dict[int, Any] = {}

    def setup(self, space, metric, mode):
        import optuna

        super().setup(space, metric, mode)
        optuna.logging.set_verbosity(optuna.logging.WARNING)
        self._study = optuna.create_study(
            direction="maximize" if mode == "max" else "minimize",
            sampler=optuna.samplers.TPESampler(seed=self._seed))

    def _ask(self, trial) -> Dict[str, Any]:
        config = {}
        for k, v in self._space.items():
            if isinstance(v, Domain):
                if v.kind == "uniform":
                    config[k] = trial.suggest_float(k, *v.args)
                elif v.kind == "loguniform":
                    config[k] = trial.suggest_float(k, *v.args, log=True)
                elif v.kind == "randint":
                    config[k] = trial.suggest_int(k, v.args[0], v.args[1] - 1)
                elif v.kind == "choice":
                    config[k] = trial.suggest_categorical(k, v.args[0])
            elif isinstance(v, GridSearch):
                config[k] = trial.suggest_categorical(k, v.values)
            else:
                config[k] = v
        return config

    def suggest(self, trial_id: int) -> Dict[str, Any]:
        trial = self._study.ask()
        self._trials[trial_id] = trial
        return self._ask(trial)

    def on_trial_complete(self, trial_id, metrics, error=None):
        trial = self._trials.pop(trial_id, None)
        if trial is None:
            return
        if error is not None or not metrics or self._metric not in metrics:
            self._study.tell(trial, state=__import__(
                "optuna").trial.TrialState.FAIL)
            return
        self._study.tell(trial, metrics[self._metric])
