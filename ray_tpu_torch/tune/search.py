"""Search-space primitives (port of ``ray_tpu/tune/search.py``, numpy only;
reference ``python/ray/tune/search/sample.py``
+ grid_search)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np


@dataclasses.dataclass
class Domain:
    kind: str
    args: tuple

    def sample(self, rng: np.random.Generator):
        if self.kind == "uniform":
            lo, hi = self.args
            return float(rng.uniform(lo, hi))
        if self.kind == "loguniform":
            lo, hi = self.args
            return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        if self.kind == "randint":
            lo, hi = self.args
            return int(rng.integers(lo, hi))
        if self.kind == "choice":
            options = self.args[0]
            return options[int(rng.integers(len(options)))]
        raise ValueError(self.kind)


def uniform(lower: float, upper: float) -> Domain:
    return Domain("uniform", (lower, upper))


def loguniform(lower: float, upper: float) -> Domain:
    return Domain("loguniform", (lower, upper))


def randint(lower: int, upper: int) -> Domain:
    return Domain("randint", (lower, upper))


def choice(options: List[Any]) -> Domain:
    return Domain("choice", (list(options),))


@dataclasses.dataclass
class GridSearch:
    values: List[Any]


def grid_search(values: List[Any]) -> GridSearch:
    return GridSearch(list(values))


def expand_param_space(space: Dict[str, Any], num_samples: int,
                       seed: int = 0) -> List[Dict[str, Any]]:
    """Cross-product of grid axes × num_samples draws of random domains."""
    grids = {k: v.values for k, v in space.items()
             if isinstance(v, GridSearch)}
    configs: List[Dict[str, Any]] = [{}]
    for key, values in grids.items():
        configs = [dict(c, **{key: v}) for c in configs for v in values]

    rng = np.random.default_rng(seed)
    out: List[Dict[str, Any]] = []
    for _ in range(max(num_samples, 1)):
        for base in configs:
            cfg = dict(base)
            for k, v in space.items():
                if isinstance(v, GridSearch):
                    continue
                cfg[k] = v.sample(rng) if isinstance(v, Domain) else v
            out.append(cfg)
    return out
