"""Tune library — hyperparameter search (port of ``ray_tpu/tune``; reference
``python/ray/tune/``).

Thin but real: Tuner drives trial actors with a concurrency cap, grid /
random search spaces, ASHA early stopping, and a ResultGrid. Trials report
through the same worker harness the Train library uses.
"""

from ray_tpu_torch.tune.search import (  # noqa: F401
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.search_algo import (  # noqa: F401
    HaltonSearch,
    OptunaSearch,
    TPESearch,
    Searcher,
)
from ray_tpu_torch.tune.tuner import (  # noqa: F401
    ASHAScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    Result,
    ResultGrid,
    TuneConfig,
    Tuner,
    get_checkpoint,
    report,
)

from ray_tpu_torch.util.usage import record_library_usage as _record_usage
_record_usage("tune")
del _record_usage
