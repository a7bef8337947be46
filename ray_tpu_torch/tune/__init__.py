"""ray_tpu_torch.tune — hyperparameter search over trial actors.

Public surface mirrors ``ray.tune``: Tuner/run, search spaces, searchers,
schedulers (ASHA/PBT/median-stopping), report/get_checkpoint shared with
ray_tpu_torch.train (the reference unified these under ray.train in 2.x).

The port's copy of ``ray_tpu/tune/__init__.py``.
"""

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import get_checkpoint, get_context, report
from ray_tpu_torch.tune.experiment import Trial, TrialStatus
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    ConcurrencyLimiter,
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner, run

__all__ = [
    "Tuner",
    "TuneConfig",
    "ResultGrid",
    "run",
    "report",
    "get_context",
    "get_checkpoint",
    "Checkpoint",
    "Trial",
    "TrialStatus",
    "TrialScheduler",
    "FIFOScheduler",
    "ASHAScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "Searcher",
    "BasicVariantGenerator",
    "TPESearcher",
    "ConcurrencyLimiter",
    "HyperBandScheduler",
    "uniform",
    "loguniform",
    "quniform",
    "randint",
    "randn",
    "choice",
    "grid_search",
    "sample_from",
]
