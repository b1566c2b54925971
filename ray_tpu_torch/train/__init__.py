"""Train library — Train-v2-shaped distributed training on GPUs (port of
``ray_tpu/train``).

Reference architecture (reference ``python/ray/train/v2/``): controller
state-machine loop + gang-scheduled worker group + scaling / failure
policies + checkpoint manager. Rank 0 publishes a coordinator address in
its worker's context and every worker joins one ``torch.distributed``
process group (``TrainContext.init_jax_distributed``: NCCL on GPU
workers), after which the mesh and DTensor carry the parallelism
(:mod:`ray_tpu_torch.parallel`). ``JaxTrainer(pipeline_spec=)`` trains
MPMD instead: resident stage actors on shm channel hops
(:mod:`ray_tpu_torch.train.pipeline`).
"""

from ray_tpu_torch.train.checkpoint import (  # noqa: F401
    Checkpoint,
    CheckpointConfig,
    CheckpointManager,
)
from ray_tpu_torch.train.collectives import (  # noqa: F401
    FlatOptimizer,
    ZeroShardedOptimizer,
    barrier,
    broadcast_from_rank_zero,
)
from ray_tpu_torch.train.context import (  # noqa: F401
    TrainContext,
    checkpoint_dir,
    get_context,
    get_dataset_shard,
    report,
)
from ray_tpu_torch.train.pipeline import (  # noqa: F401
    PipelineRunner,
    PipelineSpec,
    StageSpec,
)
from ray_tpu_torch.train.scaling_policy import (  # noqa: F401
    ElasticScalingPolicy,
    FixedScalingPolicy,
)
from ray_tpu_torch.train.torch_trainer import (  # noqa: F401
    TorchTrainer,
    prepare_data_loader,
    prepare_model,
)
from ray_tpu_torch.train.trainer import (  # noqa: F401
    FailureConfig,
    JaxTrainer,
    Result,
    RunConfig,
    ScalingConfig,
    TrainingFailedError,
)

from ray_tpu_torch.util.usage import record_library_usage as _record_usage
_record_usage("train")
del _record_usage
