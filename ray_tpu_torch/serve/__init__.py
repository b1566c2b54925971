"""Serve library of the port: model serving on GPU replicas.

The same architecture as the JAX package's Serve (reference
``python/ray/serve/``): a controller reconciles target application and
deployment state into replica actors; handles route requests with
power-of-two-choices (or prefix-aware) routing; an HTTP proxy serves JSON
and SSE; ``@serve.batch`` coalesces requests and ``@serve.multiplexed``
time-shares models on a replica. A replica whose ``ray_actor_options``
has ``num_gpus`` holds a GPU lease (a fresh worker with
``CUDA_VISIBLE_DEVICES`` set), and the LLM path
(:mod:`ray_tpu_torch.serve.llm`) does continuous batching over the CUDA
decode kernels.
"""

from ray_tpu_torch.serve.api import (  # noqa: F401
    delete,
    deploy_config,
    deployment,
    get_declarative_config,
    get_deployment_handle,
    proxy_address,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.batching import batch  # noqa: F401
from ray_tpu_torch.serve.handle import DeploymentHandle  # noqa: F401
from ray_tpu_torch.serve.multiplex import (  # noqa: F401
    get_multiplexed_model_id,
    multiplexed,
)
from ray_tpu_torch.serve.proxy import Request, Response  # noqa: F401

from ray_tpu_torch.util.usage import record_library_usage as _record_usage
_record_usage("serve")
del _record_usage
