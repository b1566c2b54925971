"""Models of the port: the Llama, MoE and ViT families with their training
step, the paged and slot KV caches, and conversion of JAX parameter
trees."""

from ray_tpu_torch.models import llama, moe, vit  # noqa: F401
from ray_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    forward,
    init_params,
    loss_fn,
    param_logical_axes,
)
from ray_tpu_torch.models.vit import ViTConfig  # noqa: F401
