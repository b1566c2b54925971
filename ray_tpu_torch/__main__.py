"""``python -m ray_tpu_torch``: the JAX package's CLI (``start``, ``stop``,
``status``, jobs) is a later slice of the port."""

from ray_tpu_torch.common.status import not_ported

raise not_ported("cli")
