"""LLM batch + serving entry points (port of ``ray_tpu/llm``).

Reference: ``python/ray/llm/`` — ``ray.data.llm`` batch processors and
``ray.serve.llm`` deployments. Serving lives in ``ray_tpu_torch.serve.llm``
(native continuous-batching engine); this package hosts the DATA side:
offline batch inference pipelines over ``ray_tpu_torch.data`` datasets.
"""

from .batch import (ByteTokenizer, ProcessorConfig, build_llm_processor)

__all__ = ["ByteTokenizer", "ProcessorConfig", "build_llm_processor"]

from ray_tpu_torch.util.usage import record_library_usage as _record_usage
_record_usage("llm")
del _record_usage
