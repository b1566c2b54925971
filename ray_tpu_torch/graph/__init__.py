"""Compiled graphs — static actor DAGs (reference: ``python/ray/dag/``).

``.bind()`` on remote functions/classes/actor methods builds a DAG;
``experimental_compile()`` freezes it into a reusable execution plan
(actors instantiated once, schedule topo-sorted once, argument wiring
precomputed). On a GPU the heavy lifting *inside* each stage is the
stage's own PyTorch and CUDA work; the graph layer's job is stage
orchestration — e.g. pipeline-parallel stages as a chain of GPU actors
fed over device channels (``models/pipeline.py``).
"""

from ray_tpu_torch.graph.dag import (  # noqa: F401
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.graph.compiled import CompiledDAG  # noqa: F401
from ray_tpu_torch.graph.collective_node import (  # noqa: F401
    CollectiveOutputNode,
    allreduce,
)

from ray_tpu_torch.util.usage import record_library_usage as _record_usage
_record_usage("graph")
del _record_usage
