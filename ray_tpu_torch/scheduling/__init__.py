from .cluster_state import ClusterView, NodeEntry  # noqa: F401
from . import policies  # noqa: F401
