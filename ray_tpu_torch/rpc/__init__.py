from .rpc import RpcClient, RpcError, RpcServer, RetryableRpcClient  # noqa: F401
from .chaos import maybe_inject_failure, RpcChaosError  # noqa: F401
