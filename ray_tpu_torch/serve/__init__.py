"""Serving of the port: the continuous-batching LLM engine
(``serve/llm.py``). The Serve control plane, handles and proxy of the JAX
package's ``serve`` (``run``, ``deployment``, ...) are a later slice and
refuse with their ROADMAP item."""

_WAITING = {"delete", "deploy_config", "deployment", "get_declarative_config",
            "get_deployment_handle", "proxy_address", "run", "shutdown",
            "start", "status", "batch", "DeploymentHandle",
            "get_multiplexed_model_id", "multiplexed", "Request", "Response"}


def __getattr__(name):
    if name in _WAITING:
        from ray_tpu_torch.common.status import not_ported

        raise not_ported("serve")
    raise AttributeError(
        f"module 'ray_tpu_torch.serve' has no attribute {name!r}")
