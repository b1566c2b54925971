"""Tiny important-by-name Serve app used by the declarative-deploy tests
and as the ``import_path`` reference example (reference: the
``fruit.py``/``conditional_dag.py`` example apps the reference's serve
CLI docs deploy by import path).
"""

from __future__ import annotations

from ray_tpu_torch.serve.deployment import make_deployment


@make_deployment
class Echo:
    """Echoes its input, tagged with the configured prefix."""

    def __init__(self, prefix: str = "echo"):
        self.prefix = prefix

    def __call__(self, value="?"):
        return f"{self.prefix}:{value}"


# a ready-bound Application (import_path "...:app")
app = Echo.bind("echo")


def build_app(prefix: str = "built"):
    """Builder-function form (import_path "...:build_app" with args)."""
    return Echo.bind(prefix)
