from .reference import ObjectRef  # noqa: F401
