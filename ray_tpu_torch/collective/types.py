"""Collective types (reference: python/ray/util/collective/types.py)."""

from __future__ import annotations

import enum


class Backend(str, enum.Enum):
    XLA = "xla"    # in-program collectives; NCCL on the GPU (xla_group.py)
    KV = "kv"      # GCS-KV transport between host processes (gloo's role)

    @classmethod
    def parse(cls, name: str) -> "Backend":
        if name.lower() == "nccl":
            return cls.XLA  # the role NCCL plays on the GPU
        try:
            return cls(name.lower())
        except ValueError:
            if name.lower() in ("gloo", "torch_gloo", "mpi"):
                raise ValueError(
                    f"backend {name!r} is CPU-cluster specific to the "
                    f"reference framework; use 'kv'")
            raise ValueError(f"unrecognized backend {name!r}")


class ReduceOp(enum.Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3


NUMPY_REDUCERS = {
    ReduceOp.SUM: "add",
    ReduceOp.PRODUCT: "multiply",
    ReduceOp.MIN: "minimum",
    ReduceOp.MAX: "maximum",
}

TORCH_REDUCERS = {
    ReduceOp.SUM: "add",
    ReduceOp.PRODUCT: "mul",
    ReduceOp.MIN: "minimum",
    ReduceOp.MAX: "maximum",
}
