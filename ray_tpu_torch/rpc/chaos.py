"""RPC fault injection.

Equivalent of the reference's rpc chaos hooks (src/ray/rpc/rpc_chaos.cc:30-49,
flag RAY_testing_rpc_failure in ray_config_def.h:845): a config string of the
form ``"Method1=0.2,Method2=0.05"`` makes the named RPC methods fail with the
given probability, on either the request or the response side.  Deterministic
under ``testing_rpc_failure_seed``.  This exists so every layer above RPC can
be chaos-tested from day one.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, Optional, Tuple

from ray_tpu_torch.common.config import GLOBAL_CONFIG
from ray_tpu_torch.common.status import RtConnectionError


class RpcChaosError(RtConnectionError):
    """Injected failure, distinguishable from real network errors in tests."""


class _ChaosState:
    def __init__(self):
        self._lock = threading.Lock()
        self._parsed_from: Optional[str] = None
        self._probs: Dict[str, float] = {}
        self._rng = random.Random()

    def _refresh(self):
        spec = GLOBAL_CONFIG.get("testing_rpc_failure")
        if spec == self._parsed_from:
            return
        probs: Dict[str, float] = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            method, _, prob = part.partition("=")
            probs[method.strip()] = float(prob or 1.0)
        self._probs = probs
        self._parsed_from = spec
        seed = GLOBAL_CONFIG.get("testing_rpc_failure_seed")
        if seed:
            self._rng = random.Random(seed)

    def roll(self, method: str) -> Tuple[bool, bool]:
        """Returns (fail_request, fail_response)."""
        with self._lock:
            self._refresh()
            if not self._probs:
                return False, False
            p = self._probs.get(method, self._probs.get("*", 0.0))
            if p <= 0.0:
                return False, False
            if self._rng.random() < p:
                # Reference fails request vs response with equal chance: a
                # request-side failure means the server never saw it, a
                # response-side failure means it executed but the caller
                # doesn't know — exercising both idempotency paths.
                return (True, False) if self._rng.random() < 0.5 else (False, True)
            return False, False


_STATE = _ChaosState()


def maybe_inject_failure(method: str) -> Tuple[bool, bool]:
    return _STATE.roll(method)


def reset():
    global _STATE
    _STATE = _ChaosState()
