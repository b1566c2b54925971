"""Checkpoints: directory-based artifacts + top-k retention (port of
``ray_tpu/train/checkpoint.py``).

Reference: ``python/ray/train/_checkpoint.py`` (dir-based ``Checkpoint``)
and ``train/v2/_internal/execution/checkpoint/checkpoint_manager.py``
(registration + ``CheckpointConfig`` pruning). Storage is a local/NFS
path. A tree of tensors holding DTensors is saved with
``torch.distributed.checkpoint`` — each rank writes its own shards, and a
restore lands on the live mesh — any other tree with ``torch.save``
(read back with ``weights_only=True``). Both restore the same bits.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

_DCP_DIR = "pytree_dcp"
_FILE = "pytree.pt"


def _holds_dtensor(tree) -> bool:
    from ray_tpu_torch.parallel.sharding import is_dtensor

    if isinstance(tree, dict):
        return any(_holds_dtensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_holds_dtensor(v) for v in tree)
    return is_dtensor(tree)


def _as_tensors(tree):
    """Numpy leaves as tensors (``torch.load(weights_only=True)`` reads
    tensors, not numpy's pickles)."""
    import numpy as np
    import torch

    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_tensors(v) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return tree


class Checkpoint:
    """A directory of files produced by training (reference
    ``Checkpoint.from_directory``)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def as_directory(self) -> str:
        return self.path

    # --- pytree convenience (net-new vs reference: tensor-aware payloads) ---
    @classmethod
    def from_pytree(cls, path: str, tree: Any) -> "Checkpoint":
        """Save ``tree`` (nested dicts and lists of tensors, numpy arrays
        and Python scalars). Every rank of a sharded tree calls it with
        its own DTensors and the same ``path``."""
        os.makedirs(path, exist_ok=True)
        if _holds_dtensor(tree):
            import torch.distributed.checkpoint as dcp

            dcp.save({"tree": tree},
                     checkpoint_id=os.path.join(os.path.abspath(path),
                                                _DCP_DIR))
        else:
            import torch

            torch.save(_as_tensors(tree), os.path.join(path, _FILE))
        return cls(path)

    def to_pytree(self, target: Any = None) -> Any:
        """Restore. A sharded checkpoint needs ``target``, a tree of the
        same structure whose DTensors give the placements on the live
        mesh; it is filled in place and returned."""
        ddir = os.path.join(self.path, _DCP_DIR)
        if os.path.isdir(ddir):
            import torch.distributed.checkpoint as dcp

            if target is None:
                raise ValueError(
                    "a sharded checkpoint restores into a target tree of "
                    "DTensors on the live mesh; pass target=")
            state = {"tree": target}
            dcp.load(state, checkpoint_id=ddir)
            return state["tree"]
        import torch

        return torch.load(os.path.join(self.path, _FILE),
                          weights_only=True)

    def __repr__(self):
        return f"Checkpoint({self.path!r})"


@dataclasses.dataclass
class CheckpointConfig:
    """Reference: ``python/ray/air/config.py`` CheckpointConfig."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"     # "max" | "min"


@dataclasses.dataclass
class _Tracked:
    checkpoint: Checkpoint
    metrics: Dict[str, Any]
    index: int


class CheckpointManager:
    """Registers reported checkpoints, prunes to ``num_to_keep``."""

    def __init__(self, storage_path: str, config: CheckpointConfig):
        self.storage_path = storage_path
        self.config = config
        self._tracked: List[_Tracked] = []
        self._index = 0
        self._lock = threading.Lock()
        os.makedirs(storage_path, exist_ok=True)

    def register(self, checkpoint: Checkpoint,
                 metrics: Dict[str, Any]) -> Checkpoint:
        with self._lock:
            self._index += 1
            t = _Tracked(checkpoint, dict(metrics), self._index)
            self._tracked.append(t)
            with open(os.path.join(checkpoint.path, "_metrics.json"),
                      "w") as f:
                json.dump({"metrics": _json_safe(metrics),
                           "index": self._index}, f)
            self._prune()
            return checkpoint

    def _score(self, t: _Tracked):
        attr = self.config.checkpoint_score_attribute
        if attr is None:
            return t.index                       # keep most recent
        if attr not in t.metrics:
            return float("-inf")                 # unscored ranks worst
        sign = 1 if self.config.checkpoint_score_order == "max" else -1
        return sign * float(t.metrics[attr])

    def _prune(self):
        keep = self.config.num_to_keep
        if keep is None or len(self._tracked) <= keep:
            return
        # The most recent checkpoint is always protected from score-based
        # pruning (as in the reference): it is the resume point.
        newest = max(self._tracked, key=lambda t: t.index)
        rest = sorted((t for t in self._tracked if t is not newest),
                      key=self._score, reverse=True)
        kept = [newest] + rest[:keep - 1]
        for t in rest[keep - 1:]:
            shutil.rmtree(t.checkpoint.path, ignore_errors=True)
        self._tracked = kept

    @property
    def latest(self) -> Optional[Checkpoint]:
        with self._lock:
            if not self._tracked:
                return None
            return max(self._tracked, key=lambda t: t.index).checkpoint

    @property
    def best(self) -> Optional[Checkpoint]:
        with self._lock:
            if not self._tracked:
                return None
            return max(self._tracked, key=self._score).checkpoint


def _json_safe(obj):
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        if isinstance(obj, dict):
            return {k: _json_safe(v) for k, v in obj.items()}
        try:
            return float(obj)
        except (TypeError, ValueError):
            return repr(obj)
