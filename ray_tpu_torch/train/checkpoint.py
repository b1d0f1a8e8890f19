"""Checkpoints: directory handles and the run's manifest, copied from
ray_tpu/train/checkpoint.py (host code; the port imports nothing of
ray_tpu). Every reported checkpoint is kept: the reference's top-K
retention is not ported yet (see ``CheckpointConfig``).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class Checkpoint:
    """A handle to a checkpoint directory."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, dest: Optional[str] = None) -> str:
        """Copy the checkpoint's contents into a local directory and return it."""
        if dest is None:
            dest = tempfile.mkdtemp(prefix="ckpt_")
        shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    @contextmanager
    def as_directory(self):
        """The checkpoint as a local directory (no copy: it is one)."""
        yield self.path

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"

    def __eq__(self, other):
        return isinstance(other, Checkpoint) and other.path == self.path

    def __reduce__(self):
        return (Checkpoint, (self.path,))


class CheckpointManager:
    """Controller-side bookkeeping of reported checkpoints: the latest one,
    and ``checkpoint_manifest.json`` in the run directory listing all."""

    def __init__(self, run_dir: str):
        self._run_dir = run_dir
        self._entries: List[Dict[str, Any]] = []
        self._latest: Optional[Checkpoint] = None

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        return self._latest

    def register(self, checkpoint: Checkpoint, index: int, metrics: Dict[str, Any]):
        self._entries.append({"path": checkpoint.path, "index": index, "metrics": dict(metrics)})
        self._latest = checkpoint
        os.makedirs(self._run_dir, exist_ok=True)
        manifest = {"checkpoints": self._entries, "latest": checkpoint.path}
        tmp = os.path.join(self._run_dir, ".manifest.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2, default=str)
        os.replace(tmp, os.path.join(self._run_dir, "checkpoint_manifest.json"))
