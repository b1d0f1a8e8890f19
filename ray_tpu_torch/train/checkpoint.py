"""Checkpoints: directory handles, top-K retention and resume, copied from
ray_tpu/train/checkpoint.py (host code; the port imports nothing of
ray_tpu). :class:`CheckpointManager` keeps the run's reported checkpoints,
prunes them to ``CheckpointConfig.num_to_keep`` by a score attribute (or by
age), and writes ``checkpoint_manifest.json`` in the run directory;
:func:`load_latest_checkpoint` reads it back, so a later ``fit()`` under the
same run directory resumes from the last one.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .config import CheckpointConfig


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


@dataclass
class _TrackedCheckpoint:
    checkpoint: Checkpoint
    index: int
    metrics: Dict[str, Any] = field(default_factory=dict)

    def score(self, attribute: str):
        return self.metrics.get(attribute)


class CheckpointManager:
    """Controller-side bookkeeping of reported checkpoints: the latest and
    the best one, top-K pruning (a pruned checkpoint's directory is
    deleted; the latest is never pruned), and the run's manifest."""

    def __init__(self, run_dir: str, config: Optional[CheckpointConfig] = None):
        self._run_dir = run_dir
        self._config = config or CheckpointConfig()
        self._tracked: List[_TrackedCheckpoint] = []
        self._latest: Optional[_TrackedCheckpoint] = None

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        return self._latest.checkpoint if self._latest else None

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        attr = self._config.checkpoint_score_attribute
        if not attr or not self._tracked:
            return self.latest_checkpoint
        scored = [t for t in self._tracked if t.score(attr) is not None]
        if not scored:
            return self.latest_checkpoint
        best = (max if self._config.checkpoint_score_order == "max" else min)(
            scored, key=lambda t: t.score(attr)
        )
        return best.checkpoint

    def register(self, checkpoint: Checkpoint, index: int, metrics: Dict[str, Any]):
        for t in self._tracked:
            if t.index == index:  # another rank of the same report
                t.metrics.update(metrics)
                # a lagging rank's report for an older index must not rewind
                # the latest pointer past newer checkpoints
                if self._latest is None or index >= self._latest.index:
                    self._latest = t
                self._write_manifest()
                return
        tracked = _TrackedCheckpoint(checkpoint, index, dict(metrics))
        self._tracked.append(tracked)
        self._latest = tracked
        self._write_manifest()
        self._prune()

    def _prune(self):
        keep = self._config.num_to_keep
        if keep is None or len(self._tracked) <= keep:
            return
        attr = self._config.checkpoint_score_attribute
        candidates = [t for t in self._tracked if t is not self._latest]
        if attr:
            # worst first; a checkpoint without the score goes first of all
            reverse = self._config.checkpoint_score_order == "min"
            candidates.sort(
                key=lambda t: (t.score(attr) is None, t.score(attr) or 0),
                reverse=reverse,
            )
        else:
            candidates.sort(key=lambda t: t.index)
        while len(self._tracked) > keep and candidates:
            victim = candidates.pop(0)
            self._tracked.remove(victim)
            shutil.rmtree(victim.checkpoint.path, ignore_errors=True)
        self._write_manifest()

    def _write_manifest(self):
        os.makedirs(self._run_dir, exist_ok=True)
        manifest = {
            "checkpoints": [
                {"path": t.checkpoint.path, "index": t.index, "metrics": t.metrics}
                for t in sorted(self._tracked, key=lambda t: t.index)
            ],
            "latest": self._latest.checkpoint.path if self._latest else None,
        }
        tmp = os.path.join(self._run_dir, ".manifest.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2, default=str)
        os.replace(tmp, os.path.join(self._run_dir, "checkpoint_manifest.json"))


def load_latest_checkpoint(run_dir: str) -> Optional[Checkpoint]:
    """Resume support: the latest checkpoint the run's manifest records, if
    its directory still exists."""
    manifest_path = os.path.join(run_dir, "checkpoint_manifest.json")
    if not os.path.exists(manifest_path):
        return None
    with open(manifest_path) as f:
        manifest = json.load(f)
    latest = manifest.get("latest")
    if latest and os.path.isdir(latest):
        return Checkpoint(latest)
    return None
