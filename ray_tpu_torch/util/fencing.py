"""Process-local node fence flag.

When a raylet loses GCS contact past its liveness window it self-fences
(split-brain prevention: the GCS may already be restarting this node's
actors/replicas elsewhere) and fans the flag out to its resident workers
via a ``set_fenced`` one-way RPC. In-process consumers — serve replica
admission, collective abort checks — read :func:`is_fenced` instead of
asking the (unreachable) GCS. The flag clears on the raylet's first
successful report after the partition heals.

Deliberately dependency-free module globals: the readers sit on hot
admission paths and inside collective poll ticks.

A copy of ``ray_tpu/util/fencing.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

import threading
from typing import Tuple

_lock = threading.Lock()
_fenced = False
_node_id = ""
_reason = ""


def set_fenced(fenced: bool, node_id: str = "", reason: str = "") -> None:
    global _fenced, _node_id, _reason
    with _lock:
        _fenced = bool(fenced)
        _node_id = node_id
        _reason = reason if fenced else ""


def is_fenced() -> bool:
    return _fenced


def fence_info() -> Tuple[bool, str, str]:
    """(fenced, node_id_hex, reason) — for error messages and tests."""
    with _lock:
        return _fenced, _node_id, _reason
