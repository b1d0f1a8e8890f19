"""Runtime context introspection.

Role-equivalent of the reference's ray.runtime_context
(python/ray/runtime_context.py): lets driver and task/actor code ask "where
am I running" — node, worker, job, actor, placement group.

A copy of ``ray_tpu/runtime_context.py`` (host code: the port imports nothing
of ``ray_tpu``), which also reports the lease's card
(``get_accelerator_ids``, as Ray's runtime context does).
"""

from __future__ import annotations

from typing import Optional

from . import _worker_api


class RuntimeContext:
    def __init__(self, worker):
        self._worker = worker

    def get_node_id(self) -> str:
        nid = getattr(self._worker, "node_id", None)
        if nid is None:
            return ""
        # node_id may be a NodeID or the raylet address tuple
        if hasattr(nid, "hex"):
            return nid.hex()
        return str(nid)

    def get_worker_id(self) -> str:
        return self._worker.worker_id.hex()

    def get_job_id(self) -> str:
        return self._worker.job_id.hex()

    def get_actor_id(self) -> Optional[str]:
        spec = getattr(self._worker, "_actor_spec", None)
        if spec is None or spec.actor_id is None:
            return None
        return spec.actor_id.hex()

    def get_task_id(self) -> Optional[str]:
        tid = getattr(self._worker, "_current_task_id", None)
        return tid.hex() if tid is not None else None

    def get_accelerator_ids(self) -> dict:
        """The accelerator ids of this worker's lease: {"GPU": [...]}."""
        return {"GPU": [str(i) for i in getattr(self._worker, "gpu_ids", [])]}

    @property
    def was_current_actor_reconstructed(self) -> bool:
        spec = getattr(self._worker, "_actor_spec", None)
        return bool(spec is not None and getattr(spec, "attempt", 0) > 0)

    def get(self) -> dict:
        return {
            "node_id": self.get_node_id(),
            "worker_id": self.get_worker_id(),
            "job_id": self.get_job_id(),
            "actor_id": self.get_actor_id(),
            "task_id": self.get_task_id(),
        }


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(_worker_api.get_core_worker())
