"""Framework backends, per-worker distributed setup: the port of
ray_tpu/train/backend.py.

:class:`TorchConfig` brings up ``torch.distributed`` in every worker: the
reference's ``JaxConfig`` runs ``jax.distributed.initialize`` there, and
its ``TorchConfig`` the same process-group bootstrap as here. The store is
a ``TCPStore`` that the controller owns, on a port the OS picks (port 0) in
the caller's process: every worker joins it, so no free port is guessed
and released (which races between test processes).

The reference's ``JaxConfig`` and ``TensorflowConfig`` have no counterpart.
"""

from __future__ import annotations

import datetime
from typing import Optional

#: the store's address: the workers are processes of this host
STORE_HOST = "127.0.0.1"


class BackendConfig:
    """Base: no distributed setup."""

    def backend(self) -> "Backend":
        return Backend()


class Backend:
    def on_start(self, worker_group) -> None:
        pass

    def on_shutdown(self, worker_group) -> None:
        pass


class TorchConfig(BackendConfig):
    """``torch.distributed`` bootstrap. ``backend=None`` means ``"nccl"``
    for workers on the card and ``"gloo"`` for workers on the CPU; ``"gloo"``
    also serves ranks that share a card. ``timeout_s`` bounds every
    collective of the default group."""

    def __init__(self, backend: Optional[str] = None, timeout_s: int = 1800):
        if backend not in (None, "nccl", "gloo"):
            raise ValueError(f"backend must be None, 'nccl' or 'gloo', got {backend!r}")
        self.backend_name = backend
        self.timeout_s = timeout_s

    def resolve(self, on_card: bool) -> str:
        """The process-group backend for workers on the card or the CPU."""
        if self.backend_name is not None:
            return self.backend_name
        return "nccl" if on_card else "gloo"

    def backend(self) -> "Backend":
        return _TorchBackend(self)


def _torch_worker_setup(port: int, world_size: int, rank: int, backend: str,
                        timeout_s: int):
    """In each worker: join the controller's store and form the default
    process group over it."""
    import torch.distributed as dist

    store = dist.TCPStore(STORE_HOST, port, world_size + 1, is_master=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    dist.init_process_group(
        backend=backend, store=store, world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
    )


def _torch_shutdown():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class _TorchBackend(Backend):
    def __init__(self, config: TorchConfig):
        self._config = config
        self._store = None

    def on_start(self, worker_group):
        import torch.distributed as dist

        n = worker_group.num_workers
        timeout = datetime.timedelta(seconds=self._config.timeout_s)
        # world_size + 1 clients: the workers and this process
        self._store = dist.TCPStore(STORE_HOST, 0, n + 1, is_master=True,
                                    wait_for_workers=False, timeout=timeout)
        worker_group.execute_each(
            _torch_worker_setup,
            [(self._store.port, n, rank, self._config.resolve(worker_group.on_card),
              self._config.timeout_s) for rank in range(n)],
        )

    def on_shutdown(self, worker_group):
        worker_group.execute(_torch_shutdown)
        self._store = None
