"""Train-worker collectives: the port of ray_tpu/train/collective.py.

``broadcast_from_rank_zero``, ``barrier``, ``allreduce`` and ``allgather``
carry small host-side values (configs, flags, metrics) over the run's gloo
control group. :func:`reduce_gradients` sums a gradient dict across the
gang over the run's tensor group (NCCL on the card) through the bucketized
:class:`~ray_tpu_torch.collective.GradientReduceScheduler`, built from the
context's knobs.

For the example loops: :func:`tensor_group` and :func:`gang_mesh` (the
run's ranks as a :class:`~ray_tpu_torch.parallel.Mesh`, bound with a
sub-group for each of its axes), :func:`gang_mean` (the loss a gang
reports: the mean of the ranks' values, the reference's loss over the
global batch) and :class:`DataParallelMean` (the gradient hook between
``backward()`` and the optimizer).
"""

from __future__ import annotations

from typing import Any, Collection, Dict, Mapping, Optional

import torch

from .. import collective as _collective
from .session import get_context


def _group() -> str:
    name = get_context().collective_group
    if not name:
        raise RuntimeError("no collective group for this training run: it runs one "
                           "worker in the caller's process")
    return name


def broadcast_from_rank_zero(data: Any = None) -> Any:
    """Every worker calls this; all return rank 0's value."""
    return _collective.broadcast(data, src_rank=0, group_name=_group())


def barrier() -> None:
    """Block until every training worker arrives."""
    _collective.barrier(group_name=_group())


def allreduce(value, op=None):
    """Sum (by default) a small host-side value across the workers."""
    kwargs = {} if op is None else {"op": op}
    return _collective.allreduce(value, group_name=_group(), **kwargs)


def allgather(value) -> list:
    return _collective.allgather(value, group_name=_group())


def gradient_scheduler():
    """This run's gradient scheduler over its tensor group, built on first
    use from the context's gang-uniform knobs (overlap, bucket_bytes,
    stale_grad) and cached on the context."""
    from ..collective.bucketizer import DEFAULT_BUCKET_BYTES
    from ..collective.scheduler import GradientReduceScheduler

    ctx = get_context()
    if not ctx.collective_tensor_group:
        raise RuntimeError("no tensor group for this training run: it runs one worker "
                           "in the caller's process")
    if ctx._grad_scheduler is None:
        ctx._grad_scheduler = GradientReduceScheduler(
            _collective.get_group(ctx.collective_tensor_group),
            bucket_bytes=ctx.collective_bucket_bytes or DEFAULT_BUCKET_BYTES,
            overlap=ctx.collective_overlap,
            stale_grad=ctx.collective_stale_grad,
        )
    return ctx._grad_scheduler


def reduce_gradients(grads: Mapping[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
    """Sum a gradient dict across the gang. At ``stale_grad=1``, the
    PREVIOUS step's sum (None on the first step: skip the update)."""
    return gradient_scheduler().step(grads)


def tensor_group():
    """The run's tensor group, or None for one worker in the caller's
    process."""
    name = get_context().collective_tensor_group
    return _collective.get_group(name) if name else None


def gang_mesh(device, **axes):
    """The run's ranks as a mesh of ``axes`` (``make_mesh``'s keywords),
    bound to this rank with its sub-groups (``Mesh.form_groups``, of the
    tensor group's backend: a group for each axis past 1, for the data axes
    together and for ``ep`` and ``tp`` together; a group whose ranks are
    the whole gang is the run's tensor group itself), each rank on its own
    device (gathered over the control group). Every rank calls it, in the
    same order as its other calls that form groups."""
    from ..parallel.mesh import make_mesh

    ctx = get_context()
    devices = allgather(str(device)) if ctx.collective_group else [str(device)]
    mesh = make_mesh(len(devices), devices=devices, **axes)
    group = tensor_group()
    if group is None:
        return mesh.bind(ctx.world_rank)
    return mesh.form_groups(group.backend, whole=group,
                            name=f"{ctx.collective_tensor_group}:mesh")


def gang_mean(value: torch.Tensor, mesh=None) -> float:
    """The mean over the ranks of a scalar tensor (each rank's loss over its
    own equal batch: the loss over the global batch, as the reference
    reports under ``jax.distributed``): one all-reduce over the tensor
    group past one rank, every rank the same value. With a ``mesh`` whose
    data axes have a group, the mean is over that group: each data shard's
    value once (the ranks of a tensor- or expert-parallel group hold one
    value)."""
    ctx = get_context()
    if mesh is not None:
        from ..parallel.mesh import BATCH_AXES

        data = mesh.group(BATCH_AXES)
        if data is None:
            return float(value)
        total = data.allreduce_(value.detach().reshape(1).float().clone())
        return float(total) / data.world_size
    if ctx.world_size == 1 or not ctx.collective_tensor_group:
        return float(value)
    total = tensor_group().allreduce(value.detach().reshape(1).float())
    return float(total) / ctx.world_size


def gradients(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The gradients of ``model``'s parameters by name."""
    return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def set_gradients(model: torch.nn.Module, grads: Optional[Mapping[str, torch.Tensor]]) -> bool:
    """Set ``model``'s parameters' gradients to ``grads``; False for None
    (skip the update)."""
    if grads is None:
        return False
    for name, p in model.named_parameters():
        if name in grads:
            p.grad = grads[name]
    return True


class DataParallelMean:
    """A gang's gradient hook: the sum over the ranks through
    :func:`reduce_gradients`, divided by ``world_size``. With every rank's
    batch of one size, that is the gradient of the mean loss over the
    global batch, the reference's. None at ``stale_grad=1``'s first step.

    ``sharded`` names gradients that arrive already summed (an FSDP slice,
    whose gather's backward reduce-scatters it): they skip
    :func:`reduce_gradients` and are only divided, once; at ``stale_grad=1``
    they wait a step with the rest."""

    def __init__(self, world_size: int, sharded: Collection[str] = ()):
        self.world_size = world_size
        self.sharded = frozenset(sharded)
        self._held: Dict[str, torch.Tensor] = {}

    def __call__(self, grads: Mapping[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
        own = {n: g for n, g in grads.items() if n in self.sharded}
        summed = reduce_gradients({n: g for n, g in grads.items() if n not in own})
        if gradient_scheduler().stale_grad:
            own, self._held = self._held, own
        return self._mean(summed, own)

    def flush(self) -> Optional[Dict[str, torch.Tensor]]:
        """At ``stale_grad=1``: the last step's gradients, which the
        scheduler (and this hook) still hold."""
        own, self._held = self._held, {}
        return self._mean(gradient_scheduler().flush(), own)

    def _mean(self, summed, own):
        if summed is None:
            return None
        return {name: g.div_(self.world_size) for name, g in {**summed, **own}.items()}
