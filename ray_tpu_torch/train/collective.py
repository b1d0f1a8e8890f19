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
global batch) and the gradient hooks between ``backward()`` and the
optimizer: :class:`DataParallelMean` for replicated parameters and
:class:`MeshGradients` for a model over a mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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
    tensor group's backend: a group for each axis past 1 and for each
    combination of ``GROUP_COMBOS``, such as the data axes together, with
    ``sp`` and without ``fsdp``, and ``ep`` with ``tp``; a group whose ranks
    are the whole gang is the run's tensor group itself), each rank on its own
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
    global batch, the reference's. None at ``stale_grad=1``'s first step."""

    def __init__(self, world_size: int):
        self.world_size = world_size

    def __call__(self, grads: Mapping[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
        return self._mean(reduce_gradients(grads))

    def flush(self) -> Optional[Dict[str, torch.Tensor]]:
        """At ``stale_grad=1``: the last step's gradients, which the
        scheduler still holds."""
        return self._mean(gradient_scheduler().flush())

    def _mean(self, summed):
        if summed is None:
            return None
        return {name: g.div_(self.world_size) for name, g in summed.items()}


class MeshGradients:
    """The gradient hook of a model over a mesh (the Llama, the ViT, the
    MoE), whose loss is global on every rank and whose backward on each rank
    is its own term (nothing to divide). It completes the gradients as
    ``model.fsdp.sync_gradients`` does, with the run's knobs:

    - a block split over ``fsdp``, summed over ``fsdp`` by its gather's
      reduce-scatter, is summed over the other loss axes (the data axes but
      ``fsdp``, and ``sp``) by ``model.fsdp.sync_gradients``, at full width
      as the reduce-scatter is;
    - every other gradient is summed over the loss axes
      (:data:`~ray_tpu_torch.parallel.mesh.LOSS_AXES`) through a
      :class:`~ray_tpu_torch.collective.GradientReduceScheduler`: where
      those axes are the whole gang (``tp`` = ``ep`` = 1), the run's own
      (:func:`gradient_scheduler`: ``quantized``, ``overlap``,
      ``bucket_bytes``, ``stale_grad``), as the replicated path's; else one
      over the mesh's group of those axes with the same ``overlap``,
      ``bucket_bytes`` and ``stale_grad``, and ``quantized`` raises (that
      group is not the run's quantized one).

    At ``stale_grad=1`` it returns the previous step's gradients (None on
    the first step: skip the update), and :meth:`flush` the last step's."""

    def __init__(self, model: torch.nn.Module):
        from ..collective.bucketizer import DEFAULT_BUCKET_BYTES
        from ..collective.scheduler import GradientReduceScheduler
        from ..parallel.mesh import LOSS_AXES

        ctx = get_context()
        self.model, self.stale_grad = model, ctx.collective_stale_grad
        self.sharded = model.fsdp.sharded
        mesh = model.fsdp.mesh
        self._held: Dict[str, torch.Tensor] = {}
        self._late: Optional[Dict[str, torch.Tensor]] = None
        if ctx.collective_tensor_group and mesh.axes_size(LOSS_AXES) == ctx.world_size:
            self.scheduler = gradient_scheduler()
            return
        if ctx.collective_quantized:
            raise NotImplementedError(
                f"quantized gradient sums on {mesh}: its loss axes {LOSS_AXES} are not the "
                "whole gang, and their group does not quantize; quantized takes a layout "
                "without tp or ep")
        group = mesh.group(LOSS_AXES)
        self.scheduler = None if group is None else GradientReduceScheduler(
            group, bucket_bytes=ctx.collective_bucket_bytes or DEFAULT_BUCKET_BYTES,
            overlap=ctx.collective_overlap, stale_grad=self.stale_grad)

    def __call__(self, grads: Mapping[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
        self.model.fsdp.sync_gradients(
            (n, p) for n, p in self.model.named_parameters() if n in self.sharded)
        own = {n: g for n, g in grads.items() if n in self.sharded}
        rest = {n: g for n, g in grads.items() if n not in self.sharded}
        if self.scheduler is not None:
            summed = self.scheduler.step(rest)
        elif self.stale_grad:
            summed, self._late = self._late, rest
        else:
            summed = rest
        if self.stale_grad:
            own, self._held = self._held, own
        return None if summed is None else {**summed, **own}

    def flush(self) -> Optional[Dict[str, torch.Tensor]]:
        """At ``stale_grad=1``: the last step's gradients, which this hook
        (and its scheduler) still hold."""
        own, self._held = self._held, {}
        if self.scheduler is not None:
            summed = self.scheduler.flush()
        else:
            summed, self._late = self._late, None
        return None if summed is None else {**summed, **own}
