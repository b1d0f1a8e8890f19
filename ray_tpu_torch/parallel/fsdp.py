"""Fully-sharded data parallelism: what GSPMD does under the reference's
``param_shardings`` on a mesh with an ``fsdp`` axis, for any model's rule
table (the Llama, the ViT and the MoE over a mesh).

It has no reference file. The reference lays every parameter out by the
logical-axis rule table (``embed`` -> ``fsdp``), and XLA gathers a weight
where the program reads it and reduce-scatters its gradient. Here each rank
is a process that stores only its block of every parameter under its whole
spec (:class:`~.sharding.NamedSharding` of
:func:`~.sharding.param_shardings`), split over ``fsdp``, ``tp`` and ``ep``
alike, and only the ``fsdp`` dimension is gathered, over the mesh's
``fsdp`` sub-group: the gathered tensor is the rank's tensor- or
expert-parallel block, which the model's Megatron pair
(collective/functional.py) computes with. :meth:`FSDP.localize` gives a
model built at those widths its blocks' shapes, and :meth:`FSDP.gather` /
:meth:`FSDP.call_block` are what its forward reads parameters through:

- ``embed`` before the lookup, freed after it;
- each block's weights at the block's start, freed at its end. Under
  ``config.remat`` the model runs the block under
  ``torch.utils.checkpoint``, so its gathered weights are not kept for the
  backward: the recompute gathers them again;
- ``final_norm`` before the final norm, and ``lm_head`` inside a
  checkpoint of the head's product (gathered again in the backward).

A frozen block is gathered under ``no_grad`` (no backward). A trained one
goes through ``collective.functional.all_gather_cat``, whose backward
reduce-scatters its gradient: the rank receives the sum over the ``fsdp``
ranks of its block's gradient.

:meth:`FSDP.sync_gradients` completes the gradients of a loss that is
global on every rank with each rank's backward its own share (the models'
``sum_of_ranks`` over the data axes and, for the Llama, ``sp``): a block
split over ``fsdp`` was summed over ``fsdp`` by its gather's
reduce-scatter and is summed over the other data axes (``dcn``, ``dp``)
and ``sp``, every other parameter over all the data axes and ``sp``. A
parameter replicated over ``tp`` or ``ep`` is not reduced over them: the
Megatron pair gives it the same whole gradient on those ranks.
:meth:`FSDP.full` gathers a parameter whole over every axis that splits
it (a checkpoint's adapters). A model built without a mesh (every serving
path) is untouched.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn
from torch.func import functional_call

from ..collective.functional import all_gather_cat
from .mesh import LOSS_AXES
from .sharding import NamedSharding, _axis_names, param_shardings

AXIS = "fsdp"

#: the largest flat bucket of :meth:`FSDP.sync_gradients`
SYNC_BUCKET_BYTES = 32 << 20


def _sum_flat(group, grads) -> None:
    """Sum ``grads`` over ``group`` in place, as one flat tensor."""
    if len(grads) == 1:
        group.allreduce_(grads[0])
        return
    flat = group.allreduce_(torch.cat([g.reshape(-1) for g in grads]))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _set_param(model: nn.Module, name: str, value: nn.Parameter) -> None:
    *path, leaf = name.split(".")
    module = model
    for part in path:
        module = getattr(module, part)
    setattr(module, leaf, value)


class FSDP:
    """One rank's FSDP layout of a model's parameters.

    ``mesh`` is bound to this rank with its ``fsdp`` group
    (``mesh.bind(rank, {"fsdp": group})``, or ``Mesh.form_groups``);
    ``shardings`` maps each parameter's dotted name to its
    :class:`~.sharding.NamedSharding` on that mesh (:meth:`for_llama`,
    :meth:`for_model`). A parameter whose spec names ``fsdp`` is split
    along that one dimension and gathered along it; the ``fsdp`` axis may be
    of size 1, and then each gather goes through a one-rank group all the
    same if the mesh has one, or is skipped if it has none. A spec may split
    other dimensions over other axes (the rank holds its block); one that
    puts ``fsdp`` beside another axis past 1 on one dimension raises."""

    def __init__(self, mesh, shardings: Mapping[str, NamedSharding]):
        self.mesh = mesh
        self.group = mesh.group(AXIS)
        if self.group is None and mesh.shape[AXIS] > 1:
            raise ValueError("FSDP needs the mesh bound to its rank with an 'fsdp' group")
        if self.group is not None and self.group.world_size != mesh.shape[AXIS]:
            raise ValueError(f"the fsdp group has {self.group.world_size} ranks, the mesh's "
                             f"fsdp axis {mesh.shape[AXIS]}")
        self.shardings = dict(shardings)
        #: the dimension each sharded parameter is split along
        self.dims: Dict[str, int] = {}
        for name, sharding in self.shardings.items():
            for d, axes in enumerate(sharding.spec):
                names = _axis_names(axes)
                if AXIS not in names:
                    continue
                others = [a for a in names if a != AXIS and mesh.shape[a] > 1]
                if others:
                    raise NotImplementedError(
                        f"{name}: spec {sharding.spec} splits dimension {d} over fsdp and "
                        f"{others}; FSDP gathers a dimension split over fsdp alone")
                if self.group is not None:
                    self.dims[name] = d
                break

    @classmethod
    def for_llama(cls, config, mesh, rules=None) -> "FSDP":
        """The layout of a Llama of ``config`` by the reference's rule table
        and the Llama parameters' logical axes."""
        from ..models.llama import param_shapes

        shapes = param_shapes(config)
        return cls(mesh, param_shardings(mesh, shapes, rules))

    @classmethod
    def for_model(cls, mesh, shapes: Mapping[str, torch.Size], logical_axes,
                  rules=None) -> "FSDP":
        """The layout of a model whose parameters have the global
        ``shapes`` (name -> shape) and the logical axes ``logical_axes`` (a
        mapping or a function of the name, as ``param_shardings`` takes)."""
        return cls(mesh, param_shardings(mesh, dict(shapes), rules, logical_axes))

    @property
    def size(self) -> int:
        return 1 if self.group is None else self.group.world_size

    @property
    def sharded(self) -> frozenset:
        """Names of the parameters split over ``fsdp``."""
        return frozenset(self.dims)

    # -- the layout ----------------------------------------------------------

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full parameter ``t`` under its whole
        spec (a copy, so the full tensor can be freed; ``t`` itself where
        no axis past 1 splits it). Fits ``init_params(shard=)``."""
        sharding = self.shardings[name]
        if not sharding.slices(t.shape):
            return t
        return sharding.shard(t).clone()

    def localize(self, model: nn.Module) -> nn.Module:
        """Replace every parameter of ``model`` (built at the widths of a
        gathered block: split over ``tp`` and ``ep``, whole along
        ``fsdp``) by an empty one of this rank's block's shape, on its
        device and of its dtype, so that ``load_state_dict`` takes the
        blocks; set ``model.fsdp``."""
        for name, p in list(model.named_parameters()):
            shape = list(p.shape)
            if name in self.dims:
                d = self.dims[name]
                if shape[d] % self.size:
                    raise ValueError(f"{name}: dimension {d} of {tuple(shape)} does not divide "
                                     f"over fsdp={self.size}")
                shape[d] //= self.size
            _set_param(model, name, nn.Parameter(
                torch.empty(shape, dtype=p.dtype, device=p.device), requires_grad=p.requires_grad))
        model.fsdp = self
        return model

    def sync_gradients(self, params) -> None:
        """Complete, in place, the gradients of ``params`` ((name,
        parameter) pairs, e.g. ``model.named_parameters()``) of a loss that
        every rank holds whole and whose backward on each rank is its own
        data and sequence shard's term (see the module docstring): a block
        split over ``fsdp`` is summed over the other data axes and ``sp``,
        every other parameter over all the data axes and ``sp``; nothing is
        summed over ``tp`` or ``ep``.
        The gradients bound for one group are summed in flat buckets of up
        to SYNC_BUCKET_BYTES (one op each, in the order given: the sums are
        elementwise, so a bucket changes no bit)."""
        rest_axes = tuple(a for a in LOSS_AXES if a != AXIS)
        self.mesh.require_groups((rest_axes, LOSS_AXES), "FSDP.sync_gradients")
        rest, everything = self.mesh.group(rest_axes), self.mesh.group(LOSS_AXES)
        pending: Dict[tuple, list] = {}
        for name, p in params:
            group = rest if name in self.dims else everything
            if p.grad is None or group is None:
                continue
            key = (id(group), p.grad.dtype, p.grad.device)
            bucket = pending.setdefault(key, [group, [], 0])
            bucket[1].append(p.grad)
            bucket[2] += p.grad.numel() * p.grad.element_size()
            if bucket[2] >= SYNC_BUCKET_BYTES:
                _sum_flat(*pending.pop(key)[:2])
        for group, grads, _ in pending.values():
            _sum_flat(group, grads)

    def shard_params(self, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {name: self.shard(name, t) for name, t in params.items()}

    def blocks_of(self, params: Mapping[str, torch.Tensor],
                  shapes: Mapping[str, torch.Size]) -> Dict[str, torch.Tensor]:
        """``params`` with each tensor of its global shape (``shapes``)
        replaced by this rank's block of it, the others (blocks already)
        kept."""
        return {name: self.shard(name, t) if t.shape == shapes.get(name) else t
                for name, t in params.items()}

    @torch.no_grad()
    def full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole of a parameter from this rank's block: every dimension
        its spec splits gathered over the group of its axes (every rank of
        the mesh calls it). ``local`` itself where nothing splits it."""
        for d, axes in enumerate(self.shardings[name].spec):
            live = tuple(a for a in _axis_names(axes) if self.mesh.shape[a] > 1)
            if live:
                group = self.mesh.group(live[0] if len(live) == 1 else live)
                local = group.allgather_cat(local, dim=d)
        return local

    def full_state(self, named: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """:meth:`full` of every tensor of ``named``, in order."""
        return {name: self.full(name, t.detach()) for name, t in named.items()}

    # -- the forward ---------------------------------------------------------

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The parameter ``name`` with its ``fsdp`` dimension gathered from
        this rank's block ``local``: through ``all_gather_cat`` (its
        gradient reduce-scattered) when it requires grad, else under
        ``no_grad``; ``local`` itself when it is not split over fsdp."""
        if name not in self.dims:
            return local
        if local.requires_grad:
            return all_gather_cat(local, self.group, self.dims[name])
        with torch.no_grad():
            return self.group.allgather_cat(local, dim=self.dims[name])

    def call_block(self, block: nn.Module, prefix: str, *args):
        """``block(*args)`` with each of its parameters gathered (``prefix``:
        the block's dotted name and a dot)."""
        weights = {n: self.gather(prefix + n, p) for n, p in block.named_parameters()}
        return functional_call(block, weights, args)
