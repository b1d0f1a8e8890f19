"""Fully-sharded data parallelism for the Llama of models/llama.py: what
GSPMD does under the reference's ``param_shardings`` on an ``fsdp`` mesh.

It has no reference file. The reference lays every parameter out by the
logical-axis rule table (``embed`` -> ``fsdp``), and XLA gathers a weight
where the program reads it and reduce-scatters its gradient. Here each rank
is a process that stores only its block of every parameter whose spec
names the ``fsdp`` axis (:class:`~.sharding.NamedSharding` of
:func:`~.sharding.param_shardings`): the frozen base and the adapter
matrices with an ``embed`` axis. The rest (the adapters' ``lora_rank`` x
``heads`` factors) is replicated.

:meth:`FSDP.forward` is the model's full-sequence forward with the weights
gathered over the mesh's ``fsdp`` group just before they are read:

- ``embed`` before the lookup, freed after it;
- each block's weights at the block's start, freed at its end. Under
  ``config.remat`` the block runs under ``torch.utils.checkpoint``, so its
  gathered weights are not kept for the backward: the recompute gathers
  them again;
- ``final_norm`` before the final norm, and ``lm_head`` inside a
  checkpoint of the head's product (gathered again in the backward).

The frozen base is gathered under ``no_grad`` (no backward). An adapter
block goes through ``collective.functional.all_gather_cat``, whose backward
reduce-scatters its gradient: the rank receives the sum over the ranks of
its block's gradient (:attr:`FSDP.sharded` names them; divide by the world
size once, and do not reduce them again). A replicated adapter's gradient
is the rank's own, for ``train.collective.reduce_gradients``. A model built
without FSDP (every serving path) is untouched.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..collective.functional import all_gather_cat
from ..ops.rmsnorm import rmsnorm
from .sharding import NamedSharding, param_shardings

AXIS = "fsdp"


def _set_param(model: nn.Module, name: str, value: nn.Parameter) -> None:
    *path, leaf = name.split(".")
    module = model
    for part in path:
        module = getattr(module, part)
    setattr(module, leaf, value)


class FSDP:
    """One rank's FSDP layout of a model's parameters.

    ``mesh`` is bound to this rank with its ``fsdp`` group
    (``mesh.bind(rank, {"fsdp": group})``); ``shardings`` maps each
    parameter's dotted name to its :class:`~.sharding.NamedSharding` on that
    mesh (:meth:`for_llama`). A parameter whose spec names ``fsdp`` is split
    along that one dimension; the ``fsdp`` axis may be of size 1, and then
    each gather goes through the one-rank group all the same."""

    def __init__(self, mesh, shardings: Mapping[str, NamedSharding]):
        self.mesh = mesh
        self.group = mesh.group(AXIS)
        if self.group is None:
            raise ValueError("FSDP needs the mesh bound to its rank with an 'fsdp' group")
        if self.group.world_size != mesh.shape[AXIS]:
            raise ValueError(f"the fsdp group has {self.group.world_size} ranks, the mesh's "
                             f"fsdp axis {mesh.shape[AXIS]}")
        self.shardings = dict(shardings)
        #: the dimension each sharded parameter is split along
        self.dims: Dict[str, int] = {}
        for name, sharding in self.shardings.items():
            if any(a != AXIS for a in sharding.split_axes()):
                raise NotImplementedError(
                    f"{name}: spec {sharding.spec} splits over {sharding.split_axes()}; "
                    "FSDP here splits over 'fsdp' alone (tensor-parallel training is "
                    "ROADMAP item 11)")
            dims = [d for d, axes in enumerate(sharding.spec)
                    if axes == AXIS or (isinstance(axes, tuple) and AXIS in axes)]
            if dims:
                self.dims[name] = dims[0]

    @classmethod
    def for_llama(cls, config, mesh, rules=None) -> "FSDP":
        """The layout of a Llama of ``config`` by the reference's rule table
        and the Llama parameters' logical axes."""
        from ..models.llama import param_shapes

        shapes = param_shapes(config)
        return cls(mesh, param_shardings(mesh, shapes, rules))

    @property
    def size(self) -> int:
        return self.group.world_size

    @property
    def sharded(self) -> frozenset:
        """Names of the parameters split over ``fsdp``."""
        return frozenset(self.dims)

    # -- the layout ----------------------------------------------------------

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full parameter ``t`` (a copy, so the
        full tensor can be freed; ``t`` itself at fsdp = 1 or when it is
        replicated). Fits ``init_params(shard=)``."""
        if name not in self.dims or self.size == 1:
            return t
        return self.shardings[name].shard(t).clone()

    def shard_params(self, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {name: self.shard(name, t) for name, t in params.items()}

    @torch.no_grad()
    def full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole of a parameter from this rank's block (every rank
        calls it: a gather over the group)."""
        if name not in self.dims:
            return local
        return self.group.allgather_cat(local, dim=self.dims[name])

    def full_state(self, named: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """:meth:`full` of every tensor of ``named``, in order."""
        return {name: self.full(name, t.detach()) for name, t in named.items()}

    def build_llama(self, config, params: Mapping[str, torch.Tensor]):
        """A Llama whose parameters ARE this rank's blocks ``params`` (every
        one frozen, as ``build_llama`` leaves them) and whose forward is
        :meth:`forward`."""
        from ..models.llama import Llama, param_shapes

        shapes = param_shapes(config)
        if sorted(params) != sorted(shapes):
            raise KeyError(f"params do not name the model's parameters: missing "
                           f"{sorted(set(shapes) - set(params))}, unknown "
                           f"{sorted(set(params) - set(shapes))}")
        for name, t in params.items():
            want = self.shardings[name].shard_shape(shapes[name])
            if t.shape != want:
                raise ValueError(f"{name}: this rank's block is {tuple(want)}, got {tuple(t.shape)}")
        with torch.device("meta"):
            model = Llama(config)
        for name, t in params.items():
            _set_param(model, name, nn.Parameter(t, requires_grad=False))
        model.fsdp = self
        return model

    # -- the forward ---------------------------------------------------------

    def _gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        if name not in self.dims:
            return local
        if local.requires_grad:
            return all_gather_cat(local, self.group, self.dims[name])
        return self.full(name, local)

    def _block(self, block, prefix: str, x, cos, sin):
        weights = {n: self._gather(prefix + n, p) for n, p in block.named_parameters()}
        return functional_call(block, weights, (x, cos, sin))

    def _head(self, model, x):
        return x @ self._gather("lm_head", model.lm_head).to(x.dtype)

    def forward(self, model, tokens: torch.Tensor) -> torch.Tensor:
        """The full-sequence forward of ``model`` (built by
        :meth:`build_llama`): logits (batch, seq, vocab) in
        ``config.dtype``, as ``Llama.forward`` computes them."""
        cfg = model.config
        x = self._gather("embed", model.embed)[tokens].to(cfg.dtype)
        cos, sin = model._rope_table(x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(model.blocks()):
            if remat:
                x = checkpoint(self._block, block, f"layer_{i}.", x, cos, sin,
                               use_reentrant=False)
            else:
                x = self._block(block, f"layer_{i}.", x, cos, sin)
        x = rmsnorm(x, self._gather("final_norm", model.final_norm).to(x.dtype), cfg.norm_eps)
        if remat:
            return checkpoint(self._head, model, x, use_reentrant=False)
        return self._head(model, x)

