"""Llama LoRA fine-tune through TorchTrainer: the port of
ray_tpu/train/examples/llama_lora.py (BASELINE.json config 3, "Llama-2-7B
LoRA fine-tune via JaxTrainer").

Each step is :func:`lora_train_step`: ``next_token_loss`` through the
full-sequence forward (RMSNorm and flash-attention forward kernels), with
every block recomputed in the backward (``remat``), ``loss.backward()``
through the flash-attention backward kernels, and AdamW on the adapters
only. The base weights are frozen: no gradients, no optimizer state.

In a gang (more than one worker, or a ``backend_config``) the loop builds
the reference's mesh over the ranks (``train.collective.gang_mesh``):
``fsdp`` (default: the ranks ``dp`` and ``tp`` leave, the reference's
``fsdp = n_dev``) x ``tp`` (default 1) and, beyond the reference's keys,
``dp`` (default 1), the ranks that replicate every parameter.

- By default, and whenever ``fsdp`` or ``tp`` is past 1, the model is the
  Llama over that mesh (``Llama(config, mesh)``, models/llama.py): every
  rank stores only its block of each parameter by the rule table (split
  over ``fsdp`` and ``tp``), gathers the ``fsdp`` blocks where they are
  read and again in the recompute, and runs its heads, hidden units and
  vocabulary columns between Megatron's collectives. Each step's loss is
  the global batch's on every rank, ``train.collective.MeshGradients``
  completes the gradients (nothing is divided: the loss is already the
  mean), and AdamW updates the rank's blocks. At one rank the gathers are
  one-rank ops.
- With ``dp`` given and fsdp = tp = 1 (``dp`` = the world size), every
  parameter is replicated: each rank's loss is its own rows' mean, the
  gradients are summed across the gang by
  ``train.collective.reduce_gradients`` and divided by the world size once
  (``DataParallelMean``), and every rank reports the mean of the ranks'
  losses.

Each data shard draws its own rows (``step_tokens`` seeded by the shard's
index over the data axes, ``mesh.axes_index(BATCH_AXES)``: the world rank
where every rank is a shard), so the ranks of one ``tp`` group feed the
same rows, and every rank reports the loss over the global batch. The
trainer's knobs shape the gradient sums on either path: the sums over the
whole gang (the replicated path's, and the mesh's at tp = 1) go through the
run's ``GradientReduceScheduler`` (``quantized``, ``overlap``,
``bucket_bytes``); at tp > 1 the sums over the data axes go through one of
that group's with ``overlap`` and ``bucket_bytes``, and ``quantized``
raises. At ``stale_grad=1`` the first step skips the update and the last
step's gradients are applied after the loop's last step. The epoch's
``lora.pkl`` holds the full adapters, gathered over ``fsdp`` and ``tp`` to
every rank and written by rank 0. The reference's loop reads no ``sp``, so
this one takes none: ``sp`` is reached through ``Llama(config, mesh)`` and
:func:`lora_model`'s ``mesh``.

``train_loop_config`` keys: model ("tiny" | "7b"), epochs, steps_per_epoch,
batch_per_worker, seq, lora_rank, lr, device (None means cuda), fsdp, tp,
dp.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..._internal.device import resolve_device
from ...models.llama import Llama, LlamaConfig, build_llama, init_params, next_token_loss
from ...parallel.fsdp import FSDP
from ...parallel.mesh import BATCH_AXES
from ...parallel.sharding import process_local_batch
from .. import collective as train_collective
from .. import session
from ..backend import TorchConfig
from ..checkpoint import Checkpoint
from ..config import RunConfig, ScalingConfig
from ..lora import split_lora
from ..trainer import TorchTrainer

#: a gradient hook: the adapters' gradients by name in, the gradients to
#: apply out, or None to skip this step's update
GradReducer = Callable[[Mapping[str, torch.Tensor]], Optional[Dict[str, torch.Tensor]]]


def model_config(config: dict) -> LlamaConfig:
    """The loop's LlamaConfig: Llama-2-7B with bf16 parameters for "7b",
    else the tiny test model; remat on in both, as in the reference."""
    if config.get("model") == "7b":
        return LlamaConfig(
            vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=32,
            intermediate=11008, max_seq_len=config.get("seq", 2048),
            param_dtype=torch.bfloat16, remat=True,
            lora_rank=config.get("lora_rank", 16),
        )
    return LlamaConfig.tiny(
        max_seq_len=config.get("seq", 128), lora_rank=config.get("lora_rank", 4), remat=True
    )


def lora_model(
    cfg: LlamaConfig, params: Dict[str, torch.Tensor], lr: float = 1e-4, mesh=None,
) -> Tuple[Llama, Dict[str, torch.nn.Parameter], torch.optim.AdamW]:
    """A Llama over ``params`` whose adapters train and whose base stays
    frozen, the adapters by name, and AdamW over the adapters alone. The
    adapters are leaf parameters in ``cfg.param_dtype``, as are their AdamW
    moments. The hyperparameters are optax.adamw's defaults (weight decay
    1e-4, not torch's 0.01). With a bound ``mesh`` the model is the Llama
    over it (``Llama(config, mesh)``): ``params`` are this rank's blocks
    (``FSDP.shard`` of its layout) or whole tensors, whose blocks are taken,
    and the gradients completed by :func:`mesh_gradients` are the loss's."""
    model = build_llama(cfg, params, mesh)
    _, lora = split_lora(dict(model.named_parameters()))
    if not lora:
        raise ValueError("the config has no adapters: set lora_rank > 0")
    for p in lora.values():
        p.requires_grad_(True)
    optimizer = torch.optim.AdamW(
        lora.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4
    )
    return model, lora, optimizer


def lora_train_step(
    model: Llama, optimizer: torch.optim.Optimizer, tokens: torch.Tensor,
    reduce_grads: Optional[GradReducer] = None,
) -> torch.Tensor:
    """One step: loss, backward, AdamW update. Returns the loss (detached,
    on the model's device; reading it waits for the step). ``reduce_grads``,
    when given, maps the adapters' gradients to the ones AdamW applies (see
    :func:`data_parallel_mean`); None from it skips the update."""
    optimizer.zero_grad(set_to_none=True)
    loss = next_token_loss(model.config, model, tokens)
    loss.backward()
    if reduce_grads is None or train_collective.set_gradients(
            model, reduce_grads(train_collective.gradients(model))):
        optimizer.step()
    return loss.detach()


def data_parallel_mean(world_size: int) -> train_collective.DataParallelMean:
    """The gang's gradient hook (``train.collective.DataParallelMean``):
    the sum over the ranks through ``train.collective.reduce_gradients``,
    divided by ``world_size``. With every rank's batch of one size, that is
    the gradient of the mean loss over the global batch, the reference's.
    None at ``stale_grad=1``'s first step."""
    return train_collective.DataParallelMean(world_size)


def mesh_gradients(model: Llama) -> train_collective.MeshGradients:
    """The gradient hook of a model over a mesh
    (``train.collective.MeshGradients``): the sums over the mesh's loss axes
    that ``model.fsdp.sync_gradients`` makes, with the run's knobs, and at
    ``stale_grad=1`` the previous step's."""
    return train_collective.MeshGradients(model)


def flush_stale_update(model: Llama, optimizer: torch.optim.Optimizer, reduce_grads):
    """At ``stale_grad=1``: apply the last step's reduced gradients, which
    the hook still holds."""
    if train_collective.set_gradients(model, reduce_grads.flush()):
        optimizer.step()


def step_tokens(
    cfg: LlamaConfig, batch: int, epoch: int, step: int, rank: int, device: torch.device
) -> torch.Tensor:
    """Random tokens (batch, max_seq_len), seeded epoch*10_000 + step*100 +
    rank as the reference seeds its PRNG key (other bits than JAX's). The
    loop passes the rank's data shard as ``rank``."""
    gen = torch.Generator(device=device).manual_seed(epoch * 10_000 + step * 100 + rank)
    return torch.randint(
        0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=gen, device=device
    )


def mesh_axes(config: dict, world_size: int) -> Dict[str, int]:
    """The loop's mesh over ``world_size`` ranks: ``fsdp`` (default: the
    ranks ``dp`` and ``tp`` leave, the reference's ``fsdp = n_dev``), ``tp``
    and ``dp`` (default 1)."""
    dp, tp = config.get("dp", 1), config.get("tp", 1)
    fsdp = config.get("fsdp", world_size // (dp * tp))
    if dp * fsdp * tp != world_size:
        raise ValueError(f"dp={dp} x fsdp={fsdp} x tp={tp} is not the {world_size} ranks")
    return {"dp": dp, "fsdp": fsdp, "tp": tp}


def train_loop_per_worker(config: dict):
    ctx = session.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    device = resolve_device(config.get("device"))
    cfg = model_config(config)
    axes = mesh_axes(config, world)
    # every parameter replicated: one worker in the caller's process, or
    # ``dp`` given with fsdp = tp = 1 (at one rank the layouts are one, and
    # the key picks this path)
    replicated = (not ctx.collective_tensor_group
                  or (axes["fsdp"] == axes["tp"] == 1 and "dp" in config))
    group = train_collective.tensor_group()
    mesh = train_collective.gang_mesh(device, **axes)
    if not replicated:
        if axes["fsdp"] == world:
            # the line is the whole gang: its group is the tensor group, at
            # one rank too (every gather a one-rank op)
            mesh = mesh.bind(mesh.rank, {**mesh.groups, "fsdp": group})
    gen = torch.Generator(device=device).manual_seed(0)
    shard = None if replicated else FSDP.for_llama(cfg, mesh).shard
    params = init_params(cfg, gen, device=device, shard=shard)
    model, lora, optimizer = lora_model(cfg, params, lr=config.get("lr", 1e-4),
                                        mesh=None if replicated else mesh)
    del params
    if replicated:
        reduce_grads = None if group is None else data_parallel_mean(world)
    else:
        reduce_grads = mesh_gradients(model)
    # per-process batch: the global batch must divide over the mesh's data
    # axes, so each rank's rounds to its share of them (one, a rank being a
    # process with one device)
    local_shards = max(mesh.axes_size(BATCH_AXES) // world, 1)
    batch = max(config.get("batch_per_worker", 2), local_shards)
    batch -= batch % local_shards
    data_shard = mesh.axes_index(BATCH_AXES)
    steps = config.get("steps_per_epoch", 4)
    epochs = config.get("epochs", 2)
    # one checkpoint directory for the whole run, overwritten each epoch;
    # report() copies it into the run's storage
    with tempfile.TemporaryDirectory(prefix="lora_ckpt_") as ckpt_dir:
        for epoch in range(epochs):
            for step in range(steps):
                tokens = process_local_batch(
                    mesh, step_tokens(cfg, batch, epoch, step, data_shard, device))
                loss = lora_train_step(model, optimizer, tokens, reduce_grads)
            if reduce_grads is not None and ctx.collective_stale_grad and epoch == epochs - 1:
                flush_stale_update(model, optimizer, reduce_grads)
            full = lora if replicated else model.fsdp.full_state(lora)
            checkpoint = None
            if rank == 0:
                state = {name: p.detach().cpu() for name, p in full.items()}
                with open(os.path.join(ckpt_dir, "lora.pkl"), "wb") as f:
                    pickle.dump({"lora": state, "epoch": epoch}, f)
                checkpoint = Checkpoint.from_directory(ckpt_dir)
            reported = train_collective.gang_mean(loss) if replicated else float(loss)
            session.report({"epoch": epoch, "loss": reported, "rank": rank},
                           checkpoint=checkpoint)


def make_trainer(num_workers: int = 1, train_config: Optional[dict] = None,
                 backend_config: Optional[TorchConfig] = None,
                 resources_per_worker: Optional[dict] = None, **knobs) -> TorchTrainer:
    """The TorchTrainer of this example (reference: ``make_trainer``, whose
    TPU slice arguments have no counterpart). ``knobs`` are the trainer's
    collective knobs (``overlap``, ``bucket_bytes``, ``stale_grad``,
    ``quantized``)."""
    return TorchTrainer(
        train_loop_per_worker,
        train_loop_config=dict(train_config or {}),
        scaling_config=ScalingConfig(num_workers=num_workers,
                                     resources_per_worker=resources_per_worker),
        run_config=RunConfig(name="llama-lora"),
        backend_config=backend_config,
        **knobs,
    )


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="tiny", choices=["tiny", "7b"])
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--num-workers", type=int, default=1)
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args()
    result = make_trainer(
        num_workers=args.num_workers,
        train_config={"model": args.model, "epochs": args.epochs, "device": args.device},
        resources_per_worker={"CPU": 1} if args.device == "cpu" else None,
    ).fit()
    if result.error is not None:
        raise SystemExit(f"training failed: {result.error}")
    print({"final": result.metrics})
