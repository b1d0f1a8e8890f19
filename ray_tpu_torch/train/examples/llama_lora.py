"""Llama LoRA fine-tune through TorchTrainer: the port of
ray_tpu/train/examples/llama_lora.py (BASELINE.json config 3, "Llama-2-7B
LoRA fine-tune via JaxTrainer").

Each step is :func:`lora_train_step`: ``next_token_loss`` through the
full-sequence forward (RMSNorm and flash-attention forward kernels), with
every block recomputed in the backward (``remat``), ``loss.backward()``
through the flash-attention backward kernels, and AdamW on the adapters
only. The base weights are frozen: no gradients, no optimizer state.

In a gang (more than one worker, or a ``backend_config``) the loop builds
the reference's mesh over the ranks: ``fsdp`` (default: the world size) x
``tp`` (default 1; tp > 1 raises: tensor-parallel training is ROADMAP item
11), and, beyond the reference's keys, ``dp`` (default 1), the ranks that
replicate every parameter. Each rank draws its own rows
(``process_local_batch``).

- By default (the reference's mesh) every rank stores only its block of
  each parameter the rule table sends to ``fsdp`` (the frozen base and
  the adapter matrices with an ``embed`` axis; parallel/fsdp.py), gathered
  block by block in the forward and again in the recompute; the gathered
  adapter blocks' gradients arrive reduce-scattered. At one rank the
  gathers are one-rank ops.
- With ``dp`` given and fsdp = 1 (``dp`` = the world size), every
  parameter is replicated.

Either way the replicated adapters' gradients are summed across the gang
by ``train.collective.reduce_gradients``, every gradient is divided by the
world size once (the reference's loss is the mean over the global batch,
and XLA reduces the gradient in the graph), and AdamW updates the rank's
own tensors (elementwise: the replicated run's update, up to the order of
the gradient sums). Every rank reports the mean of the ranks' last-step
losses, the loss over the global batch. At ``stale_grad=1`` the first step
skips the update and the last step's gradients are applied after the
loop's last step. The epoch's ``lora.pkl`` holds the full adapters,
gathered to rank 0.

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
        max_seq_len=config.get("seq", 128), lora_rank=config.get("lora_rank", 4), remat=True,
    )


def lora_model(
    cfg: LlamaConfig, params: Dict[str, torch.Tensor], lr: float = 1e-4,
    fsdp: Optional[FSDP] = None, mesh=None,
) -> Tuple[Llama, Dict[str, torch.nn.Parameter], torch.optim.AdamW]:
    """A Llama over ``params`` whose adapters train and whose base stays
    frozen, the adapters by name, and AdamW over the adapters alone. The
    adapters are leaf parameters in ``cfg.param_dtype``, as are their AdamW
    moments. The hyperparameters are optax.adamw's defaults (weight decay
    1e-4, not torch's 0.01). With ``fsdp``, ``params`` are this rank's
    blocks (``fsdp.shard``) and the model gathers them; with a bound
    sequence-parallel ``mesh`` the model splits each sequence over its
    ``sp`` group (``Llama(config, mesh)``), and the gradients summed over
    the group (``train.collective.reduce_gradients``) are the loss's."""
    model = build_llama(cfg, params, mesh) if fsdp is None else fsdp.build_llama(cfg, params)
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


def data_parallel_mean(world_size: int, sharded=()) -> train_collective.DataParallelMean:
    """The gang's gradient hook (``train.collective.DataParallelMean``):
    the sum over the ranks through ``train.collective.reduce_gradients``,
    divided by ``world_size``; ``sharded`` names FSDP blocks, whose
    gradients arrive summed. With every rank's batch of one size, that is
    the gradient of the mean loss over the global batch, the reference's.
    None at ``stale_grad=1``'s first step."""
    return train_collective.DataParallelMean(world_size, sharded)


def flush_stale_update(model: Llama, optimizer: torch.optim.Optimizer,
                       reduce_grads: train_collective.DataParallelMean):
    """At ``stale_grad=1``: apply the last step's reduced gradients, which
    the hook still holds."""
    if train_collective.set_gradients(model, reduce_grads.flush()):
        optimizer.step()


def step_tokens(
    cfg: LlamaConfig, batch: int, epoch: int, step: int, rank: int, device: torch.device
) -> torch.Tensor:
    """Random tokens (batch, max_seq_len), seeded epoch*10_000 + step*100 +
    rank as the reference seeds its PRNG key (other bits than JAX's)."""
    gen = torch.Generator(device=device).manual_seed(epoch * 10_000 + step * 100 + rank)
    return torch.randint(
        0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=gen, device=device
    )


def mesh_axes(config: dict, world_size: int) -> Dict[str, int]:
    """The loop's mesh over ``world_size`` ranks: ``fsdp`` (default: the
    ranks ``dp`` and ``tp`` leave, the reference's ``fsdp = n_dev``), ``tp``
    and ``dp`` (default 1). Layouts the port cannot train raise."""
    dp, tp = config.get("dp", 1), config.get("tp", 1)
    fsdp = config.get("fsdp", world_size // (dp * tp))
    if tp > 1:
        raise NotImplementedError(
            f"tensor-parallel training (tp={tp}) is not ported: ROADMAP item 11 (serving "
            "runs tensor-parallel through LLMServer(tensor_parallel_size=))")
    if dp > 1 and fsdp > 1:
        raise NotImplementedError(
            f"dp={dp} x fsdp={fsdp}: the LoRA loop's FSDP within data-parallel replicas, "
            "over the gang's sub-groups (Mesh.form_groups), is ROADMAP item 11; use "
            f"fsdp={world_size} or dp={world_size}")
    return {"dp": dp, "fsdp": fsdp, "tp": tp}


def train_loop_per_worker(config: dict):
    ctx = session.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    device = resolve_device(config.get("device"))
    cfg = model_config(config)
    group = train_collective.tensor_group()
    axes = mesh_axes(config, world)
    mesh = train_collective.gang_mesh(device, **axes)
    fsdp = None
    # FSDP unless ``dp`` is given with fsdp = 1 (at one rank the two layouts
    # are one, and the key picks the replicated path)
    if group is not None and (axes["fsdp"] > 1 or "dp" not in config):
        fsdp = FSDP.for_llama(cfg, mesh.bind(rank, {"fsdp": group}))
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device=device, shard=None if fsdp is None else fsdp.shard)
    model, lora, optimizer = lora_model(cfg, params, lr=config.get("lr", 1e-4), fsdp=fsdp)
    del params
    reduce_grads = None
    if group is not None:
        reduce_grads = data_parallel_mean(world, () if fsdp is None else fsdp.sharded)
    # per-process batch: the global batch must divide over the mesh's data
    # axes, so each rank's rounds to its share of them (one, a rank being a
    # process with one device)
    local_shards = max((axes["dp"] * axes["fsdp"]) // world, 1)
    batch = max(config.get("batch_per_worker", 2), local_shards)
    batch -= batch % local_shards
    steps = config.get("steps_per_epoch", 4)
    epochs = config.get("epochs", 2)
    # one checkpoint directory for the whole run, overwritten each epoch;
    # report() copies it into the run's storage
    with tempfile.TemporaryDirectory(prefix="lora_ckpt_") as ckpt_dir:
        for epoch in range(epochs):
            for step in range(steps):
                tokens = process_local_batch(mesh, step_tokens(cfg, batch, epoch, step, rank,
                                                               device))
                loss = lora_train_step(model, optimizer, tokens, reduce_grads)
            if reduce_grads is not None and ctx.collective_stale_grad and epoch == epochs - 1:
                flush_stale_update(model, optimizer, reduce_grads)
            full = lora if fsdp is None else fsdp.full_state(lora)
            checkpoint = None
            if rank == 0:
                state = {name: p.detach().cpu() for name, p in full.items()}
                with open(os.path.join(ckpt_dir, "lora.pkl"), "wb") as f:
                    pickle.dump({"lora": state, "epoch": epoch}, f)
                checkpoint = Checkpoint.from_directory(ckpt_dir)
            session.report(
                {"epoch": epoch, "loss": train_collective.gang_mean(loss), "rank": rank},
                checkpoint=checkpoint,
            )


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
