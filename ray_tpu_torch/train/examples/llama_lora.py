"""Llama LoRA fine-tune through TorchTrainer: the port of
ray_tpu/train/examples/llama_lora.py (BASELINE.json config 3, "Llama-2-7B
LoRA fine-tune via JaxTrainer").

Each step is :func:`lora_train_step`: ``next_token_loss`` through the
full-sequence forward (RMSNorm and flash-attention forward kernels), with
every block recomputed in the backward (``remat``), ``loss.backward()``
through the flash-attention backward kernels, and AdamW on the adapters
only. The base weights are frozen: no gradients, no optimizer state.

With more than one worker (a tensor group in the context) the adapters'
gradients are summed across the gang by ``train.collective.
reduce_gradients`` between ``backward()`` and AdamW, and divided by the
world size: the reference's ``train_step`` runs under ``jax.distributed``,
where the loss is the mean over the global batch and XLA reduces the
gradient in the graph. The parameters stay replicated (FSDP sharding is
ROADMAP item A.5). At ``stale_grad=1`` the first step skips the update and
the last step's gradients are applied after the loop's last step.

``train_loop_config`` keys: model ("tiny" | "7b"), epochs, steps_per_epoch,
batch_per_worker, seq, lora_rank, lr, device (None means cuda). The
reference's mesh keys (fsdp, tp) wait for the port's parallel slices.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..._internal.device import resolve_device
from ...models.llama import Llama, LlamaConfig, build_llama, init_params, next_token_loss
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
    cfg: LlamaConfig, params: Dict[str, torch.Tensor], lr: float = 1e-4
) -> Tuple[Llama, Dict[str, torch.nn.Parameter], torch.optim.AdamW]:
    """A Llama over ``params`` whose adapters train and whose base stays
    frozen, the adapters by name, and AdamW over the adapters alone. The
    adapters are leaf parameters in ``cfg.param_dtype``, as are their AdamW
    moments. The hyperparameters are optax.adamw's defaults (weight decay
    1e-4, not torch's 0.01)."""
    model = build_llama(cfg, params)
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
    if reduce_grads is None or _apply(model, reduce_grads(_grads(model))):
        optimizer.step()
    return loss.detach()


def _grads(model: Llama) -> Dict[str, torch.Tensor]:
    return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def _apply(model: Llama, grads: Optional[Mapping[str, torch.Tensor]]) -> bool:
    """Set the parameters' gradients to ``grads``; False for None."""
    if grads is None:
        return False
    for name, p in model.named_parameters():
        if name in grads:
            p.grad = grads[name]
    return True


def data_parallel_mean(world_size: int) -> GradReducer:
    """The gang's gradient hook: the sum over the ranks through
    ``train.collective.reduce_gradients``, divided by ``world_size``. With
    every rank's batch of one size, that is the gradient of the mean loss
    over the global batch, the reference's. None at ``stale_grad=1``'s
    first step."""

    def reduce(grads: Mapping[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
        return _mean(train_collective.reduce_gradients(grads), world_size)

    return reduce


def _mean(summed: Optional[Dict[str, torch.Tensor]], world_size: int):
    if summed is None:
        return None
    return {name: g.div_(world_size) for name, g in summed.items()}


def flush_stale_update(model: Llama, optimizer: torch.optim.Optimizer, world_size: int):
    """At ``stale_grad=1``: apply the last step's reduced gradients, which
    the scheduler still holds."""
    if _apply(model, _mean(train_collective.gradient_scheduler().flush(), world_size)):
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


def train_loop_per_worker(config: dict):
    ctx = session.get_context()
    rank = ctx.get_world_rank()
    device = resolve_device(config.get("device"))
    cfg = model_config(config)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    model, lora, optimizer = lora_model(cfg, params, lr=config.get("lr", 1e-4))
    del params
    batch = config.get("batch_per_worker", 2)
    steps = config.get("steps_per_epoch", 4)
    epochs = config.get("epochs", 2)
    reduce_grads = data_parallel_mean(ctx.world_size) if ctx.collective_tensor_group else None
    # one checkpoint directory for the whole run, overwritten each epoch;
    # report() copies it into the run's storage
    with tempfile.TemporaryDirectory(prefix="lora_ckpt_") as ckpt_dir:
        for epoch in range(epochs):
            for step in range(steps):
                tokens = step_tokens(cfg, batch, epoch, step, rank, device)
                loss = lora_train_step(model, optimizer, tokens, reduce_grads)
            if reduce_grads is not None and ctx.collective_stale_grad and epoch == epochs - 1:
                flush_stale_update(model, optimizer, ctx.world_size)
            checkpoint = None
            if rank == 0:
                state = {name: p.detach().cpu() for name, p in lora.items()}
                with open(os.path.join(ckpt_dir, "lora.pkl"), "wb") as f:
                    pickle.dump({"lora": state, "epoch": epoch}, f)
                checkpoint = Checkpoint.from_directory(ckpt_dir)
            session.report(
                {"epoch": epoch, "loss": float(loss), "rank": rank}, checkpoint=checkpoint
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
