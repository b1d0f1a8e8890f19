"""ResNet via DataParallelTrainer: the port of
ray_tpu/train/examples/resnet.py (BASELINE.json configs[1], "ResNet-50
ImageNet via DataParallelTrainer").

Each step is :func:`train_step`: the forward in train mode (cuDNN
convolutions over channels_last bf16 activations, flax's BatchNorm, which
updates the running statistics in place), ``cross_entropy``,
``loss.backward()`` and SGD with momentum 0.9 over every parameter
(``optax.sgd(lr, momentum=0.9)``: trace = g + 0.9 trace, p -= lr trace).
Data is synthetic, as in the reference.

The reference builds a ``dp`` mesh over every device and shards the batch
over it, so XLA makes BatchNorm's means global (sync-BN) and inserts the
gradient all-reduce. In a gang (more than one worker, or a
``backend_config``) each rank here draws its own rows
(:func:`~ray_tpu_torch.parallel.sharding.process_local_batch` of a
``dp`` mesh over the ranks), the model's BatchNorms all-reduce their
statistics over the run's tensor group (models/resnet.py), the gradients
are summed by ``train.collective.reduce_gradients`` and divided by the
world size, and every rank reports the gang's mean loss.

``train_loop_config`` keys: model ("tiny" | "50"), image_size, epochs,
steps_per_epoch, batch_per_worker, lr, device (None means cuda).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..._internal.device import resolve_device
from ...models.resnet import ResNet, ResNetConfig, build_resnet, cross_entropy, init_train_state
from ...parallel.sharding import process_local_batch
from .. import collective as train_collective
from .. import session
from ..backend import TorchConfig
from ..config import RunConfig, ScalingConfig
from ..trainer import DataParallelTrainer


def model_config(config: dict) -> Tuple[ResNetConfig, int]:
    """The loop's config and image size: ResNet-50 at 224 for "50", else
    the tiny test model at 32."""
    if config.get("model") == "50":
        return ResNetConfig.resnet50(), config.get("image_size", 224)
    return ResNetConfig.tiny(), config.get("image_size", 32)


def sgd_model(
    cfg: ResNetConfig, device: torch.device, lr: float = 0.1, group=None
) -> Tuple[ResNet, torch.optim.SGD]:
    """A ResNet with the seed-0 initial state on ``device`` (sync-BN over
    ``group``'s ranks when given) and SGD with momentum 0.9 (no dampening,
    no Nesterov, no weight decay) over every parameter."""
    params, stats = init_train_state(cfg, torch.Generator(device=device).manual_seed(0), device)
    model = build_resnet(cfg, params, stats, group=group)
    return model, torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)


def train_step(
    model: ResNet, optimizer: torch.optim.Optimizer, images: torch.Tensor, labels: torch.Tensor,
    reduce_grads: Optional[train_collective.DataParallelMean] = None,
) -> torch.Tensor:
    """One step: train-mode forward (running statistics updated), loss,
    backward, SGD update. Returns the loss (detached, on the model's
    device). ``reduce_grads``, when given, maps the gradients to the ones
    SGD applies; None from it skips the update."""
    optimizer.zero_grad(set_to_none=True)
    loss = cross_entropy(model(images, train=True), labels)
    loss.backward()
    if reduce_grads is None or train_collective.set_gradients(
            model, reduce_grads(train_collective.gradients(model))):
        optimizer.step()
    return loss.detach()


def step_batch(
    cfg: ResNetConfig, batch: int, image_size: int, epoch: int, step: int, rank: int,
    device: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normal NHWC images (batch, image_size, image_size, 3) f32 and labels,
    seeded epoch*10_000 + step*100 + rank as the reference seeds its PRNG
    key (other bits than JAX's)."""
    gen = torch.Generator(device=device).manual_seed(epoch * 10_000 + step * 100 + rank)
    images = torch.randn((batch, image_size, image_size, 3), generator=gen, device=device)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen, device=device)
    return images, labels


def train_loop_per_worker(config: dict):
    ctx = session.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    device = resolve_device(config.get("device"))
    cfg, image_size = model_config(config)
    group = train_collective.tensor_group()
    mesh = train_collective.gang_mesh(device, dp=world)
    model, optimizer = sgd_model(cfg, device, lr=config.get("lr", 0.1), group=group)
    # per-process batch, rounded as the reference rounds it so the global
    # batch divides over dp (a rank is a process with one device here)
    local_shards = max(mesh.size // world, 1)
    batch = max(config.get("batch_per_worker", 8), local_shards)
    batch -= batch % local_shards
    reduce_grads = None
    if group is not None:
        sizes = train_collective.allgather(batch)
        if len(set(sizes)) != 1:
            raise ValueError(f"sync-BN and the gradient mean need equal local batches, got {sizes}")
        reduce_grads = train_collective.DataParallelMean(world)
    steps = config.get("steps_per_epoch", 4)
    epochs = config.get("epochs", 2)
    for epoch in range(epochs):
        for step in range(steps):
            images, labels = step_batch(cfg, batch, image_size, epoch, step, rank, device)
            loss = train_step(model, optimizer, process_local_batch(mesh, images),
                              process_local_batch(mesh, labels), reduce_grads)
        if reduce_grads is not None and ctx.collective_stale_grad and epoch == epochs - 1:
            if train_collective.set_gradients(model, reduce_grads.flush()):
                optimizer.step()
        session.report({"epoch": epoch, "loss": train_collective.gang_mean(loss), "rank": rank})


def make_trainer(num_workers: int = 1, train_config: Optional[dict] = None,
                 backend_config: Optional[TorchConfig] = None,
                 resources_per_worker: Optional[dict] = None, **knobs) -> DataParallelTrainer:
    """The DataParallelTrainer of this example (reference: ``make_trainer``,
    whose TPU slice arguments have no counterpart). ``knobs`` are the
    trainer's collective knobs (``overlap``, ``bucket_bytes``,
    ``stale_grad``, ``quantized``)."""
    return DataParallelTrainer(
        train_loop_per_worker,
        train_loop_config=dict(train_config or {}),
        scaling_config=ScalingConfig(num_workers=num_workers,
                                     resources_per_worker=resources_per_worker),
        run_config=RunConfig(name="resnet"),
        backend_config=backend_config,
        **knobs,
    )


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="tiny", choices=["tiny", "50"])
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
