#!/usr/bin/env python3
"""NCCL collectives and data-parallel training across the cards of one host.

    python3 chip_multicard.py        # from the root of the repository, 2+ cards

``chip_smoke.py`` checks the collectives where one card can: NCCL at world
size 1 (where an allreduce moves nothing) and gloo ranks sharing the card.
This script runs what exists only across cards, with n =
``torch.cuda.device_count()`` spawned workers, one card each, through the
port's ``TorchTrainer`` (``TorchConfig(backend="nccl")``):

1. every op of the run's ``NcclGroup``, bf16 and f32, at 4 MiB and at the
   7B adapters' 33.5 MB gradient, each rank remaking every rank's input
   from seeds on its own card: SUM allreduce and reducescatter within n
   roundings of the sum of magnitudes (an f64 sum is the reference), MIN,
   MAX, allgather, broadcast and a send/recv ring exact; 3 rounds of the
   quantized allreduce bit for bit the codec's formula over all ranks, the
   residual carried; each op timed (host clock around ops that
   synchronize, median of 10), with the algorithm and bus rates of
   nccl-tests' conventions;
2. ``chip_smoke.train_dp_loop`` (the llama_lora loop at full Llama-2-7B
   width, seq 2048, batch 2 a worker, then timed and profiled steps) at 1
   worker and at n: each worker's K1-K4 launches exact, 8 allreduce ops a
   step of 33.5 MB, the NCCL kernels a profiled step launches, step ms and
   the weak-scaling efficiency (1-worker step ms over n-worker step ms at
   the same per-worker batch), the exposed / overlapped split;
3. tensor-parallel serving over NCCL (``LLMServer(tensor_parallel_size=m,
   devices=range(m), tp_backend="nccl")``, m = 2 and 4 where the cards
   allow) at full Llama-2-7B width on ``chip_smoke``'s serve_tp traffic
   (8 requests of a shared 128-token prefix + 32 own tokens, 16 new, from 4
   threads), against tp=1 on card 0 with the same random weights: greedy
   tokens to their first parting from tp=1, decode ms/step, tokens/s and
   TTFT against tp=1, the NCCL kernels a pooled step launches on rank 0
   (one model call: 65 allreduces and 1 all-gather), K1 65 a model call on
   every rank, and the weight and pool bytes a card; then ``chip_smoke``'s
   serve_tp_features (d) over NCCL on cards 0 and 1: serve_lora's
   multi-tenant traffic through a tp=2 server with 8 adapter slots (each
   rank's bank the plan's slice of a tp=1 bank, the salted accounting,
   tokens/s, pooled step ms mixed against all -1, cold attach ms). It runs
   first: its servers form this process's default process group, and
   close it;
4. ``chip_smoke.train_resnet_dp_loop`` (ResNet-50 with sync-BN, b=256 a
   rank, SGD through ``DataParallelMean``) at 1 worker and at n: 106
   sync-BN allreduces and the 102,228,128 B gradient a step on every rank,
   images/s and the weak-scaling efficiency;
5. ``chip_smoke.train_fsdp_loop`` (the llama_lora loop at its default mesh,
   FSDP at fsdp = n, full Llama-2-7B width, seq 2048, batch 2 a worker):
   K1-K4 exact, step ms and peak memory a rank against part 2's replicated
   n-worker run;
6. sequence parallelism over NCCL (``sp_loop``): the 7B LoRA step (all 32
   layers, rank 16, remat, bf16) at b=2 x 4096 with the sequence split
   over sp = 2 and 4 cards (``Llama(config, mesh)``, ring attention over
   the mesh's group, the gradients summed over it), against the same step
   on one card; then b=1 x 16,384 at sp = 4 (``max_seq_len`` 16,384, past
   Llama-2's published 4,096: a memory and throughput reading only). Each
   rank's K1-K4 launches a step exact (K2 2L(r + 1), K3 and K4 L(sp - r)),
   step ms, tokens/s and peak a rank, and the shifts' bytes and the time
   the stream waited on them (CUDA events around each wait) as a share of
   the step; then one more step on rank 0 with the allocator's history
   recorded (``memory_at_peak``): what the step holds at its peak, by the
   code that allocated it.

7. the ViT and the MoE over meshes across cards (``mesh_loop``):
   Mixtral-8x7B at full width, 4 layers, b=2 x 4096, remat, bf16
   parameters, at ep=2 x tp=2 over 4 cards (each rank 4 experts at half
   their hidden units, 16 heads; the batch replicated), and ViT-B/16 at 224,
   global batch 128, at dp=2 x tp=2; each against the same step on one card
   (the model over a one-rank mesh): K1-K4 a step exact on every rank,
   step ms, tokens or images a second and peak a rank, and one profiled
   step on every rank (device busy share, NCCL kernels' ms).

8. the Llama over the reference's training mesh across cards
   (``tp_loop``): the llama_lora loop itself (``train_loop_per_worker``,
   what ``make_trainer`` runs) at full Llama-2-7B width and all 32 layers,
   seq 2048, batch 2 a data shard, 3 steps (the first a warm-up), at
   ``tp=2 x fsdp=2``, ``tp=4`` and ``dp=2 x fsdp=2`` over 4 cards, beside
   the same loop on one card and at ``fsdp=4``; then the 7B model at
   ``sp=2 x tp=2`` (``Llama(config, gang_mesh(device, sp=2, tp=2))``
   through the loop's ``lora_model``, ``lora_train_step`` and
   ``mesh_gradients``, b=2 x 4096). Each rank's K1-K4 launches a step
   exact, step ms, tokens a second (the global batch's) and peak a rank;
   losses finite and equal across the ranks.

9. the rest of the port's queue across cards: (a) GPipe at pp=4 over NCCL
   (``pipe_loop``: ``parallel.pipeline_apply``, 8 full-width Llama-2-7B
   decoder blocks a stage in bf16, 8 microbatches of 1 x 2048 hidden
   states, forward and backward of a weighted mean) against one card
   holding all 32 blocks at the same microbatches (each through the 32 in
   turn): step ms and the wall over one card's, the output's and the
   gradients' relative distance from the one-card run's, K1-K4 a step exact,
   peak a rank; (b) ``HierarchicalGroup`` at 2 slices of 2 cards (NCCL
   inside a slice, gloo between the leaders; ``hier_loop``) against the flat
   NCCL allreduce at 33,554,432 B: equal on integer values, within f32
   rounding on random ones, ms of each; (c) the MoE of part 7 at sp=2 x
   ep=2 (4 layers, the ring over sp) beside part 7's one-card step (part 7
   runs it with part 9).

10. the runtime core across the cards (``runtime_part``):
   ``ray_tpu_torch.init()`` finds n GPUs; n ``num_gpus=1`` actors
   (``CardActor``) each report their lease's ids and
   ``torch.cuda.current_device()``, all different, and allocate 1 GiB, which
   grows ``torch.cuda.memory_allocated`` on their own card only (and, where
   ``nvidia-smi`` shows this container's process ids, each actor's process
   sits on its own card alone); then a tensor one actor keeps on its card
   (``tensor_transport="device"``) is resolved by an actor on another card:
   fetched through the hosts, landed on the getter's card, equal to the
   source bit for bit. ``ray_tpu`` drops its leases' device ids, so all n
   would run on card 0.
11. the serve control plane across the cards (``serve_part``):
   ``serve.run(build_llm_deployment(...))`` of n replicas of
   ``chip_smoke``'s serve_cb server (Llama-2-7B width, ``SERVE_LAYERS``
   layers, seed-0 bf16 weights drawn in each replica), each leasing
   {"CPU": 1, "GPU": 1}: every replica's lease names a card of its own
   and its weights sit on it (the replicas' mesh cards); then one request
   sent to each replica's actor answers with the tokens of a one-card
   in-process server on card 0 (the same seed, the same request).

    python3 chip_multicard.py 3      # part 3 alone (no argument: all eleven;
                                     # several, as in "4 5", run those)

Prints the cards' names and power limits, one JSON line per part, and
ends with an ``{"ok": true, ...}`` line. Exits non-zero with fewer than 2
cards or on any failed check. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
QUANT_ROUNDS = 3
# part 6: (sp, batch, global seq) runs of the 32-layer 7B LoRA step, timed
# over 3 steps after a warm-up
SP_RUNS = ((1, 2, 4096), (2, 2, 4096), (4, 2, 4096), (4, 1, 16384))
SP_TIMED_STEPS = 3
# part 7: (model, mesh axes) runs, each timed over 3 steps after a warm-up;
# the one-card runs ({}) first
MESH_RUNS = (("moe", {}), ("moe", {"ep": 2, "tp": 2}), ("vit", {}),
             ("vit", {"dp": 2, "tp": 2}))
# part 9 (c): the MoE under sequence parallelism, beside part 7's one card
MESH_SP_RUNS = (("moe", {}), ("moe", {"sp": 2, "ep": 2}))
# part 9 (a): the pipeline's stages (32 blocks over 4 cards, 8 a stage) and
# its timed steps after a warm-up; (b): the allreduce's timed repeats
PIPE_CARDS = {"stages": 4, "layers": 32, "timed_steps": 2}
HIER_REPS = 10
MESH_MOE = {"n_layers": 4, "batch": 2, "seq": 4096, "lr": 1e-3}
MESH_TIMED_STEPS = 3
# part 8: (name, loop config) runs of the 7B LoRA loop at 32 layers, each
# 3 steps, the first a warm-up; the one-card and fsdp=4 runs first
TP_LOOP = {"model": "7b", "seq": 2048, "batch_per_worker": 2, "lora_rank": 16, "epochs": 1,
           "steps_per_epoch": 3}
TP_RUNS = (("one_card", {}), ("fsdp4", {"fsdp": 4}), ("tp2_fsdp2", {"tp": 2, "fsdp": 2}),
           ("tp4", {"tp": 4, "fsdp": 1}), ("dp2_fsdp2", {"dp": 2, "fsdp": 2}),
           ("sp2_tp2", {"sp": 2, "tp": 2, "batch": 2, "seq": 4096}))
# memory_at_peak: the allocation sites it lists, the largest first
PEAK_SITES = 12
EPS = {"torch.bfloat16": 2.0 ** -8, "torch.float32": 2.0 ** -24}


def nccl_ops_loop(config):
    """In each worker: every op of the run's tensor group against this
    rank's recomputation of all ranks' inputs; rank 0's timings."""
    import torch
    import torch.distributed as dist

    import chip_smoke as C
    from ray_tpu_torch import collective as col
    from ray_tpu_torch import train
    from ray_tpu_torch._internal.quantization import dequantize_torch, quantize_torch
    from ray_tpu_torch.collective import ReduceOp

    ctx = train.get_context()
    n, r = ctx.world_size, ctx.world_rank
    g = col.get_group(ctx.collective_tensor_group)
    device = torch.device("cuda", torch.cuda.current_device())

    def inputs(dtype, numel, seed):
        return [torch.randn(numel, generator=torch.Generator(device=device).manual_seed(
            seed * 100 + k), device=device).to(dtype) for k in range(n)]

    rows, errors = [], []
    seed = 0
    for dtype in (torch.bfloat16, torch.float32):
        for nbytes in C.DP_OP_BYTES:
            seed += 1
            numel = nbytes // torch.empty((), dtype=dtype).element_size()
            xs = inputs(dtype, numel, seed)
            x, stacked = xs[r], torch.stack(xs)
            exact = stacked.double().sum(dim=0)
            # n roundings, each within an ulp of the running sum of magnitudes
            tol = n * EPS[str(dtype)] * stacked.double().abs().sum(dim=0)
            share = numel // n
            checks = {
                "allreduce_sum": (lambda: g.allreduce(x), lambda o: (o.double() - exact).abs() <= tol),
                "allreduce_min": (lambda: g.allreduce(x, ReduceOp.MIN),
                                  lambda o: o == stacked.amin(dim=0)),
                "allreduce_max": (lambda: g.allreduce(x, ReduceOp.MAX),
                                  lambda o: o == stacked.amax(dim=0)),
                "allgather": (lambda: g.allgather(x), lambda o: o == torch.cat(xs)),
                "reducescatter": (lambda: g.reducescatter(x),
                                  lambda o: (o.double() - exact[r * share:(r + 1) * share]).abs()
                                  <= tol[r * share:(r + 1) * share]),
                "broadcast": (lambda: g.broadcast(x, src_rank=n - 1), lambda o: o == xs[n - 1]),
            }
            for op, (fn, ok) in checks.items():
                if not bool(ok(fn()).all()):
                    errors.append(f"{op} {dtype} {nbytes} B")
                ms = C._host_ms(torch, fn)
                # nccl-tests: algbw over the larger buffer; busbw scales it
                # by the share of bytes each rank moves over its links
                algbw = (n * nbytes if op == "allgather" else nbytes) / ms / 1e6
                factor = {"allreduce_sum": 2 * (n - 1) / n, "allreduce_min": 2 * (n - 1) / n,
                          "allreduce_max": 2 * (n - 1) / n, "allgather": (n - 1) / n,
                          "reducescatter": (n - 1) / n, "broadcast": 1.0}[op]
                rows.append(dict(op=op, dtype=str(dtype), bytes=nbytes, ms=ms,
                                 algbw_gb_s=algbw, busbw_gb_s=algbw * factor))
            # a ring of point-to-point sends: even ranks send first
            nxt, prv = (r + 1) % n, (r - 1) % n
            if r % 2 == 0:
                g.send(x, nxt)
                got = g.recv(prv)
            else:
                got = g.recv(prv)
                g.send(x, nxt)
            if not torch.equal(got, xs[prv]):
                errors.append(f"recv {dtype} {nbytes} B")
    # the quantized allreduce: every rank's codes, summed in f32 as the
    # group sums them, the residuals carried
    q = col.init_collective_group(n, r, backend="nccl", group_name="q", quantized=True)
    numel = C.DP_OP_BYTES[1] // 2
    residuals = [None] * n
    for t in range(QUANT_ROUNDS):
        xs = inputs(torch.bfloat16, numel, 1000 + t)
        out = q.allreduce(xs[r])
        deq = []
        for k in range(n):
            comp = xs[k].float() if residuals[k] is None else xs[k].float() + residuals[k]
            codes, scales = quantize_torch(comp, q.quant_block)
            deq.append(dequantize_torch(codes, scales, comp.shape, torch.float32))
            residuals[k] = comp - deq[k]
        if not torch.equal(out, torch.stack(deq).sum(dim=0).to(torch.bfloat16)):
            errors.append(f"quantized round {t}")
        if not torch.equal(q._ef_residuals[("allreduce", (numel,), "torch.bfloat16")],
                           residuals[r]):
            errors.append(f"quantized residual round {t}")
    quant_ms = C._host_ms(torch, lambda: q.allreduce(xs[r]))
    dist.barrier()
    train.report({"rank": r, "errors": errors, "ops": rows if r == 0 else [],
                  "quantized_ms": quant_ms})


def tp_part(torch, np, C, n: int) -> None:
    """3: tensor-parallel serving over NCCL at tp = 2 and 4 (as many as the
    cards allow) against tp = 1."""
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.models.llama import init_params

    torch.cuda.set_device(0)
    cfg = C.tp_config(torch).build_model_config()
    params = init_params(cfg, device="cuda")
    ref = LLMServer(C.tp_config(torch), params=params)
    tp1 = C.tp_serve(torch, ref, C.tp_traffic(np))
    want = tp1.pop("tokens")
    del ref
    torch.cuda.empty_cache()
    out = {"tp1": tp1}
    per_call = 2 * cfg.n_layers + 1
    for tp in (m for m in (2, 4) if m <= n):
        server = LLMServer(C.tp_config(torch, tensor_parallel_size=tp), params=params,
                           devices=list(range(tp)), tp_backend="nccl")
        counts0 = server.ranks.run(C.tp_counts)
        got = C.tp_serve(torch, server, C.tp_traffic(np), profile_groups={"nccl": ("nccl",)})
        counts1 = server.ranks.run(C.tp_counts)
        for rank, (c0, c1) in enumerate(zip(counts0, counts1)):
            calls, k1 = (c1[k] - c0[k] for k in ("forward_calls", "rmsnorm_fwd"))
            C.check(calls > 0 and k1 == per_call * calls,
                    f"tp={tp} rank {rank}: K1 {k1} in {calls} model calls")
        nccl = got["profile"]["groups_launches"]["nccl"]
        C.check(nccl == per_call + 1, f"tp={tp}: {nccl} NCCL kernels in a pooled step, "
                                      f"want {per_call} allreduces + 1 all-gather")
        C.check(server.ranks.failed is None, f"tp={tp}: {server.ranks.failed}")
        weight_bytes = sum(t.numel() * t.element_size() for t in server.engine._params.values())
        server.close()
        del server
        torch.cuda.empty_cache()
        C._no_tp_left(torch)
        # over NCCL the model's collectives do not wait, so the host's clock
        # reads only their launches: the profile's NCCL device time stands
        # in for their share
        for k in ("collective_ms_per_step", "allreduce_share_of_step"):
            got.pop(k)
        got["nccl_share_of_profiled_step"] = (got["profile"]["groups_ms"]["nccl"]
                                              / got["profile"]["wall_ms"])
        got["profile"] = {k: got["profile"][k] for k in (
            "wall_ms", "device_busy_ms", "device_busy_share", "kernel_launches",
            "groups_launches", "groups_ms", "groups_top")}
        out[f"tp{tp}"] = dict(
            got, weight_bytes_per_card=weight_bytes,
            first_parting_vs_tp1=[C._first_parting(a, b)
                                  for a, b in zip(got.pop("tokens"), want)],
            decode_ms_vs_tp1=got["decode_ms_per_step_8_slots"] / tp1["decode_ms_per_step_8_slots"],
            tokens_per_s_vs_tp1=got["tokens_per_s"] / tp1["tokens_per_s"],
            ttft_miss_vs_tp1=got["ttft_ms_miss"] / tp1["ttft_ms_miss"])
    # multi-tenant serving at tp=2 over NCCL; the tp=1 numbers of the same
    # traffic are chip_smoke's serve_lora's, the accounting is exact
    tp1_lora = dict(prefix_hit_tokens=2816, prefill_tokens_computed=2304, tokens_per_s=None,
                    step_ms_mixed=None, step_ms_base=None)
    out["lora_tp2"], _ = C.tp_lora(torch, np, params, C.tp_lora_reference(torch, np), tp1_lora,
                                   devices=(0, 1), backend="nccl")
    print("multicard tp", json.dumps(out))


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_multicard: FAIL: needs 2 or more NVIDIA cards", file=sys.stderr)
        sys.exit(1)
    if not (ROOT / "chip_smoke.py").is_file():
        print("chip_multicard: FAIL: no chip_smoke.py beside this script", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from ray_tpu_torch._internal import kernels
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchConfig, TorchTrainer

    n = torch.cuda.device_count()
    parts = set(sys.argv[1:]) or {str(i) for i in range(1, 12)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print("cards:", smi.replace("\n", " | "))
    print(f"torch {torch.__version__} cuda {torch.version.cuda} cards {n}")
    print(f"build: {kernels.build():.3f} s")

    def fit(loop, workers, config=None):
        with tempfile.TemporaryDirectory(prefix="chip_multicard_") as storage:
            t0 = time.perf_counter()
            result = TorchTrainer(
                loop, train_loop_config=dict(config or {}),
                scaling_config=ScalingConfig(num_workers=workers),
                backend_config=TorchConfig(backend="nccl"), overlap=True,
                run_config=RunConfig(name="multicard", storage_path=storage)).fit()
            if result.error is not None:
                raise result.error
            return result, time.perf_counter() - t0

    if "3" in parts:
        tp_part(torch, np, C, n)
    if "1" in parts:
        ops_part(C, fit, n)
    runs = train_part(C, fit, n) if "2" in parts else None
    if "4" in parts:
        resnet_part(C, fit, n)
    if "5" in parts:
        fsdp_part(C, fit, n, runs)
    if "6" in parts:
        sp_part(C, fit, n)
    if "7" in parts or "9" in parts:
        mesh_part(C, fit, n, parts)
    if "8" in parts:
        tp_train_part(C, fit, n)
    if "9" in parts:
        pipe_part(C, fit, n)
        hier_part(C, fit, n)
    if "10" in parts:
        runtime_part(torch, C, n)
    if "11" in parts:
        serve_part(torch, np, C, n)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": n}}))


def ops_part(C, fit, n: int) -> None:
    """1: the ops at n ranks."""
    result, fit_s = fit(nccl_ops_loop, n)
    reports = [m for m in result.metrics_history if "errors" in m]
    ops = next(m for m in reports if m["rank"] == 0)
    for row in ops["ops"]:
        print("multicard op", json.dumps(row))
    print("multicard ops", json.dumps({"ranks": n, "fit_s": fit_s, "quantized_ms": [
        m["quantized_ms"] for m in reports], "errors": [m["errors"] for m in reports]}))
    C.check(len(reports) == n, f"{len(reports)} of {n} ranks reported")
    C.check(not any(m["errors"] for m in reports), f"failed checks {[m['errors'] for m in reports]}")


def train_part(C, fit, n: int) -> dict:
    """2: the 7B LoRA loop, replicated, at 1 worker and at n."""
    runs = {}
    for workers in (1, n):
        result, fit_s = fit(C.train_dp_loop, workers, C.TRAIN_CONFIG)
        stats = [m["dp_stats"] for m in result.metrics_history if "dp_stats" in m]
        losses = [m["loss"] for m in result.metrics_history if "loss" in m]
        C.check(len(stats) == workers and len(losses) == workers * C.TRAIN_CONFIG["epochs"],
                f"{len(stats)} stats and {len(losses)} losses from {workers} workers")
        runs[workers] = dict(
            fit_s=fit_s, losses=losses,
            step_ms_median=[statistics.median(s["step_ms"]) for s in stats],
            launches=[s["launches"] for s in stats], allreduce=[s["summary"]["allreduce"] for s in stats],
            overlap=[s["overlap"] for s in stats], peak_bytes=[s["peak_bytes"] for s in stats],
            nccl_kernels=[s["profile"]["groups_launches"]["nccl"] for s in stats],
            nccl_top=stats[0]["profile"]["groups_top"]["nccl"],
            busy_share=[s["profile"]["device_busy_share"] for s in stats])
    one, many = runs[1], runs[n]
    efficiency = max(one["step_ms_median"]) / max(many["step_ms_median"])
    print("multicard train", json.dumps({"runs": runs, "weak_scaling_efficiency": efficiency}))
    n_layers = 32
    want = {"rmsnorm_fwd": 4 * n_layers + 1, "flash_attention_fwd": 2 * n_layers,
            "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers}
    for workers, run in runs.items():
        for launches in run["launches"]:
            C.check(launches == {k: v * C.TRAIN_STEPS for k, v in want.items()},
                    f"{workers} workers: launches {launches}")
        # past one worker, each epoch's report adds the gang's mean loss: one
        # f32 scalar
        reports = C.TRAIN_CONFIG["epochs"] if workers > 1 else 0
        for ar in run["allreduce"]:
            C.check(ar["count"] == C.DP_BUCKETS_PER_STEP * C.TRAIN_STEPS + reports
                    and ar["bytes"] == C.DP_OP_BYTES[1] * C.TRAIN_STEPS + 4 * reports,
                    f"allreduce {ar}")
        C.check(all(x == x and abs(x) < 1e3 for x in run["losses"]), f"losses {run['losses']}")
    C.check(all(k == 0 for k in one["nccl_kernels"]), f"1 worker: NCCL kernels {one['nccl_kernels']}")
    C.check(all(k >= C.DP_BUCKETS_PER_STEP for k in many["nccl_kernels"]),
            f"{n} workers: NCCL kernels {many['nccl_kernels']}, want one or more per bucket")
    return runs


def resnet_part(C, fit, n: int) -> None:
    """4: ResNet-50 with sync-BN at 1 worker and at n, b=256 a worker."""
    import math

    runs = {}
    for workers in (1, n):
        result, fit_s = fit(C.train_resnet_dp_loop, workers, C.RESNET_CONFIG)
        stats = [m["resnet_dp"] for m in result.metrics_history if "resnet_dp" in m]
        losses = [m["loss"] for m in result.metrics_history if "loss" in m]
        C.check(len(stats) == workers and all(math.isfinite(x) for x in losses),
                f"{len(stats)} stats and losses {losses} from {workers} workers")
        for s in stats:
            grad_bytes = sum(b[1] for b in s["buckets"])
            bn_ops = s["step_collectives"]["count"] - len(s["buckets"])
            C.check(grad_bytes == 4 * C.RESNET_PARAMS and bn_ops == 2 * C.RESNET_BNS,
                    f"{workers} workers: {bn_ops} sync-BN ops, {grad_bytes} gradient bytes")
            C.check(not any(s["launches"].values()), f"port kernels on ResNet: {s['launches']}")
        med = [statistics.median(s["step_ms"]) for s in stats]
        runs[workers] = dict(fit_s=fit_s, losses=losses, step_ms_median=med,
                             images_per_s=C.RESNET_CONFIG["batch_per_worker"] * workers / max(med)
                             * 1e3, peak_bytes=[s["peak_bytes"] for s in stats])
    efficiency = max(runs[1]["step_ms_median"]) / max(runs[n]["step_ms_median"])
    print("multicard resnet", json.dumps({"runs": runs, "weak_scaling_efficiency": efficiency}))


def fsdp_part(C, fit, n: int, replicated) -> None:
    """5: the 7B LoRA loop at its default mesh, FSDP at fsdp = n."""
    result, fit_s = fit(C.train_fsdp_loop, n, C.TRAIN_CONFIG)
    stats = [m["fsdp_stats"] for m in result.metrics_history if "fsdp_stats" in m]
    losses = [m["loss"] for m in result.metrics_history if "loss" in m]
    C.check(len(stats) == n and len(losses) == n * C.TRAIN_CONFIG["epochs"],
            f"{len(stats)} stats and {len(losses)} losses from {n} workers")
    C.check(all(x == x and abs(x) < 1e3 for x in losses), f"losses {losses}")
    n_layers = 32
    want = {"rmsnorm_fwd": 4 * n_layers + 1, "flash_attention_fwd": 2 * n_layers,
            "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers}
    for s in stats:
        C.check(s["launches"] == {k: v * C.TRAIN_STEPS for k, v in want.items()},
                f"fsdp={n}: launches {s['launches']}")
    rep = replicated[n] if replicated else None
    print("multicard fsdp", json.dumps(dict(
        ranks=n, fit_s=fit_s, losses=losses,
        step_ms_median=[statistics.median(s["step_ms"]) for s in stats],
        per_step=stats[0]["per_step"], peak_bytes=[s["peak_bytes"] for s in stats],
        step_peak_bytes=[s["step_peak_bytes"] for s in stats],
        replicated_step_ms_median=rep["step_ms_median"] if rep else None,
        replicated_peak_bytes=rep["peak_bytes"] if rep else None)))


def sp_loop(config):
    """Part 6's worker: the 7B LoRA step with the sequence split over the
    gang (``gang_mesh(device, sp=n)`` bound to the tensor group through
    ``chip_smoke._ShiftMeter``; at one rank plain flash), the gradients
    summed over it; K1-K4 launches of a warm-up step, then timed steps."""
    import torch

    import chip_smoke as C
    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.train import collective as tcol
    from ray_tpu_torch.train.examples import llama_lora

    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = train.get_context()
    r, n = ctx.world_rank, ctx.world_size
    device = C._card(torch)
    cfg = llama_lora.model_config(dict(C.TRAIN_CONFIG, seq=config["seq"]))
    meter = C._ShiftMeter(tcol.tensor_group()) if n > 1 else None
    mesh = tcol.gang_mesh(device, sp=n).bind(r, {"sp": meter} if meter else {})
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    model, _, optimizer = llama_lora.lora_model(cfg, params, mesh=mesh)
    del params
    g = torch.Generator(device=device).manual_seed(C.SEED + 80)
    tokens = torch.randint(0, cfg.vocab_size, (config["batch"], config["seq"]), generator=g,
                           device=device)
    reduce = tcol.reduce_gradients if n > 1 else None
    counters = C._port_counters()
    C._zero(counters)
    llama_lora.lora_train_step(model, optimizer, tokens, reduce)
    torch.cuda.synchronize()
    launches = C._launches(counters)
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for _ in range(SP_TIMED_STEPS):
        if meter:
            meter.take()
        t0 = time.perf_counter()
        loss = llama_lora.lora_train_step(model, optimizer, tokens, reduce)
        torch.cuda.synchronize()
        rows.append(dict(step_ms=(time.perf_counter() - t0) * 1e3,
                         shifts=meter.take() if meter else None))
    peak = torch.cuda.max_memory_allocated()
    memory = None
    if r == 0:
        memory = memory_at_peak(
            torch, lambda: llama_lora.lora_train_step(model, optimizer, tokens, reduce))
    else:
        llama_lora.lora_train_step(model, optimizer, tokens, reduce)
    torch.cuda.synchronize()
    train.report({"rank": r, "launches": launches, "steps": rows, "loss": float(loss),
                  "peak_bytes": peak, "memory_at_peak": memory, "n_layers": cfg.n_layers})


def _site(frames) -> str:
    """Where an allocation was made: its two innermost frames in this
    repository's code, else its innermost frame."""
    ours = [f for f in frames if "ray_tpu_torch" in f["filename"]
            or Path(f["filename"]).name.startswith("chip_")]
    shown = ours[:2] or frames[:1]
    return " < ".join(f"{Path(f['filename']).name}:{f['line']} {f['name']}"
                      for f in shown) or "(no Python frame)"


def memory_at_peak(torch, step) -> dict:
    """Run ``step`` with the allocator's history recorded and replay it.
    The allocated bytes fall when a block's free is asked for (what
    ``max_memory_allocated`` reads) and the held bytes when the free
    completes, after every stream that used the block. At the allocated
    peak: the blocks the step allocated that are live, by ``_site``, the
    largest ``PEAK_SITES`` first; the bytes live before the step; and the
    held peak beside it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000, stacks="python")
    try:
        step()
        torch.cuda.synchronize()
        trace = torch.cuda.memory._snapshot()["device_traces"][torch.cuda.current_device()]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)

    def replay(stop=None):
        live, freeing, alloc, held, peak, at, held_peak = {}, {}, 0, 0, 0, 0, 0
        for i, e in enumerate(trace[:stop]):
            if e["action"] == "alloc":
                live[e["addr"]] = e
                alloc, held = alloc + e["size"], held + e["size"]
            elif e["action"] == "free_requested" and e["addr"] in live:
                freeing[e["addr"]] = live.pop(e["addr"])["size"]
                alloc -= freeing[e["addr"]]
            elif e["action"] == "free_completed" and e["addr"] in freeing:
                held -= freeing.pop(e["addr"])
            if alloc > peak:
                peak, at = alloc, i + 1
            held_peak = max(held_peak, held)
        return live, peak, at, held_peak

    _, peak, at, held_peak = replay()
    live = replay(at)[0]
    sites = {}
    for e in live.values():
        entry = sites.setdefault(_site(e["frames"]), [0, 0])
        entry[0] += e["size"]
        entry[1] += 1
    top = sorted(sites.items(), key=lambda kv: -kv[1][0])[:PEAK_SITES]
    return dict(before_step_bytes=base, step_peak_bytes=peak,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                held_peak_bytes=held_peak, trace_entries=len(trace),
                sites=[dict(site=k, bytes=b, blocks=c) for k, (b, c) in top])


def sp_part(C, fit, n: int) -> None:
    """6: the 7B LoRA step at sp = 1, 2 and 4 (as the cards allow), b=2 x
    4096, and at sp = 4, b=1 x 16,384."""
    import math

    runs = {}
    for sp, batch, seq in SP_RUNS:
        if sp > n:
            continue
        result, fit_s = fit(sp_loop, sp, {"batch": batch, "seq": seq})
        reports = sorted((m for m in result.metrics_history if "steps" in m),
                         key=lambda m: m["rank"])
        C.check([m["rank"] for m in reports] == list(range(sp)), f"sp={sp}: reports {reports}")
        C.check(all(math.isfinite(m["loss"]) and m["loss"] == reports[0]["loss"] for m in reports),
                f"sp={sp}: losses {[m['loss'] for m in reports]}")
        for m in reports:
            layers, r = m["n_layers"], m["rank"]
            want = {"rmsnorm_fwd": 4 * layers + 1, "flash_attention_fwd": 2 * layers * (r + 1),
                    "flash_bwd_dq": layers * (sp - r), "flash_bwd_dkv": layers * (sp - r)}
            C.check(m["launches"] == want, f"sp={sp} rank {r}: launches {m['launches']}, "
                                           f"want {want}")
        med = [statistics.median(s["step_ms"] for s in m["steps"]) for m in reports]
        shifts = [m["steps"][-1]["shifts"] for m in reports]
        runs[f"sp{sp}_b{batch}x{seq}"] = dict(
            fit_s=fit_s, loss=reports[0]["loss"],
            step_ms=[[s["step_ms"] for s in m["steps"]] for m in reports], step_ms_median=med,
            tokens_per_s=batch * seq / max(med) * 1e3,
            peak_bytes=[m["peak_bytes"] for m in reports], shifts_last_step=shifts,
            memory_at_peak_rank0=reports[0]["memory_at_peak"],
            stream_wait_share=None if sp == 1 else [
                x["stream_wait_ms"] / m["steps"][-1]["step_ms"] for x, m in zip(shifts, reports)])
    print("multicard sp", json.dumps(runs))


def mesh_loop(config):
    """Part 7's and 9 (c)'s worker: the ViT or the MoE over
    ``gang_mesh(device, **axes)`` (one rank: every axis 1), AdamW; K1-K4
    launches of a warm-up step, then timed steps."""
    import dataclasses

    import torch

    import chip_smoke as C
    from ray_tpu_torch import train
    from ray_tpu_torch.models import moe as M
    from ray_tpu_torch.models import vit as V
    from ray_tpu_torch.parallel.fsdp import FSDP
    from ray_tpu_torch.parallel.mesh import BATCH_AXES
    from ray_tpu_torch.parallel.sharding import moe_logical_axes
    from ray_tpu_torch.train import collective as tcol

    torch.backends.cuda.matmul.allow_tf32 = False
    r = train.get_context().world_rank
    device = C._card(torch)
    mesh = tcol.gang_mesh(device, fsdp=1, **config["axes"])
    n, i = mesh.axes_size(BATCH_AXES), mesh.axes_index(BATCH_AXES)
    if config["model"] == "vit":
        cfg, params, images, labels = C._mesh_vit_inputs(torch, device)
        model = V.build_vit(cfg, params, mesh)
        rows = slice(i * images.shape[0] // n, (i + 1) * images.shape[0] // n)
        images, labels = images[rows].contiguous(), labels[rows].contiguous()
        optimizer = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
        items = C.MESH["vit"]["batch"]

        def loss_fn():
            return V.classification_loss(cfg, mesh, model, images, labels)
    else:
        cfg = dataclasses.replace(C._mesh_moe_config(torch), n_layers=MESH_MOE["n_layers"])
        layout = FSDP.for_model(mesh, M.param_shapes(cfg), moe_logical_axes)
        g = torch.Generator(device=device).manual_seed(C.SEED + 12)
        params = M.init_params(cfg, g, device, shard=layout.shard)
        tokens = torch.randint(0, cfg.vocab_size, (MESH_MOE["batch"], MESH_MOE["seq"]),
                               generator=g, device=device)
        model = M.build_moe(cfg, params, trainable=True, mesh=mesh)
        tokens = tokens[i * tokens.shape[0] // n:(i + 1) * tokens.shape[0] // n].contiguous()
        optimizer = torch.optim.AdamW(model.parameters(), lr=MESH_MOE["lr"], weight_decay=1e-4,
                                      fused=True)
        items = MESH_MOE["batch"] * MESH_MOE["seq"]

        def loss_fn():
            return M.next_token_loss(cfg, mesh, model, tokens)
    del params

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        model.fsdp.sync_gradients(model.named_parameters())
        optimizer.step()
        return loss.detach()

    counters = C._port_counters()
    C._zero(counters)
    step()
    torch.cuda.synchronize()
    launches = C._launches(counters)
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for _ in range(MESH_TIMED_STEPS):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        rows.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    # one more step under the profiler on every rank (one attempt each: a
    # retry on one rank would add collectives the others never join)
    prof = C.device_profile(torch, step, groups={"nccl": ("nccl",)}, attempts=1)
    profile = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_busy_share",
                                    "kernel_launches", "groups_ms", "top_kernels_ms")}
    train.report({"rank": r, "launches": launches, "step_ms": rows, "loss": float(loss),
                  "profile": profile, "peak_bytes": peak, "items": items,
                  "coords": mesh.coords(),
                  "n_layers": cfg.n_layers, "param_bytes": sum(
                      p.numel() * p.element_size() for p in model.parameters())})


def mesh_part(C, fit, n: int, parts=("7",)) -> None:
    """7: the MoE at ep=2 x tp=2 and the ViT at dp=2 x tp=2 across cards,
    each beside its one-card step; 9 (c): the MoE at sp=2 x ep=2."""
    import math

    runs = {}
    todo = list(MESH_RUNS) if "7" in parts else []
    if "9" in parts:
        todo += [run for run in MESH_SP_RUNS if run not in todo]
    for model, axes in todo:
        ranks = math.prod(axes.values())
        if ranks > n:
            continue
        result, fit_s = fit(mesh_loop, ranks, {"model": model, "axes": axes})
        reports = sorted((m for m in result.metrics_history if "step_ms" in m),
                         key=lambda m: m["rank"])
        C.check([m["rank"] for m in reports] == list(range(ranks)), f"{model} {axes}: {reports}")
        C.check(all(math.isfinite(m["loss"]) and m["loss"] == reports[0]["loss"] for m in reports),
                f"{model} {axes}: losses {[m['loss'] for m in reports]}")
        layers, sp = reports[0]["n_layers"], axes.get("sp", 1)
        for m in reports:  # the ring's share at sp coordinate s
            s = m["coords"]["sp"]
            want = ({"rmsnorm_fwd": 4 * layers + 1, "flash_attention_fwd": 2 * layers * (s + 1),
                     "flash_bwd_dq": layers * (sp - s), "flash_bwd_dkv": layers * (sp - s)}
                    if model == "moe" else
                    {"rmsnorm_fwd": 0, "flash_attention_fwd": layers, "flash_bwd_dq": layers,
                     "flash_bwd_dkv": layers})
            C.check(m["launches"] == want, f"{model} {axes} rank {m['rank']}: launches "
                                           f"{m['launches']}, want {want}")
        med = max(statistics.median(m["step_ms"]) for m in reports)
        key = f"{model}_" + ("_".join(f"{a}{k}" for a, k in axes.items()) or "one_card")
        runs[key] = dict(fit_s=fit_s, loss=reports[0]["loss"],
                         step_ms=[m["step_ms"] for m in reports], step_ms_median=med,
                         per_s=reports[0]["items"] / med * 1e3,
                         unit="tokens" if model == "moe" else "images",
                         peak_bytes=[m["peak_bytes"] for m in reports],
                         param_bytes=[m["param_bytes"] for m in reports],
                         profile=[m["profile"] for m in reports])
    for model in ("moe", "vit"):
        one = runs.get(f"{model}_one_card")
        for key, run in runs.items():
            if key.startswith(model) and one is not None and run is not one:
                run["speedup_over_one_card"] = one["step_ms_median"] / run["step_ms_median"]
    print("multicard mesh", json.dumps(runs))


def tp_loop(config):
    """Part 8's worker: the llama_lora loop with each of its steps timed
    (``lora_train_step`` wrapped: synchronized around it, K1-K4 counts set
    to 0 before it and read after it); with ``sp`` in the config, the 7B
    model over ``gang_mesh(device, sp=, tp=)`` stepped through the loop's
    own functions instead (the loop takes no ``sp``, as the reference's)."""
    import torch

    import chip_smoke as C
    from ray_tpu_torch import train
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.train import collective as tcol
    from ray_tpu_torch.train.examples import llama_lora

    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = train.get_context()
    device = C._card(torch)
    counters = C._port_counters()
    step = llama_lora.lora_train_step
    rows = []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        C._zero(counters)
        t0 = time.perf_counter()
        out = step(*args, **kwargs)
        torch.cuda.synchronize()
        rows.append(dict(step_ms=(time.perf_counter() - t0) * 1e3, launches=C._launches(counters)))
        return out

    torch.cuda.reset_peak_memory_stats()
    losses = []
    if "sp" in config:
        from ray_tpu_torch.models.llama import init_params
        from ray_tpu_torch.parallel.fsdp import FSDP

        cfg = llama_lora.model_config(config)
        mesh = tcol.gang_mesh(device, sp=config["sp"], tp=config["tp"], fsdp=1)
        params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device,
                             shard=FSDP.for_llama(cfg, mesh).shard)
        model, _, optimizer = llama_lora.lora_model(cfg, params, mesh=mesh)
        del params
        g = torch.Generator(device=device).manual_seed(C.SEED + 81)
        tokens = torch.randint(0, cfg.vocab_size, (config["batch"], config["seq"]), generator=g,
                               device=device)
        reduce = llama_lora.mesh_gradients(model)
        for _ in range(config["steps_per_epoch"]):
            losses.append(float(timed(model, optimizer, tokens, reduce)))
        coords, layers = mesh.coords(), cfg.n_layers
    else:
        llama_lora.lora_train_step = timed
        try:
            llama_lora.train_loop_per_worker(config)
        finally:
            llama_lora.lora_train_step = step
        axes = llama_lora.mesh_axes(config, ctx.world_size)
        coords = make_mesh(devices=[0] * ctx.world_size, **axes).coords(ctx.world_rank)
        layers = llama_lora.model_config(config).n_layers
    train.report({"rank": ctx.world_rank, "steps": rows, "step_losses": losses,
                  "peak_bytes": torch.cuda.max_memory_allocated(), "coords": coords,
                  "n_layers": layers})


def tp_train_part(C, fit, n: int) -> None:
    """8: the 7B LoRA loop over the reference's mesh layouts on 4 cards,
    beside one card and fsdp=4."""
    import math

    runs = {}
    for name, axes in TP_RUNS:
        ranks = math.prod(v for k, v in axes.items() if k in ("dp", "fsdp", "tp", "sp")) or 1
        if ranks > n:
            continue
        config = {**TP_LOOP, **axes}
        result, fit_s = fit(tp_loop, ranks, config)
        reports = sorted((m for m in result.metrics_history if "steps" in m),
                         key=lambda m: m["rank"])
        C.check([m["rank"] for m in reports] == list(range(ranks)), f"{name}: {reports}")
        if "sp" in axes:
            losses = [m["step_losses"] for m in reports]
        else:  # the loop's own reports: the global batch's loss, each epoch
            losses = [[m["loss"] for m in result.metrics_history
                       if "loss" in m and m.get("rank") == r] for r in range(ranks)]
        C.check(all(math.isfinite(x) for x in losses[0]) and all(l == losses[0] for l in losses),
                f"{name}: losses {losses}")
        sp, tp = axes.get("sp", 1), axes.get("tp", 1)
        for m in reports:
            layers, s = m["n_layers"], m["coords"]["sp"]
            want = {"rmsnorm_fwd": 4 * layers + 1, "flash_attention_fwd": 2 * layers * (s + 1),
                    "flash_bwd_dq": layers * (sp - s), "flash_bwd_dkv": layers * (sp - s)}
            for st in m["steps"]:
                C.check(st["launches"] == want, f"{name} rank {m['rank']}: launches "
                                                f"{st['launches']}, want {want}")
        med = max(statistics.median(st["step_ms"] for st in m["steps"][1:]) for m in reports)
        shards = ranks // (sp * tp)
        tokens = config["batch_per_worker" if "sp" not in axes else "batch"] * shards * config["seq"]
        runs[name] = dict(axes=axes, ranks=ranks, fit_s=fit_s, losses=losses[0],
                          step_ms=[[st["step_ms"] for st in m["steps"]] for m in reports],
                          step_ms_median=med, tokens_per_step=tokens,
                          tokens_per_s=tokens / med * 1e3,
                          peak_bytes=[m["peak_bytes"] for m in reports])
    one = runs.get("one_card")
    for run in runs.values():
        if one is not None:
            run["tokens_per_s_over_one_card"] = run["tokens_per_s"] / one["tokens_per_s"]
            run["peak_over_one_card"] = max(run["peak_bytes"]) / max(one["peak_bytes"])
    print("multicard tp", json.dumps(runs))


def pipe_loop(config):
    """Part 9 (a)'s worker: one stage of ``pipeline_apply`` over the run's
    NCCL group (``config["stages"]`` ranks, each 32 / stages blocks), or
    with one worker all 32 blocks applied in turn to each microbatch; the
    forward and backward of the weighted mean, a warm-up step and timed
    steps (K1-K4 set to 0 just before each, read just after); the output
    (last stage) and a few gradients written to the run's directory."""
    from pathlib import Path

    import torch
    from torch.func import functional_call

    import chip_smoke as C
    from ray_tpu_torch import train
    from ray_tpu_torch.parallel import pipeline_apply
    from ray_tpu_torch.train import collective as tcol

    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = train.get_context()
    device = C._card(torch)
    stages, total = ctx.world_size, PIPE_CARDS["layers"]
    per = total // stages
    s = ctx.world_rank
    model, xs, weights = C._pipe_model(torch, device, range(s * per, (s + 1) * per), n=total)
    params = dict(model.named_parameters())
    xs.requires_grad_(True)
    group = tcol.tensor_group() if stages > 1 else None
    counters = C._port_counters()

    def step():
        if group is not None:
            out = pipeline_apply(lambda p, x: functional_call(model, p, (x,)), params, xs,
                                 group=group)
            loss = C._pipe_loss(torch, out, weights)
            loss.backward()
            return out.detach(), loss.detach()
        outs, loss = [], 0.0
        for m in range(C.PIPE["micro"]):
            y = model(xs[m])
            part = (y.float() * weights[m].float()).sum() / (y.numel() * C.PIPE["micro"])
            part.backward()
            outs.append(y.detach())
            loss = loss + part.detach()
        return torch.stack(outs), loss

    torch.cuda.reset_peak_memory_stats()
    rows = []
    for i in range(1 + PIPE_CARDS["timed_steps"]):
        for p in params.values():
            p.grad = None
        xs.grad = None
        torch.cuda.synchronize()
        if group is not None:
            group.barrier()
        C._zero(counters)
        t0 = time.perf_counter()
        out, loss = step()
        torch.cuda.synchronize()
        rows.append(dict(step_ms=(time.perf_counter() - t0) * 1e3,
                         launches=C._launches(counters), loss=float(loss)))
    keep = [k for k in params if k.endswith(("attn.wq.base.kernel", "mlp.w_down.kernel"))]
    torch.save({"out": out.cpu() if s == stages - 1 else None,
                "grads": {k: params[k].grad.cpu() for k in keep}},
               Path(ctx.get_storage_path()) / f"pipe_{stages}_{s}.pt")
    train.report({"rank": s, "steps": rows, "peak_bytes": torch.cuda.max_memory_allocated(),
                  "blocks": per})


def pipe_part(C, fit, n: int) -> None:
    """9 (a): the pipeline at pp=4 across cards beside one card holding all
    32 blocks."""
    import math

    import torch

    stages = PIPE_CARDS["stages"]
    if stages > n:
        return
    runs, files = {}, {}
    for ranks in (1, stages):
        with tempfile.TemporaryDirectory(prefix="chip_multicard_pipe_") as storage:
            t0 = time.perf_counter()
            result = _fit_in(C, pipe_loop, ranks, storage)
            fit_s = time.perf_counter() - t0
            reports = sorted((m for m in result.metrics_history if "steps" in m),
                             key=lambda m: m["rank"])
            C.check([m["rank"] for m in reports] == list(range(ranks)), f"pipe {ranks}: {reports}")
            per = PIPE_CARDS["layers"] // ranks
            micro = C.PIPE["micro"]
            want = {"rmsnorm_fwd": 2 * per * micro, "flash_attention_fwd": per * micro,
                    "flash_bwd_dq": per * micro, "flash_bwd_dkv": per * micro}
            for m in reports:
                for st in m["steps"]:
                    C.check(st["launches"] == want, f"pipe {ranks} rank {m['rank']}: launches "
                                                    f"{st['launches']}, want {want}")
                    C.check(math.isfinite(st["loss"]), f"pipe {ranks}: loss {st['loss']}")
            med = max(statistics.median(st["step_ms"] for st in m["steps"][1:]) for m in reports)
            runs[ranks] = dict(fit_s=fit_s, step_ms=[[st["step_ms"] for st in m["steps"]]
                                                     for m in reports],
                               step_ms_median=med, loss=reports[-1]["steps"][0]["loss"],
                               peak_bytes=[m["peak_bytes"] for m in reports])
            files[ranks] = [torch.load(Path(storage) / "multicard" / f"pipe_{ranks}_{r}.pt")
                            for r in range(ranks)]
    one, pipe = files[1][0], files[stages]
    grads = {k: g for f in pipe for k, g in f["grads"].items()}
    dist_of = {}
    for name, got, want in (("out", pipe[-1]["out"], one["out"]),
                            *((k, g, one["grads"][k]) for k, g in grads.items())):
        dist_of[name] = ((got.float() - want.float()).norm() / want.float().norm()).item()
    # the same blocks on the same microbatches: the two runs part by the
    # order of the microbatches' gradient sums at most, 8 bf16 additions
    # (each rounding at 2^-9 of the sum) in another order
    C.check(max(dist_of.values()) <= 8 * 2.0 ** -9, f"pipe against one card: {dist_of}")
    out = dict(stages=stages, blocks=PIPE_CARDS["layers"], micro=C.PIPE["micro"],
               one_card=runs[1], pipeline=runs[stages],
               wall_over_one_card=runs[stages]["step_ms_median"] / runs[1]["step_ms_median"],
               out_rel_distance=dist_of["out"], out_bit_identical=bool(
                   torch.equal(pipe[-1]["out"], one["out"])),
               grad_rel_distance_max=max(v for k, v in dist_of.items() if k != "out"))
    print("multicard pipe", json.dumps(out))


def _fit_in(C, loop, workers, storage, config=None):
    """``loop`` on ``workers`` NCCL ranks, its run directory under
    ``storage`` (kept for the caller to read)."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchConfig, TorchTrainer

    result = TorchTrainer(loop, train_loop_config=dict(config or {}),
                          scaling_config=ScalingConfig(num_workers=workers),
                          backend_config=TorchConfig(backend="nccl"),
                          run_config=RunConfig(name="multicard", storage_path=storage)).fit()
    if result.error is not None:
        raise result.error
    return result


def hier_loop(config):
    """Part 9 (b)'s worker: ``init_collective_group(backend="hier",
    slice_size=2, intra_backend="nccl")`` beside the run's flat NCCL group:
    the allreduce of 33,554,432 B on integer values (equal) and random ones
    (within five f32 roundings of the magnitudes' sum: up to three in NCCL's
    order, two in the slices'), each timed over
    HIER_REPS (host clock; each op ends synchronized)."""
    import torch

    import chip_smoke as C
    from ray_tpu_torch import collective as col
    from ray_tpu_torch import train
    from ray_tpu_torch.train import collective as tcol

    ctx = train.get_context()
    device = C._card(torch)
    flat = tcol.tensor_group()
    hier = col.init_collective_group(ctx.world_size, ctx.world_rank, backend="hier",
                                     group_name="hier", slice_size=2, intra_backend="nccl")
    n = C.HIER["bytes"] // 4
    g = torch.Generator(device=device).manual_seed(C.SEED + 30 + ctx.world_rank)
    ints = torch.randint(-1000, 1000, (n,), generator=g, device=device).float()
    rand = torch.randn(n, generator=g, device=device)
    exact = torch.equal(hier.allreduce(ints), flat.allreduce(ints))
    got, want = hier.allreduce(rand), flat.allreduce(rand)
    mag = flat.allreduce(rand.abs())
    err = ((got - want).abs() / (5 * 2.0 ** -24 * mag)).max().item()
    times = {}
    for name, group in (("hier", hier), ("flat", flat), ("hier_again", hier),
                        ("flat_again", flat)):
        rows = []
        for _ in range(HIER_REPS):
            flat.barrier()
            t0 = time.perf_counter()
            group.allreduce(rand)
            torch.cuda.synchronize()
            rows.append((time.perf_counter() - t0) * 1e3)
        times[name] = rows
    col.destroy_collective_group("hier")
    train.report({"rank": ctx.world_rank, "int_exact": exact, "rand_err_over_bound": err,
                  "ms": times})


def hier_part(C, fit, n: int) -> None:
    """9 (b): the hierarchical group at 2 slices of 2 cards against the flat
    NCCL allreduce."""
    if n < 4:
        return
    result, fit_s = fit(hier_loop, 4)
    reports = sorted((m for m in result.metrics_history if "ms" in m), key=lambda m: m["rank"])
    C.check(len(reports) == 4, f"hier: {reports}")
    for m in reports:
        C.check(m["int_exact"] and m["rand_err_over_bound"] <= 1,
                f"hier rank {m['rank']}: against the flat sum {m}")
    med = {name: max(statistics.median(m["ms"][name]) for m in reports)
           for name in reports[0]["ms"]}
    print("multicard hier", json.dumps(dict(
        bytes=C.HIER["bytes"], slices=2, fit_s=fit_s, median_ms=med,
        hier_over_flat=(med["hier"] + med["hier_again"]) / (med["flat"] + med["flat_again"]),
        rand_err_over_bound=max(m["rand_err_over_bound"] for m in reports),
        ms=[m["ms"] for m in reports])))


# -- part 10: the runtime core across the cards --------------------------------------------

#: part 10: the bytes each actor allocates on its card, the shape of the
#: tensor one actor keeps on its card for another to fetch
RUNTIME_ALLOC_BYTES = 1 << 30
RUNTIME_SHARED_SHAPE = (4096, 4096)


def _card_memory(torch):
    torch.cuda.synchronize()
    return [torch.cuda.memory_allocated(i) for i in range(torch.cuda.device_count())]


def _digest(t):
    import hashlib

    import torch

    return hashlib.sha256(t.contiguous().cpu().view(-1).view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


def _device_method(fn):
    """``@ray_tpu_torch.method(tensor_transport="device")``, as
    ``chip_smoke._device_method``: set at the class's definition, since the
    actor's worker imports this module by name."""
    fn.__ray_tpu_method_options__ = {"tensor_transport": "device"}
    return fn


class CardActor:
    """Part 10's actor: a num_gpus=1 lease's worker, bound to its card."""

    def probe(self):
        import os

        import torch

        import ray_tpu_torch

        return {"gpu_ids": ray_tpu_torch.get_gpu_ids(), "device": torch.cuda.current_device(),
                "pid": os.getpid()}

    def allocate(self, nbytes):
        """memory_allocated on every card, before and after this actor
        allocates ``nbytes`` on its current card."""
        import torch

        before = _card_memory(torch)
        self.block = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
        return before, _card_memory(torch)

    def make_shared(self, seed):
        import torch

        gen = torch.Generator(device="cuda").manual_seed(seed)
        self.shared = torch.randn(RUNTIME_SHARED_SHAPE, generator=gen, device="cuda")
        return _digest(self.shared)

    @_device_method
    def keep(self):
        return {"shared": self.shared}

    @_device_method
    def resolved(self, tree):
        """The digest and card of a tensor resolved into this actor."""
        t = tree["shared"]
        return _digest(t), t.device.index

    def __init__(self):
        self.block = self.shared = None


def _apps_by_card():
    """{pid: [card index, ...]} from nvidia-smi's compute processes (empty
    where the container does not show them)."""
    uuids = subprocess.run(["nvidia-smi", "--query-gpu=index,uuid", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout
    index = {u.strip(): int(i) for i, u in (line.split(",") for line in uuids.splitlines() if line)}
    apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,gpu_uuid",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout
    out = {}
    for line in apps.splitlines():
        if "," in line:
            pid, uuid = (x.strip() for x in line.split(","))
            out.setdefault(int(pid), []).append(index.get(uuid))
    return out


def runtime_part(torch, C, n: int) -> None:
    import chip_multicard as M  # the workers import the actor class by this name
    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    rt.init()
    out = {"init_s": time.perf_counter() - t0}
    try:
        gpus = rt.cluster_resources().get("GPU")
        C.check(gpus == float(n), f"the runtime found {gpus} GPUs on {n} cards")
        t0 = time.perf_counter()
        actors = [rt.remote(num_gpus=1)(M.CardActor).remote() for _ in range(n)]
        probes = rt.get([a.probe.remote() for a in actors], timeout=600)
        out["actors_start_s"] = time.perf_counter() - t0
        cards = [p["device"] for p in probes]
        C.check(sorted(cards) == list(range(n)), f"the actors' cards are {cards}, not 0..{n - 1}")
        C.check(all(p["gpu_ids"] == [p["device"]] for p in probes),
                f"an actor's current card is not its lease's: {probes}")
        allocs = rt.get([a.allocate.remote(RUNTIME_ALLOC_BYTES) for a in actors], timeout=600)
        for p, (before, after) in zip(probes, allocs):
            grown = [i for i in range(n) if after[i] > before[i]]
            C.check(grown == [p["device"]] and after[p["device"]] - before[p["device"]]
                    >= RUNTIME_ALLOC_BYTES,
                    f"actor on card {p['device']} grew memory on cards {grown}")
        apps = _apps_by_card()
        seen = {p["pid"]: apps.get(p["pid"]) for p in probes}
        visible = any(v is not None for v in seen.values())
        out["smi_cards_by_actor"] = ({str(k): v for k, v in seen.items()} if visible else
                                     f"not visible: nvidia-smi lists pids {sorted(apps)}")
        for p in probes:
            if visible:  # nvidia-smi shows this container's process ids
                C.check(seen[p["pid"]] == [p["device"]],
                        f"nvidia-smi puts actor {p['pid']} on cards {seen[p['pid']]}")
        # a tensor kept on one card, resolved by an actor on another
        src, dst = (actors[cards.index(0)], actors[cards.index(n - 1)])
        digest = rt.get(src.make_shared.remote(C.SEED), timeout=120)
        ref = rt.get(src.keep.remote(), timeout=120)
        t0 = time.perf_counter()
        got_digest, got_card = rt.get(dst.resolved.remote(ref), timeout=120)
        out["cross_card_fetch_ms"] = (time.perf_counter() - t0) * 1e3
        C.check(got_card == n - 1, f"the fetched tensor landed on card {got_card}, not {n - 1}")
        C.check(got_digest == digest, "the tensor fetched across cards differs from its source")
        out.update(cards=cards, alloc_bytes=RUNTIME_ALLOC_BYTES,
                   shared_bytes=4 * RUNTIME_SHARED_SHAPE[0] * RUNTIME_SHARED_SHAPE[1])
        for a in actors:
            rt.kill(a)
    finally:
        rt.shutdown()
    print("multicard runtime", json.dumps(out))


def serve_part(torch, np, C, n: int) -> None:
    """Part 11: n replicas of one deployment on n cards, one each."""
    import ray_tpu_torch as rt
    import ray_tpu_torch.testing  # noqa: F401 - rt.testing
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import LLMConfig, LLMServer, build_llm_deployment

    cfg = LLMConfig(
        model_id="llama2-7b", max_seq_len=C.CB["max_seq_len"], max_batch_size=C.CB["slots"],
        kv_cache_blocks=C.CB["blocks"], kv_block_size=C.CB["block"],
        model_kwargs=C.serve_model_kwargs(torch), num_replicas=n,
        resources_per_replica={"CPU": 1.0, "GPU": 1.0},
    )
    rng = np.random.default_rng(C.SEED + 31)
    prompts = [rng.integers(0, 32000, C.CB_PREFIX + C.CB_OWN).tolist() for _ in range(n)]
    request = {"max_new_tokens": C.NEW_TOKENS, "temperature": 0.0}
    local = LLMServer(dataclasses.replace(cfg, num_replicas=1))  # card 0, seed 0
    want = [local(dict(request, token_ids=p))["token_ids"] for p in prompts]
    del local
    torch.cuda.empty_cache()
    out = {}
    rt.init()
    try:
        t0 = time.perf_counter()
        serve.run(build_llm_deployment(cfg, name="llm"), name="llm", _proxy=False)
        rows = C._wait_running(rt, "llm", n)
        out["run_to_running_s"] = time.perf_counter() - t0
        cards = sorted(r["mesh"]["gpu_ids"][0] for r in rows)
        for r in rows:
            C.check(r["mesh"]["gpu_ids"] == [int(r["mesh"]["devices"][0].split(":")[1])],
                    f"a replica's weights are off its lease's card: {r['mesh']}")
        C.check(cards == list(range(n)), f"the replicas' cards are {cards}, not 0..{n - 1}")
        controller = rt.get_actor("SERVE_CONTROLLER")
        table = rt.get(controller.get_routing_table.remote("llm"), timeout=60)
        replicas = [replica for _rid, replica, _q in table["llm"]["replicas"]]
        t0 = time.perf_counter()
        got = rt.get([replica.handle_request.remote("__call__", (dict(request, token_ids=p),),
                                                    {}, {})
                      for replica, p in zip(replicas, prompts)], timeout=600)
        out["one_request_each_s"] = time.perf_counter() - t0
        partings = [C._first_parting(g["token_ids"], w) for g, w in zip(got, want)]
        C.check(all(j is None for j in partings),
                f"a replica's tokens differ from one card's: first partings {partings}")
        out.update(cards=cards, replicas=[{k: r[k] for k in ("replica_id", "pid", "warmup_s")}
                                          | {"devices": r["mesh"]["devices"],
                                             "allocated_bytes": r["mesh"]["per_device_hbm_bytes"]}
                                          for r in rows])
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    print("multicard serve", json.dumps(out))


if __name__ == "__main__":
    main()
