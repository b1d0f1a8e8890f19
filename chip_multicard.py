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
   close it.

    python3 chip_multicard.py 3      # part 3 alone (no argument: all three)

Prints the cards' names and power limits, one JSON line per part, and
ends with an ``{"ok": true, ...}`` line. Exits non-zero with fewer than 2
cards or on any failed check. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
QUANT_ROUNDS = 3
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
    tp_only = sys.argv[1:] == ["3"]
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

    tp_part(torch, np, C, n)
    if tp_only:
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}}))
        return

    # 1. the ops at n ranks
    result, fit_s = fit(nccl_ops_loop, n)
    reports = [m for m in result.metrics_history if "errors" in m]
    ops = next(m for m in reports if m["rank"] == 0)
    for row in ops["ops"]:
        print("multicard op", json.dumps(row))
    print("multicard ops", json.dumps({"ranks": n, "fit_s": fit_s, "quantized_ms": [
        m["quantized_ms"] for m in reports], "errors": [m["errors"] for m in reports]}))
    C.check(len(reports) == n, f"{len(reports)} of {n} ranks reported")
    C.check(not any(m["errors"] for m in reports), f"failed checks {[m['errors'] for m in reports]}")

    # 2. the 7B LoRA loop at 1 worker and at n
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
        for ar in run["allreduce"]:
            C.check(ar["count"] == C.DP_BUCKETS_PER_STEP * C.TRAIN_STEPS
                    and ar["bytes"] == C.DP_OP_BYTES[1] * C.TRAIN_STEPS, f"allreduce {ar}")
        C.check(all(x == x and abs(x) < 1e3 for x in run["losses"]), f"losses {run['losses']}")
    C.check(all(k == 0 for k in one["nccl_kernels"]), f"1 worker: NCCL kernels {one['nccl_kernels']}")
    C.check(all(k >= C.DP_BUCKETS_PER_STEP for k in many["nccl_kernels"]),
            f"{n} workers: NCCL kernels {many['nccl_kernels']}, want one or more per bucket")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": n}}))


if __name__ == "__main__":
    main()
