#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py        # from the root of the repository

Phases, each of which exits non-zero on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from ray_tpu_torch/csrc with nvcc (one process per
     source, all at once);
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it and at edge cases, and time kernel, plain
     version and one PyTorch library call (a yardstick only: the port never
     calls it) with CUDA events, median of 21 timings of 10 launches: RMSNorm
     and the flash-attention forward, then the flash-attention backward (dQ,
     and dK/dV) with lse from the forward kernel;
  4. LoRA gradients of a 2-layer model at full Llama-2-7B width in f32: the
     card (all four kernels) against the host CPU (their plain versions);
  5. the serving path: LLMServer at full Llama-2-7B width (random bf16
     weights from seed 0) answers 4 greedy requests of 128 prompt tokens and
     32 new tokens, then streams one of them again;
  6. the full forward: Llama's full-sequence forward (flash attention) on the
     same 4 prompts against the cache path's prefill, in bf16 and again with
     f32 activations;
  7. the device busy share of one served request, under torch.profiler;
  8. the training path: TorchTrainer.fit() of the llama_lora loop at full
     Llama-2-7B width (bf16 weights, seq 2048, batch 2, LoRA rank 16) for 2
     epochs of 2 steps, with its checkpoint and exact per-step launch counts;
     then 3 timed warm steps of lora_train_step and the device busy share of
     one step under torch.profiler.
Main paths: the launch counters are set to 0 just before phase 5 and read
just after phase 6 (serving), and set to 0 just before phase 8's fit() and
read just after it (training). The last lines are a JSON line of the
kernels and the result line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

SEED = 0
N_REQUESTS, PROMPT_LEN, NEW_TOKENS = 4, 128, 32
# the training path: llama_lora's "7b" loop, 2 epochs of 2 steps
TRAIN_CONFIG = {"model": "7b", "seq": 2048, "batch_per_worker": 2, "lora_rank": 16,
                "epochs": 2, "steps_per_epoch": 2}
TRAIN_STEPS = TRAIN_CONFIG["epochs"] * TRAIN_CONFIG["steps_per_epoch"]
# rounding unit of each dtype (one ulp of a value in [1, 2))
ULP = {"torch.bfloat16": 2.0 ** -7, "torch.float16": 2.0 ** -10, "torch.float32": 2.0 ** -23}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def time_ms(fn, reps: int = 21, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls, per call, after a warm-up. Each timing starts behind a ~5 ms
    device sleep, so that the host has queued all ``inner`` calls before the
    first runs: the events then bracket device time, not launch overhead.
    Inputs stay in L2 between calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events) / inner


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rmsnorm_phase(torch, F):
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_fwd, rmsnorm_reference

    g = torch.Generator(device="cuda").manual_seed(SEED)
    eps = 1e-5
    # tolerance: kernel and plain version both compute in f32 and round
    # once, so they differ by at most one ulp of the output type; outputs
    # stay below 8, where a bf16 ulp is 2**-5 and an f16 ulp 2**-8
    tols = {torch.bfloat16: 2.0 ** -5, torch.float16: 2.0 ** -8, torch.float32: 1e-5}
    cases = [
        ((N_REQUESTS * PROMPT_LEN, 4096), torch.bfloat16),  # prefill rows
        ((N_REQUESTS, 4096), torch.bfloat16),  # decode rows
        ((1, 4096), torch.bfloat16),  # one streamed request
        # a training step's rows: batch 2 x seq 2048
        ((TRAIN_CONFIG["batch_per_worker"] * TRAIN_CONFIG["seq"], 4096), torch.bfloat16),
        ((300, 1024), torch.float16),
        ((7, 128), torch.float32),
    ]
    rows = []
    for shape, dtype in cases:
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        w = (1 + 0.1 * torch.randn(shape[-1], generator=g, device="cuda")).to(dtype)
        out = rmsnorm_fwd(x, w, eps)
        torch.cuda.synchronize()
        err = (out.float() - rmsnorm_reference(x, w, eps).float()).abs().max().item()
        check(err <= tols[dtype], f"rmsnorm {shape} {dtype}: max_abs_err {err} > {tols[dtype]}")
        row = dict(shape=list(shape), dtype=str(dtype), max_abs_err=err, tol=tols[dtype])
        if dtype == torch.bfloat16:
            n, d = shape
            row["ms"] = time_ms(lambda: rmsnorm_fwd(x, w, eps))
            row["plain_ms"] = time_ms(lambda: rmsnorm_reference(x, w, eps))
            row["library_ms"] = time_ms(lambda: F.rms_norm(x, (d,), w, eps))
            row["bound_ms"], row["bound_by"] = bound_ms(2 * (2 * n * d + d), 4 * n * d, F32_FLOPS)
        print("rmsnorm_fwd", json.dumps(row))
        rows.append(row)
    return rows


def flash_phase(torch, F):
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_reference

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # tolerance on o: both are f32 online/plain softmax over the same inputs
    # and round once, so one ulp of |o| < 4 (bf16: 2**-6, f16: 2**-9) or f32
    # summation-order noise; on lse (f32 in both): 1e-4
    tols = {torch.bfloat16: 2.0 ** -6, torch.float16: 2.0 ** -9, torch.float32: 2e-5}
    # (bh, sq, sk, d, causal, dtype); the first is the 7B full forward's
    # per-layer call: 4 prompts x 32 heads, 128 tokens, head_dim 128
    cases = [
        (N_REQUESTS * 32, PROMPT_LEN, PROMPT_LEN, 128, True, torch.bfloat16),
        # the 7B training call: batch 2 x 32 heads, seq 2048
        (TRAIN_CONFIG["batch_per_worker"] * 32, TRAIN_CONFIG["seq"], TRAIN_CONFIG["seq"], 128,
         True, torch.bfloat16),
        (8, 96, 96, 32, True, torch.bfloat16),  # tiny's head_dim
        (4, 77, 77, 128, True, torch.bfloat16),  # ragged sq
        (8, 100, 100, 64, False, torch.float16),
        (2, 40, 130, 64, True, torch.float32),  # sq < sk, top-left causal
        (2, 130, 40, 128, False, torch.float32),
    ]
    rows = []
    for bh, sq, sk, d, causal, dtype in cases:
        q = torch.randn(bh, sq, d, generator=g, device="cuda").to(dtype)
        k = torch.randn(bh, sk, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(bh, sk, d, generator=g, device="cuda").to(dtype)
        scale = d ** -0.5
        o, lse = flash_attention_fwd(q, k, v, sm_scale=scale, causal=causal)
        torch.cuda.synchronize()
        ro, rlse = flash_attention_reference(q, k, v, sm_scale=scale, causal=causal)
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        tag = f"flash {(bh, sq, sk, d, causal)} {dtype}"
        check(err <= tols[dtype], f"{tag}: o max_abs_err {err} > {tols[dtype]}")
        check(lse_err <= 1e-4, f"{tag}: lse max_abs_err {lse_err} > 1e-4")
        row = dict(shape=[bh, sq, sk, d], causal=causal, dtype=str(dtype),
                   max_abs_err=err, tol=tols[dtype], lse_max_abs_err=lse_err)
        if len(rows) < 2:  # the serving call, then the training call
            b = N_REQUESTS if len(rows) == 0 else TRAIN_CONFIG["batch_per_worker"]
            q4, k4, v4 = (t.view(b, bh // b, -1, d) for t in (q, k, v))
            row["ms"] = time_ms(lambda: flash_attention_fwd(q, k, v, sm_scale=scale, causal=causal))
            row["plain_ms"] = time_ms(
                lambda: flash_attention_reference(q, k, v, sm_scale=scale, causal=causal),
                reps=21 if len(rows) == 0 else 5, inner=10 if len(rows) == 0 else 2,
            )
            # sq == sk here, so SDPA's causal mask is the same top-left one
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal, scale=scale)
            )
            pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
            n_bytes = 2 * (2 * bh * sq * d + 2 * bh * sk * d) + 4 * bh * sq
            row["bound_ms"], row["bound_by"] = bound_ms(
                n_bytes, 4 * bh * pairs * d, BF16_TENSOR_FLOPS
            )
        print("flash_attention_fwd", json.dumps(row))
        rows.append(row)
    return rows


def flash_bwd_phase(torch, F):
    from ray_tpu_torch.ops.flash_attention import (
        attention_delta,
        flash_attention_fwd,
        flash_bwd_dkv,
        flash_bwd_dkv_reference,
        flash_bwd_dq,
        flash_bwd_dq_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    # (bh, sq, sk, d, causal, dtype); the first is the 7B training call:
    # batch 2 x 32 heads, seq 2048, head_dim 128
    b, seq = TRAIN_CONFIG["batch_per_worker"], TRAIN_CONFIG["seq"]
    cases = [
        (b * 32, seq, seq, 128, True, torch.bfloat16),
        (8, 96, 96, 32, True, torch.bfloat16),
        (4, 77, 77, 128, True, torch.bfloat16),  # ragged last tiles
        (8, 100, 100, 64, False, torch.float16),
        (2, 40, 130, 64, True, torch.float32),  # sq < sk, top-left causal
        (2, 130, 40, 128, False, torch.float32),  # sq > sk
    ]
    rows = {"flash_bwd_dq": [], "flash_bwd_dkv": []}
    for bh, sq, sk, d, causal, dtype in cases:
        q, do = (torch.randn(bh, sq, d, generator=g, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(bh, sk, d, generator=g, device="cuda").to(dtype) for _ in range(2))
        kw = dict(sm_scale=d ** -0.5, causal=causal)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        delta = attention_delta(do, o)
        args = (q, k, v, do, lse, delta)
        dq = flash_bwd_dq(*args, **kw)
        dk, dv = flash_bwd_dkv(*args, **kw)
        torch.cuda.synchronize()
        ref = {"dq": flash_bwd_dq_reference(*args, **kw)}
        ref["dk"], ref["dv"] = flash_bwd_dkv_reference(*args, **kw)
        tag = f"flash bwd {(bh, sq, sk, d, causal)} {dtype}"
        # tolerance: kernel and plain version compute in f32 and round once
        # to the output dtype, so they differ by f32 summation-order noise
        # (1e-4 of the largest value, for sums over up to 2048 keys) plus
        # one rounding step of the dtype at the largest value
        errs = {}
        for name, out in (("dq", dq), ("dk", dk), ("dv", dv)):
            scale = ref[name].float().abs().max().item()
            tol = scale * (ULP[str(dtype)] + 1e-4)
            err = (out.float() - ref[name].float()).abs().max().item()
            check(bool(torch.isfinite(out).all()), f"{tag}: non-finite {name}")
            check(err <= tol, f"{tag}: {name} max_abs_err {err} > {tol}")
            errs[name] = (err, tol)
        for kernel, names in (("flash_bwd_dq", ("dq",)), ("flash_bwd_dkv", ("dk", "dv"))):
            rows[kernel].append(dict(
                shape=[bh, sq, sk, d], causal=causal, dtype=str(dtype),
                max_abs_err=max(errs[n][0] for n in names),
                tol=min(errs[n][1] for n in names),
            ))
        if len(rows["flash_bwd_dq"]) == 1:
            pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
            reads = 2 * (2 * bh * sq * d + 2 * bh * sk * d) + 2 * 4 * bh * sq
            main = {
                "flash_bwd_dq": (
                    lambda: flash_bwd_dq(*args, **kw),
                    lambda: flash_bwd_dq_reference(*args, **kw),
                    reads + 2 * bh * sq * d, 6 * d * bh * pairs,
                ),
                "flash_bwd_dkv": (
                    lambda: flash_bwd_dkv(*args, **kw),
                    lambda: flash_bwd_dkv_reference(*args, **kw),
                    reads + 2 * 2 * bh * sk * d, 8 * d * bh * pairs,
                ),
            }
            # yardstick: SDPA's backward, one call for dQ, dK and dV
            # together, with the forward outside the timing
            q4, k4, v4 = (t.view(b, bh // b, -1, d).detach().requires_grad_(True)
                          for t in (q, k, v))
            o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal, scale=kw["sm_scale"])
            do4 = do.view(b, bh // b, sq, d)
            library_ms = time_ms(
                lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)
            )
            for kernel, (fn, plain, n_bytes, n_ops) in main.items():
                row = rows[kernel][0]
                row["ms"] = time_ms(fn)
                row["plain_ms"] = time_ms(plain, reps=5, inner=2)
                row["library_ms"] = library_ms
                row["library_call"] = "SDPA backward (dQ, dK, dV together)"
                row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops, BF16_TENSOR_FLOPS)
                row["flops"], row["bytes"] = n_ops, n_bytes
            del q4, k4, v4, o4
        for kernel in rows:
            print(kernel, json.dumps(rows[kernel][-1]))
    return rows


def grad_parity_phase(torch, np):
    """LoRA gradients of one loss through a 2-layer model at full 7B width,
    f32: on the card (K1-K4) and on the host CPU (their plain versions)."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_params, next_token_loss
    from ray_tpu_torch.ops.flash_attention import flash_bwd_dkv, flash_bwd_dq
    from ray_tpu_torch.train.examples.llama_lora import lora_model

    cfg = LlamaConfig.llama2_7b(n_layers=2, max_seq_len=256, lora_rank=16,
                                dtype=torch.float32, param_dtype=torch.float32)
    params = init_params(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for name, t in params.items():
        # lora_b = 0 would make every lora_a gradient exactly 0
        if name.endswith("lora_b"):
            t.normal_(0.0, 0.02, generator=g)
    tokens = np.random.default_rng(SEED + 3).integers(0, cfg.vocab_size, (1, cfg.max_seq_len))
    out = {}
    for dev in ("cuda", "cpu"):
        before = flash_bwd_dq.launches + flash_bwd_dkv.launches
        t0 = time.perf_counter()
        model, lora, _ = lora_model(cfg, {k: v.to(dev, copy=True) for k, v in params.items()})
        loss = next_token_loss(cfg, model, torch.from_numpy(tokens).to(dev))
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in lora.items()}
        out[dev] = (loss.item(), grads, time.perf_counter() - t0,
                    flash_bwd_dq.launches + flash_bwd_dkv.launches - before)
        del model, lora, loss
    check(out["cuda"][3] == 2 * cfg.n_layers, f"card backward launched {out['cuda'][3]} bwd kernels")
    # tolerance: f32 throughout with TF32 off; the card (cuBLAS, K1-K4) and
    # the CPU (plain versions) sum in other orders, which over two layers
    # and the 32000-way lm_head stays within 1e-3 of each tensor's largest
    # gradient
    worst = 0.0
    for name, gc in out["cpu"][1].items():
        scale = gc.abs().max().item()
        check(scale > 0, f"{name}: zero gradient on the CPU")
        rel = (out["cuda"][1][name] - gc).abs().max().item() / scale
        worst = max(worst, rel)
        check(rel <= 1e-3, f"{name}: card vs CPU gradient rel err {rel} > 1e-3")
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    check(loss_rel <= 1e-5, f"card vs CPU loss rel err {loss_rel} > 1e-5")
    res = dict(n_layers=cfg.n_layers, dim=cfg.dim, seq=cfg.max_seq_len, tensors=len(out["cpu"][1]),
               loss_cuda=out["cuda"][0], loss_cpu=out["cpu"][0], loss_rel_err=loss_rel,
               max_rel_err=worst, tol=1e-3, cuda_s=out["cuda"][2], cpu_s=out["cpu"][2])
    print("grad_parity", json.dumps(res))
    return res


def serve_phase(torch, np):
    from ray_tpu_torch.llm import LLMConfig, LLMServer

    t0 = time.perf_counter()
    server = LLMServer(LLMConfig(
        model_id="llama2-7b", max_seq_len=1024, max_batch_size=N_REQUESTS,
        model_kwargs={"param_dtype": torch.bfloat16},
    ))
    torch.cuda.synchronize()
    cfg = server.engine._cfg
    check(
        (cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.intermediate, cfg.vocab_size)
        == (32, 4096, 32, 32, 11008, 32000),
        f"not Llama-2-7B width: {cfg}",
    )
    n_params = sum(t.numel() for t in server.engine._params.values())
    print(f"serve: built Llama-2-7B ({n_params} params, bf16) in "
          f"{time.perf_counter() - t0:.3f} s")

    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, (N_REQUESTS, PROMPT_LEN)).tolist()
    request = {"max_new_tokens": NEW_TOKENS, "temperature": 0.0}
    server({"token_ids": prompts[0], "max_new_tokens": 2})  # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()

    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_bwd_dkv, flash_bwd_dq
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_fwd

    for fn in (rmsnorm_fwd, flash_attention_fwd, flash_bwd_dq, flash_bwd_dkv):
        fn.launches = 0
    t0 = time.perf_counter()
    answers = [server(dict(request, token_ids=p)) for p in prompts]
    wall = time.perf_counter() - t0
    for a in answers:
        check(a["num_prompt_tokens"] == PROMPT_LEN and len(a["token_ids"]) == NEW_TOKENS
              and a["finished_reason"] == "length", f"bad answer {a}")
        check(all(0 <= t < cfg.vocab_size for t in a["token_ids"]), "token out of range")

    t0 = time.perf_counter()
    stamps, streamed = [], []
    for item in server.stream(dict(request, token_ids=prompts[0])):
        stamps.append(time.perf_counter())
        if "token_id" in item:
            streamed.append(item["token_id"])
    check(streamed == answers[0]["token_ids"], "streamed tokens differ from the answered ones")
    ttft_ms = (stamps[0] - t0) * 1e3
    gaps = [(b - a) * 1e3 for a, b in zip(stamps[:NEW_TOKENS - 1], stamps[1:NEW_TOKENS])]
    serve = dict(
        requests=N_REQUESTS + 1, prompt_tokens=PROMPT_LEN, new_tokens=NEW_TOKENS,
        call_tokens_per_s=N_REQUESTS * NEW_TOKENS / wall,
        ttft_ms=ttft_ms, decode_ms_per_step_median=statistics.median(gaps),
        decode_ms_per_step_max=max(gaps),
        rmsnorm_launches=rmsnorm_fwd.launches, flash_launches=flash_attention_fwd.launches,
    )
    print("serve", json.dumps(serve))
    check(rmsnorm_fwd.launches > 0, "the serving path launched no rmsnorm kernel")
    return server, prompts, serve


def forward_phase(torch, server, prompts):
    from ray_tpu_torch.llm import LLMEngine
    from ray_tpu_torch.models.llama import build_llama
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

    engine = server.engine
    model = build_llama(engine._cfg, engine._params)  # shares the weights
    tokens = torch.tensor(prompts, device="cuda")
    before = flash_attention_fwd.launches
    with torch.inference_mode():
        for _ in range(2):  # the second pass is timed warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full = model(tokens)
            torch.cuda.synchronize()
            forward_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            prefill, _ = engine._prefill(tokens)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
    check(full.shape == (len(prompts), PROMPT_LEN, engine._cfg.vocab_size), "bad logits shape")
    check(bool(torch.isfinite(full).all()), "non-finite logits")
    last, pre = full[:, -1].float(), prefill.float()
    err = (last - pre).abs().max().item()
    mean_err = (last - pre).abs().mean().item()
    scale = pre.abs().max().item()
    # tolerance: the two paths run the same bf16 weights and activations and
    # differ only in how attention is computed (flash kernel vs f32 einsum over
    # the cache), each rounding its output to bf16 once per layer; over 32
    # layers that stays within 5% of the largest logit
    tol = 0.05 * scale
    check(err <= tol, f"full forward vs prefill logits: max_abs_err {err} > {tol}")
    top = pre.topk(2, dim=-1)
    margin = (top.values[:, 0] - top.values[:, 1]).tolist()
    same = (last.argmax(-1) == pre.argmax(-1)).tolist()
    # a first token may differ only where the prefill's top-2 margin is within
    # the measured disagreement, i.e. a tie at this precision
    for i, (eq, m) in enumerate(zip(same, margin)):
        check(eq or m <= 2 * err, f"row {i}: greedy first token differs at margin {m}")
    n = (flash_attention_fwd.launches - before) // 2
    check(n == engine._cfg.n_layers, f"a full forward launched the flash kernel {n} times")

    # the same comparison with f32 activations over the same bf16 weights:
    # both paths then agree to f32 rounding (tolerance 1e-3 after 32
    # layers), and every greedy first token must be equal
    cfg32 = dataclasses.replace(engine._cfg, dtype=torch.float32)
    engine32 = LLMEngine(cfg32, engine._params, device=tokens.device)
    with torch.inference_mode():
        last32 = build_llama(cfg32, engine._params)(tokens)[:, -1]
        pre32, _ = engine32._prefill(tokens)
    err32 = (last32 - pre32).abs().max().item()
    check(err32 <= 1e-3, f"f32 full forward vs prefill logits: max_abs_err {err32} > 1e-3")
    check(bool((last32.argmax(-1) == pre32.argmax(-1)).all()), "f32 greedy first tokens differ")
    fwd = dict(max_abs_err=err, mean_abs_err=mean_err, tol=tol, max_abs_logit=scale,
               first_tokens_equal=same, top2_margin=margin, flash_launches=n,
               f32_max_abs_err=err32, forward_ms=forward_ms, prefill_ms=prefill_ms)
    print("forward", json.dumps(fwd))
    return fwd


def device_profile(torch, fn):
    """Wall time, device busy share and the kernels that take the most
    device time of one call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, kernel_launches=len(kernels),
                device_busy_share=busy_ms / wall_ms if busy_ms else None,
                top_kernels_ms=[[name[:80], ms] for name, ms in top])


def profile_phase(torch, server, prompt):
    """Device busy share of one served request (8 new tokens) under
    torch.profiler, and the kernels that take the most device time."""
    request = {"token_ids": prompt, "max_new_tokens": 8}
    server(request)
    torch.cuda.synchronize()
    print("profile", json.dumps(device_profile(torch, lambda: server(request))))


def train_phase(torch, counters):
    """The training path through TorchTrainer.fit(), then timed steps."""
    import math
    import pickle
    import tempfile

    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.train import RunConfig, TorchTrainer
    from ray_tpu_torch.train.examples import llama_lora

    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as storage:
        t0 = time.perf_counter()
        result = TorchTrainer(
            llama_lora.train_loop_per_worker, train_loop_config=dict(TRAIN_CONFIG),
            run_config=RunConfig(name="llama-lora", storage_path=storage),
        ).fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        if result.error is not None:
            raise result.error
        with result.checkpoint.as_directory() as d:
            with open(Path(d) / "lora.pkl", "rb") as f:
                state = pickle.load(f)
    fit_peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in result.metrics_history]
    check(len(losses) == TRAIN_CONFIG["epochs"] and all(math.isfinite(x) for x in losses),
          f"bad losses {losses}")
    lora = state["lora"]
    check(state["epoch"] == TRAIN_CONFIG["epochs"] - 1, f"checkpoint of epoch {state['epoch']}")
    check(len(lora) == 32 * 4 * 2, f"checkpoint holds {len(lora)} adapter tensors, not 256")
    check(any(bool((t != 0).any()) for n, t in lora.items() if n.endswith("lora_b")),
          "every lora_b is still zero after training")
    # per step: K2 forward + recompute per layer, K3/K4 once per layer, K1
    # twice per layer forward + recompute and once for the final norm
    n_layers = 32
    want = {"rmsnorm_fwd": 4 * n_layers + 1, "flash_attention_fwd": 2 * n_layers,
            "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers}
    for name, per_step in want.items():
        check(launches[name] == per_step * TRAIN_STEPS,
              f"{name}: {launches[name]} launches in {TRAIN_STEPS} steps, want {per_step} each")

    cfg = llama_lora.model_config(TRAIN_CONFIG)
    device = torch.device("cuda", torch.cuda.current_device())
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    model, _, optimizer = llama_lora.lora_model(cfg, params)
    del params
    b = TRAIN_CONFIG["batch_per_worker"]
    tokens = llama_lora.step_tokens(cfg, b, 0, 0, 0, device)
    llama_lora.lora_train_step(model, optimizer, tokens)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss = llama_lora.lora_train_step(model, optimizer, tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(math.isfinite(loss.item()), "non-finite loss in the timed steps")
    step_peak = torch.cuda.max_memory_allocated()
    prof = device_profile(torch, lambda: llama_lora.lora_train_step(model, optimizer, tokens))
    med = statistics.median(step_ms)
    out = dict(fit_s=fit_s, losses=losses, checkpoint_tensors=len(lora),
               launches=launches, launches_per_step=want, launch_counts_match=True,
               step_ms=step_ms, step_ms_median=med, tokens_per_s=b * cfg.max_seq_len / med * 1e3,
               fit_peak_bytes=fit_peak, step_peak_bytes=step_peak, profile=prof)
    print("train", json.dumps(out))
    del model, optimizer
    return launches, out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    if not (ROOT / "ray_tpu_torch" / "csrc").is_dir():
        fail(f"no ray_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from ray_tpu_torch._internal import kernels

    build_s = kernels.build()
    print(f"build: {kernels.sources()} in {build_s:.3f} s")

    rms_rows = rmsnorm_phase(torch, F)
    flash_rows = flash_phase(torch, F)
    bwd_rows = flash_bwd_phase(torch, F)
    grad_parity_phase(torch, np)

    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_bwd_dkv, flash_bwd_dq
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_fwd

    counters = {"rmsnorm_fwd": rmsnorm_fwd, "flash_attention_fwd": flash_attention_fwd,
                "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv}
    # the serving path: serving, then the full forward; counts set to 0
    # inside serve_phase just before its requests and read here, after both
    server, prompts, _ = serve_phase(torch, np)
    forward_phase(torch, server, prompts)
    serve_launches = {name: fn.launches for name, fn in counters.items()}
    for name in ("rmsnorm_fwd", "flash_attention_fwd"):
        check(serve_launches[name] > 0, f"{name} was not launched on the serving path")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        check(serve_launches[name] == 0, f"{name} was launched on the serving path")
    profile_phase(torch, server, prompts[1])
    del server  # the training phase's peak memory is its own
    torch.cuda.empty_cache()

    # the training path: counts set to 0 inside train_phase just before
    # fit() and read just after it
    train_launches, _ = train_phase(torch, counters)
    launches = {name: serve_launches[name] + train_launches[name] for name in counters}

    def entry(name, source, replaces, rows):
        main_row = rows[0]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "launches_by_path": {"serve": serve_launches[name], "train": train_launches[name]},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
        }

    print(json.dumps({"kernels": [
        entry("rmsnorm_fwd", "ray_tpu_torch/csrc/rmsnorm.cu",
              "ray_tpu/ops/rmsnorm.py:25", rms_rows),
        entry("flash_attention_fwd", "ray_tpu_torch/csrc/flash_attention.cu",
              "ray_tpu/ops/flash_attention.py:44", flash_rows),
        entry("flash_bwd_dq", "ray_tpu_torch/csrc/flash_attention_bwd.cu",
              "ray_tpu/ops/flash_attention.py:180", bwd_rows["flash_bwd_dq"]),
        entry("flash_bwd_dkv", "ray_tpu_torch/csrc/flash_attention_bwd.cu",
              "ray_tpu/ops/flash_attention.py:240", bwd_rows["flash_bwd_dkv"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
