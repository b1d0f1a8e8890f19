#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py        # from the root of the repository

Phases, each of which exits non-zero on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from ray_tpu_torch/csrc with nvcc (one process per
     source, all at once);
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it and at edge cases, and time kernel, plain
     version and one PyTorch library call (a yardstick only: the port never
     calls it) with CUDA events, median of 21 timings of 10 launches;
  4. the main path, serving: LLMServer at full Llama-2-7B width (random bf16
     weights from seed 0) answers 4 greedy requests of 128 prompt tokens and
     32 new tokens, then streams one of them again;
  5. the main path, full forward: Llama's full-sequence forward (flash
     attention) on the same 4 prompts against the cache path's prefill, in
     bf16 and again with f32 activations;
  6. the device busy share of one served request, under torch.profiler.
The launch counters are set to 0 just before phase 4 and read just after
phase 5. The last lines are a JSON line of the kernels and the result line.

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
        if len(rows) == 0:
            b = N_REQUESTS
            q4, k4, v4 = (t.view(b, bh // b, -1, d) for t in (q, k, v))
            row["ms"] = time_ms(lambda: flash_attention_fwd(q, k, v, sm_scale=scale, causal=causal))
            row["plain_ms"] = time_ms(
                lambda: flash_attention_reference(q, k, v, sm_scale=scale, causal=causal)
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

    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_fwd

    rmsnorm_fwd.launches = 0
    flash_attention_fwd.launches = 0
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


def profile_phase(torch, server, prompt):
    """Device busy share of one served request (8 new tokens) under
    torch.profiler, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    request = {"token_ids": prompt, "max_new_tokens": 8}
    server(request)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server(request)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms, kernel_launches=len(kernels),
               device_busy_share=busy_ms / wall_ms if busy_ms else None,
               top_kernels_ms=[[name[:80], ms] for name, ms in top])
    print("profile", json.dumps(out))


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

    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_fwd

    # the main path: serving, then the full forward; counts set to 0 inside
    # serve_phase just before its requests and read here, after both
    server, prompts, _ = serve_phase(torch, np)
    forward_phase(torch, server, prompts)
    launches = {"rmsnorm_fwd": rmsnorm_fwd.launches,
                "flash_attention_fwd": flash_attention_fwd.launches}
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    profile_phase(torch, server, prompts[1])

    def entry(name, source, replaces, rows):
        main_row = rows[0]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
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
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
