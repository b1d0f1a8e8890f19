"""Does torch.profiler lose device records? Profiles N consecutive pooled
decode steps of the paged Llama-2-7B engine (8 slots, random bf16 weights)
on one NVIDIA card, each behind 64 spin kernels, and prints the device
records of each step, the pads seen, the host's launch calls, the kernels
missing from each short profile, and then the records and lost pads of 10
profiles through chip_smoke.device_profile.

    python3 chip_profile_loss.py [N]     # N = 60 by default

Imports nothing of JAX and nothing of the JAX package."""
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

LAUNCH_API = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
              "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy", "cudaMemset",
              "cudaLaunchCooperativeKernel", "cudaMemcpy2DAsync")


def profile(fn, pad=64):
    from torch.profiler import ProfilerActivity, profile as prof_
    with prof_(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    ev = prof.events()
    dev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    api = collections.Counter(e.name for e in ev if e.device_type != torch.autograd.DeviceType.CUDA
                              and e.name in LAUNCH_API)
    names = collections.Counter(e.name for e in dev if "spin_kernel" not in e.name)
    pads = sum("spin_kernel" in e.name for e in dev)
    return dict(records=sum(names.values()), pads_seen=pads, api=sum(api.values()),
                api_by=dict(api)), names


def main():
    from ray_tpu_torch._internal import kernels
    from ray_tpu_torch.llm import GenerationRequest, LLMConfig, LLMServer
    cs.check(torch.cuda.is_available(), "this script needs an NVIDIA card")
    print("card:", subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    CB = cs.CB
    server = LLMServer(LLMConfig(
        model_id="llama2-7b", max_seq_len=CB["max_seq_len"], max_batch_size=CB["slots"],
        kv_cache_blocks=CB["blocks"], kv_block_size=CB["block"],
        model_kwargs={"param_dtype": torch.bfloat16}))
    engine, cfg = server.engine, server.engine._cfg
    rng = np.random.default_rng(0)
    server({"token_ids": rng.integers(0, cfg.vocab_size, 320).tolist(), "max_new_tokens": 2})
    for _ in range(CB["slots"]):
        engine.add_request(GenerationRequest(
            token_ids=rng.integers(0, cfg.vocab_size, 64).tolist(), max_new_tokens=n + 40))
    cs._step_until(engine, lambda: len(engine._slots) == CB["slots"] and not engine._pending)
    for _ in range(8):
        engine.step()
    torch.cuda.synchronize()
    rows, counters = [], []
    t0 = time.perf_counter()
    for i in range(n):
        r, names = profile(engine.step)
        rows.append(r)
        counters.append(names)
    mode = collections.Counter(r["records"] for r in rows).most_common(1)[0][0]
    ref = next(c for r, c in zip(rows, counters) if r["records"] == mode)
    print("diag", json.dumps({
        "n": n, "s": time.perf_counter() - t0,
        "records": [r["records"] for r in rows], "pads_seen": [r["pads_seen"] for r in rows],
        "api": [r["api"] for r in rows], "api_by_first": rows[0]["api_by"]}))
    for i, (r, c) in enumerate(zip(rows, counters)):
        if r["records"] != mode:
            diff = {k: c.get(k, 0) - ref.get(k, 0) for k in set(c) | set(ref)
                    if c.get(k, 0) != ref.get(k, 0)}
            print("diff", i, json.dumps({k[:90]: v for k, v in diff.items()}))
    # the same through chip_smoke's own device_profile, in a fresh run of sessions
    print("device_profile", json.dumps([
        (lambda p: [p["kernel_launches"], p["pad_kernels_lost"]])(cs.device_profile(torch, engine.step))
        for _ in range(10)]))


if __name__ == "__main__":
    main()
