#!/usr/bin/env python3
"""Where the card's f32 error in a full-width MoE layer's gradients arises.

    python3 chip_moe_error.py        # from the root of the repository, on an H100

One layer of Mixtral-8x7B width (b=1 x seq 256, f32, TF32 off, the weights
of chip_smoke.py's card-vs-host parity) runs ``next_token_loss`` and its
backward three times: on the host in f64 (the reference values), on the
host in f32 and on the card in f32. For the two f32 runs it prints, relative
to the largest f64 value of each tensor: every parameter gradient's error;
the error of the experts' input slabs, of the SwiGLU product h that feeds
w_down, and of dy, the gradient at w_down's output; and w_down's gradient
split into the error of its own product (the run's gradient against h^T dy
summed in f64 from the run's h and dy) and the error it inherits (that f64
sum against the f64 run's). Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> None:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_moe_error: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import MOE_PARITY_SEQ, SEED
    from ray_tpu_torch.models import moe as M

    torch.backends.cuda.matmul.allow_tf32 = False
    print("card:", subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())

    saved = {}

    def experts(self, inp):  # MoEFFN.experts, keeping its slabs, h and dy
        gate = torch.bmm(inp, self.w_gate.to(inp.dtype))
        up = torch.bmm(inp, self.w_up.to(inp.dtype))
        h = F.silu(gate) * up
        out = torch.bmm(h, self.w_down.to(inp.dtype))
        saved["inp"], saved["h"] = inp.detach(), h.detach()
        out.register_hook(lambda grad: saved.__setitem__("dy", grad.detach()))
        return out

    M.MoEFFN.experts = experts
    cfg = M.MoEConfig.mixtral_8x7b(n_layers=1, max_seq_len=MOE_PARITY_SEQ,
                                   dtype=torch.float32, remat=False)
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    base = {k: v.cpu() for k, v in M.init_params(cfg, g, "cuda").items()}
    tokens = torch.randint(0, cfg.vocab_size, (1, MOE_PARITY_SEQ),
                           generator=torch.Generator().manual_seed(SEED + 9))
    truth, out = None, {}
    for run, dev, dtype in (("f64", "cpu", torch.float64), ("host", "cpu", torch.float32),
                            ("card", "cuda", torch.float32)):
        t0 = time.perf_counter()
        c = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
        model = M.build_moe(c, {k: v.to(dev, dtype, copy=True) for k, v in base.items()},
                            trainable=True)
        M.next_token_loss(c, model, tokens.to(dev)).backward()
        got = {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}
        got.update({k: v.double().cpu() for k, v in saved.items()})
        got["w_down_from_h_dy"] = torch.bmm(got["h"].transpose(1, 2), got["dy"])
        del model
        if truth is None:
            truth = got
            continue

        def rel(a, b):
            return ((a - b).abs().max() / b.abs().max()).item()

        w_down = "layer_0.moe.w_down"
        out[run] = dict(
            s=time.perf_counter() - t0,
            grads={n: rel(got[n], truth[n]) for n in truth if n.startswith(("layer_", "embed",
                                                                            "final", "lm_"))},
            slabs=rel(got["inp"], truth["inp"]), h=rel(got["h"], truth["h"]),
            dy=rel(got["dy"], truth["dy"]),
            w_down_own_product=rel(got[w_down], got["w_down_from_h_dy"]),
            w_down_inherited=rel(got["w_down_from_h_dy"], truth["w_down_from_h_dy"]),
        )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
