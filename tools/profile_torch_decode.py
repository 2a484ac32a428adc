"""Where a decode step of the PyTorch/CUDA port spends its time, on one GPU.

    python3 tools/profile_torch_decode.py [--steps 8] [--batch 8] [--prompt 512]

Serves llama3-8b at full width and depth (bf16, seeded random weights)
through the paged ``ServingEngine`` (monolithic prefill), then traces
``--steps`` decode-only engine steps with ``torch.profiler`` and prints: the
wall time per step, the device time per step (sum of kernel times), the
device's idle share (1 - device / wall), the device time by kernel (top 12)
and the host-side launch count per step. Needs a CUDA device; imports
neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ServingEngine, TenantConfig  # noqa: E402
from repro_torch.serving.traces import tiny_trace  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=512)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_decode: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = ARCHS["llama3-8b"]
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")
    eng = ServingEngine(
        {cfg.name: TenantConfig(cfg, params, max_batch=args.batch,
                                max_context=args.prompt + 64, paged=True)},
        mode="mirage", base_kv_pages=64 * args.batch, page_size=16,
        device="cuda")
    trace = tiny_trace([cfg.name], n_per_model=args.batch,
                       prompt_len=args.prompt, max_new=args.steps + 8,
                       vocab=cfg.vocab_size, seed=0)
    eng.submit(trace)
    with warnings.catch_warnings():      # run() warns at its step budget
        warnings.simplefilter("ignore", RuntimeWarning)
        while not all(r.generated for r in trace):
            eng.run(max_steps=eng.step_idx + 1)
        eng.run(max_steps=eng.step_idx + 2)          # warm decode steps
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.run(max_steps=eng.step_idx + args.steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    step_ms = wall / args.steps * 1e3
    dev_ms = dev_us / 1e3 / args.steps
    print(f"[profile] llama3-8b 32 layers bf16, batch {args.batch}, context "
          f"~{args.prompt}: {args.steps} decode steps; wall {step_ms:.3f} ms "
          f"per step, device {dev_ms:.3f} ms per step, device idle share "
          f"{1 - dev_ms / step_ms:.3f}; {launches / args.steps:.0f} kernel "
          f"launches per step")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / args.steps:9.3f}"
              f" ms/step  {e.count / args.steps:6.0f} calls/step  {e.key[:90]}")


if __name__ == "__main__":
    main()
