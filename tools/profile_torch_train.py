"""Where a training step of the PyTorch/CUDA port spends its time, on one
GPU.

    python3 tools/profile_torch_train.py [--arch xlstm-1.3b] [--layers 0]
        [--seq 512] [--remat none] [--steps 1]

Builds ``--arch`` at full width (bf16, seeded random weights; ``--layers``
cuts the depth, 0 keeps the config's), one sequence of ``--seq`` tokens,
AdamW as chip_smoke.py's phase 14 sets it up, ``make_train_step`` with
``--remat``; then profiles training steps on that batch with
``chip_smoke.step_profile`` (one warm step, ``--steps`` unprofiled ones for
the wall time, as many under the profiler) and prints the wall time per
step, the launches, the device time and the device's idle share, and the
device time by kernel (top 12). Meant for the steps whose launches make
the profiler too slow for chip_smoke.py (xlstm-1.3b's sLSTM time loops:
~10^5 launches a step). Needs a CUDA device; imports neither JAX nor the
JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import chip_smoke  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.training import (  # noqa: E402
    OptimizerConfig, make_optimizer, make_train_step,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b", choices=sorted(ARCHS))
    ap.add_argument("--layers", type=int, default=0,
                    help="depth cut (0: the config's depth)")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--remat", default="none",
                    choices=["none", "full", "dots_saveable"])
    ap.add_argument("--steps", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = ARCHS[args.arch]
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model, params = chip_smoke._init(cfg, 0, "profile-train", "")
    opt = make_optimizer(OptimizerConfig(**chip_smoke.TRAIN_OPT))
    state = opt.init(params)
    step = make_train_step(model, opt, remat_policy=args.remat)
    batch = chip_smoke.train_batches(model, args.seq, [0])[0]

    def one():
        nonlocal params, state
        params, state, _ = step(params, state, batch)

    prof = chip_smoke.step_profile(one, args.steps, top=12)
    wall, dev = prof["wall_ms"], prof["dev_ms"]
    chip_smoke.log(
        f"[profile-train] {cfg.name} {cfg.num_layers} layers {cfg.dtype}, "
        f"B=1 S={args.seq}, remat {args.remat}: wall {wall:.1f} ms a step; "
        f"under the profiler {prof['prof_ms']:.1f} ms, "
        f"{prof['launches']:.0f} kernel launches, device {dev:.1f} ms; "
        f"device idle share {max(0.0, 1 - dev / wall):.3f} of the "
        f"unprofiled step; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    chip_smoke.log("[profile-train] device time per step by kernel: "
                   + ", ".join(f"{k} {ms:.3f} ms ({n:.0f} calls)"
                               for k, ms, n in prof["top"]))


if __name__ == "__main__":
    main()
