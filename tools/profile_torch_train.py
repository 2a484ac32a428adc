"""Where a training step of the PyTorch/CUDA port spends its time, on one
GPU.

    python3 tools/profile_torch_train.py [--arch xlstm-1.3b] [--layers 0]
        [--seq 512] [--remat none] [--steps 1] [--graphs on|off|both]

Builds ``--arch`` at full width (bf16, seeded random weights; ``--layers``
cuts the depth, 0 keeps the config's), one sequence of ``--seq`` tokens,
AdamW as chip_smoke.py's phase 14 sets it up, ``make_train_step`` with
``--remat``; then profiles training steps on that batch with
``chip_smoke.step_profile`` (one warm step, ``--steps`` unprofiled ones for
the wall time, as many under the profiler) and prints the wall time per
step, the launches, the device time and the device's idle share (1 -
device / wall, from different steps of one run: unclipped, so noise can
take it below 0 where the device is never idle), and the
device time by kernel (top 12). ``--graphs on`` (the default) runs the
compiled step (``training.train_graph``: the warm step is its capture, and
its capture ms and graph pool are printed), ``off`` the eager step,
``both`` the eager step and then the compiled one on the same state (the
eager step's cached memory is freed first: the graph's pool holds a step's
activations). Meant for the steps whose launches make the profiler too
slow for chip_smoke.py (xlstm-1.3b's sLSTM time loops: ~10^5 launches an
eager step). Needs a CUDA device; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
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
from repro_torch.training.train_graph import (  # noqa: E402
    compile_train_step,
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
    ap.add_argument("--graphs", choices=("on", "off", "both"), default="on",
                    help="the compiled step, the eager one, or both")
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
    batch = chip_smoke.train_batches(model, args.seq, [0])[0]
    for mode in (("off", "on") if args.graphs == "both" else (args.graphs,)):
        step = make_train_step(model, opt, remat_policy=args.remat)
        if mode == "on":
            step = compile_train_step(step)

        def one():
            nonlocal params, state
            params, state, _ = step(params, state, batch)

        torch.cuda.reset_peak_memory_stats()
        prof = chip_smoke.step_profile(one, args.steps, top=12)
        wall, dev = prof["wall_ms"], prof["dev_ms"]
        graph = "" if mode == "off" else (
            f"; capture {step.stats.capture_ms:.1f} ms, graph pool "
            f"{step.stats.pool_bytes / 2**20:.1f} MiB, "
            f"{step.stats.captures} captures, {step.stats.replays} replays")
        chip_smoke.log(
            f"[profile-train] {cfg.name} {cfg.num_layers} layers {cfg.dtype}, "
            f"B=1 S={args.seq}, remat {args.remat}, graphs {mode}: wall "
            f"{wall:.1f} ms a step; under the profiler {prof['prof_ms']:.1f} "
            f"ms, {prof['launches']:.0f} kernel launches, device {dev:.1f} "
            f"ms; device idle share {1 - dev / wall:.3f} of the unprofiled "
            f"step (unclipped: below 0 where the profiled steps' device time "
            f"exceeds the unprofiled steps' wall); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB{graph}")
        chip_smoke.log(f"[profile-train] graphs {mode}: device time per step "
                       "by kernel: " + ", ".join(
                           f"{k} {ms:.3f} ms ({n:.0f} calls)"
                           for k, ms, n in prof["top"]))
        del step, one
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
