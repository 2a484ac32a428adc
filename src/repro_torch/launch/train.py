"""Training launcher (``repro.launch.train`` on the port).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --scaled --steps 100 --batch 4 --seq 64 --ckpt-dir /tmp/ckpt

Runs on the card (``--device cuda``, the default; the flash and ssd_scan
kernels run every attention and SSD forward) or, with ``--device cpu``, on
the plain PyTorch versions. ``--scaled`` takes the reduced config of the
same family (``--layers`` sets its depth); without it the published
config runs, cut to ``--layers`` layers when given (the reference's
launcher reads ``--layers`` only with ``--scaled``; the port cuts the
published width too, so that a full-width model fits one card). Fault tolerance:
checkpoints every ``--ckpt-every`` steps; rerunning with the same
``--ckpt-dir`` resumes from the latest checkpoint and replays identical
data (the pipeline is keyed by step).

Meshes: in a process group of several ranks (started by
``launch.mesh.spawn_ranks``, or by a launcher such as ``torchrun
--nproc-per-node N -m repro_torch.launch.train``, whose environment
``launch.mesh.init_from_env`` reads), ``--mesh host`` trains any config
(dense, MoE, Mamba hybrid, xLSTM, enc-dec, VLM) over
``make_host_mesh()``: (N/2, 2) ("data", "model") from four ranks up, FSDP
x TP (x expert parallelism) under the train rules; alone, on one device.
An MoE config's ``--batch`` must split over the data shards
(``Model.batch_shardings`` raises otherwise).
``--mesh single_pod`` / ``multi_pod`` need a world of 256 / 512 ranks.
Only rank 0 prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import ARCHS, get_arch, scaled_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.fault_tolerance import StepWatchdog, TrainRunner
from repro_torch.distributed.sharding import DEFAULT_RULES, mesh_context
from repro_torch.launch.mesh import (
    init_from_env, make_host_mesh, make_production_mesh,
)
from repro_torch.launch.shardings import batch_shardings, opt_shardings
from repro_torch.models import build_model
from repro_torch.training import (
    OptimizerConfig, batch_for_step, checkpoint, make_optimizer,
    make_train_step,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(ARCHS))
    ap.add_argument("--scaled", action="store_true",
                    help="reduced config of the same family")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single_pod", "multi_pod"])
    ap.add_argument("--remat", default="none",
                    choices=["none", "full", "dots_saveable"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fixed-batch", action="store_true",
                    help="overfit one batch (loss must drop; smoke check)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    dev = args.device
    world = init_from_env(dev)
    if args.mesh != "host":
        mesh = make_production_mesh(multi_pod=args.mesh == "multi_pod",
                                    device_type=dev)
    else:
        mesh = make_host_mesh(dev) if world > 1 else None
    if dev == "cuda" and world > 1:
        dev = f"cuda:{torch.cuda.current_device()}"
    show = not torch.distributed.is_initialized() or \
        torch.distributed.get_rank() == 0
    cfg = get_arch(args.arch)
    if args.scaled:
        over = {"num_layers": args.layers} if args.layers else {}
        cfg = scaled_config(cfg, **over)
    elif args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = build_model(cfg)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    opt = make_optimizer(OptimizerConfig(
        name=args.optimizer, learning_rate=args.lr, warmup_steps=10))

    with mesh_context(mesh, DEFAULT_RULES):
        p_sh = model.param_shardings(mesh) if mesh is not None else None
        b_sh = batch_shardings(model, shape, mesh) if mesh is not None \
            else None
        params = model.init(
            torch.Generator(device=dev).manual_seed(args.seed), dev, mesh)
        opt_state = opt.init(params, p_sh)
        state_sh = None if mesh is None else {
            "params": p_sh, "opt": opt_shardings(opt_state, p_sh, mesh)}
        step_fn = make_train_step(model, opt, remat_policy=args.remat,
                                  microbatches=args.microbatches,
                                  batch_shardings=b_sh)

        def batch_fn(step):
            s = 0 if args.fixed_batch else step
            return batch_for_step(model, shape, args.seed, s, device=dev,
                                  shardings=b_sh)

        if args.ckpt_dir:
            runner = TrainRunner(step_fn, batch_fn, args.ckpt_dir,
                                 ckpt_every=args.ckpt_every,
                                 watchdog=StepWatchdog(), shardings=state_sh)
            start = checkpoint.latest_step(args.ckpt_dir) or 0
            if start:
                if show:
                    print(f"resuming from step {start}")
                params, opt_state = runner.resume(params, opt_state,
                                                  num_steps=args.steps)
            else:
                params, opt_state = runner.run(params, opt_state,
                                               num_steps=args.steps)
            if show:
                for m in runner.metrics_log[-5:]:
                    print(m)
                if runner.watchdog.events:
                    print(f"straggler events: {len(runner.watchdog.events)}")
        else:
            t0 = time.time()
            for step in range(args.steps):
                params, opt_state, metrics = step_fn(
                    params, opt_state, batch_fn(step))
                if show and (step % max(args.steps // 10, 1) == 0
                             or step == args.steps - 1):
                    print(f"step {step:5d} loss "
                          f"{float(metrics['loss']):.4f} gnorm "
                          f"{float(metrics['grad_norm']):.3f} "
                          f"({time.time() - t0:.1f}s)")
    return params


if __name__ == "__main__":
    main()
