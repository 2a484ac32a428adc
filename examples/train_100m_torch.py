"""End-to-end training on the PyTorch port: a ~100M-parameter
llama-family model trained on synthetic data (the port's
``training.batch_for_step``); on the card the attention forward is the
hand-written flash kernel, and the whole step runs as one CUDA graph
(``training.train_graph``, the counterpart of the reference's ``jax.jit``).

  PYTHONPATH=src python examples/train_100m_torch.py --steps 200  # card
  PYTHONPATH=src python examples/train_100m_torch.py --device cpu --steps 8

(The same step runs the published configs through
``repro_torch.launch.train``.)
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import build_model
from repro_torch.training import (
    OptimizerConfig, batch_for_step, make_optimizer, make_train_step,
)
from repro_torch.training.train_graph import compile_train_step


def config_100m():
    # llama-family, ~100M params: 12L x d512 x ffn 2048, 16k vocab
    return dataclasses.replace(
        ARCHS["llama3-8b"],
        num_layers=12, d_model=512, num_heads=8, num_kv_heads=4,
        head_dim=64, d_ff=2048, vocab_size=16384, dtype="float32")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--fixed-batch", action="store_true", default=True)
    args = ap.parse_args(argv)

    cfg = config_100m()
    model = build_model(cfg)
    print(f"params: {cfg.param_count() / 1e6:.1f}M")
    params = model.init(torch.Generator(device=args.device).manual_seed(0),
                        args.device)
    opt = make_optimizer(OptimizerConfig(
        name="adamw", learning_rate=3e-4, warmup_steps=20))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, remat_policy="none")
    if torch.device(args.device).type == "cuda":
        step_fn = compile_train_step(step_fn, args.device)
    shape = ShapeConfig("ex", args.seq, args.batch, "train")

    t0 = time.time()
    losses = []
    for step in range(args.steps):
        data_step = 0 if args.fixed_batch else step
        batch = batch_for_step(model, shape, seed=0, step=data_step,
                               device=args.device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % max(args.steps // 10, 1) == 0:
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"({(time.time() - t0):.1f}s)")
    first, last = losses[0], losses[-1]
    print(f"loss {first:.4f} -> {last:.4f} over {args.steps} steps "
          f"({'OK: learning' if last < first else 'WARN: not decreasing'})")
    assert last < first, "the loss must fall"
    return {"losses": losses, "seconds": time.time() - t0}


if __name__ == "__main__":
    main()
