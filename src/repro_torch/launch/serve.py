"""Multi-tenant serving CLI (functional engine, MIRAGE enabled; the
port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --tenants llama3-8b,h2o-danube-3-4b --mode mirage --requests 12

Runs scaled tenants through the continuous-batching engine with the
Remapping Controller live; prints per-request outputs, remap/revert events,
transfer statistics, the pool's segments and the metrics row, then checks
the allocator's invariants. Runs on the card (``--device cuda``, the
default: flash runs every prefill) or, with ``--device cpu``, on the plain
PyTorch versions. Each tenant's weights are drawn from ``--seed`` plus its
index.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_arch, scaled_config
from repro_torch.models import build_model
from repro_torch.serving import ServingEngine, TenantConfig
from repro_torch.serving.traces import tiny_trace


def init_params(cfg, seed: int, device):
    """A tenant's weights: the model's initialiser under ``seed``."""
    return build_model(cfg).init(
        torch.Generator(device=device).manual_seed(seed), device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", default="llama3-8b,h2o-danube-3-4b")
    ap.add_argument("--mode", default="mirage",
                    choices=["mirage", "vllm", "swap"])
    ap.add_argument("--scheduler", default="temporal",
                    choices=["temporal", "spatial"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--base-pages", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    names = args.tenants.split(",")
    tenants = {}
    for i, n in enumerate(names):
        cfg = scaled_config(get_arch(n), num_layers=args.layers)
        params = init_params(cfg, args.seed + i, args.device)
        tenants[n] = TenantConfig(cfg, params, max_batch=4, max_context=48)

    eng = ServingEngine(
        tenants, mode=args.mode, scheduler=args.scheduler,
        base_kv_pages=args.base_pages, page_size=args.page_size,
        device=args.device)
    eng.submit(tiny_trace(names, n_per_model=args.requests // len(names),
                          prompt_len=10, max_new=args.max_new, vocab=256,
                          seed=args.seed))
    eng.run(max_steps=2000)

    print(f"\n== {args.mode} / {args.scheduler} ==")
    for r in eng.finished:
        print(f"{r.rid:24s} prompt={r.prompt_len:3d} "
              f"out={r.generated[:6]}{'...' if len(r.generated) > 6 else ''} "
              f"preempt={r.preemptions}")
    kinds = {}
    for _, k, _d in eng.events:
        kinds[k] = kinds.get(k, 0) + 1
    print("events:", kinds)
    print("transfer stats:", eng.xfer.stats)
    print("pool segments:", [(s.source, s.num_pages)
                             for s in eng.allocator.segments])
    print("metrics:", eng.metrics().row())
    eng.allocator.check_invariants()
    return eng


if __name__ == "__main__":
    main()
