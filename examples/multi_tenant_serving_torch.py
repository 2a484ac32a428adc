"""Multi-tenant serving under KV pressure on the PyTorch port: three
tenants (dense + MoE + SSM) share one device; when the KV pool runs out
the Remapping Controller donates inactive tenants' parameter memory (MRU
victim order) instead of preempting.

  PYTHONPATH=src python examples/multi_tenant_serving_torch.py    # card
  PYTHONPATH=src python examples/multi_tenant_serving_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import ARCHS, scaled_config
from repro_torch.models import build_model
from repro_torch.serving import ServingEngine, TenantConfig
from repro_torch.serving.traces import tiny_trace

NAMES = ["llama3-8b", "moonshot-v1-16b-a3b", "xlstm-1.3b"]
N_PER_MODEL = 3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    tenants = {}
    for i, n in enumerate(NAMES):
        cfg = scaled_config(ARCHS[n], num_layers=4)
        params = build_model(cfg).init(
            torch.Generator(device=args.device).manual_seed(i), args.device)
        tenants[n] = TenantConfig(cfg, params, max_batch=4, max_context=48)

    eng = ServingEngine(tenants, mode="mirage", scheduler="temporal",
                        base_kv_pages=8, page_size=4, quantum_steps=4,
                        device=args.device)
    eng.submit(tiny_trace(NAMES, n_per_model=N_PER_MODEL, prompt_len=12,
                          max_new=6, vocab=256))
    eng.run(max_steps=1500)

    print("finished requests:", len(eng.finished))
    for step, kind, detail in eng.events:
        if kind in ("remap", "revert", "preempt"):
            print(f"  step {step:4d} {kind:7s} {detail}")
    print("pool segments:", [(s.source, s.num_pages)
                             for s in eng.allocator.segments])
    remap = {n: m.remapped_alpha for n, m in eng.store.models.items()}
    print("remap state:", remap)
    print("transfer stats:", eng.xfer.stats)
    eng.allocator.check_invariants()
    print("allocator invariants OK")
    assert len(eng.finished) == N_PER_MODEL * len(NAMES), \
        "every request finishes"
    return {"finished": len(eng.finished),
            "events": [e[1] for e in eng.events], "remap": remap,
            "transfers": eng.xfer.stats}


if __name__ == "__main__":
    main()
