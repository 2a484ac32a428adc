"""Multi-turn conversations with prefix-aware KV sharing on the elastic
paged pool, on the PyTorch port: every turn's prompt extends the previous
turn's history, so the radix-trie prefix index lets prefill fork the
already-computed KV pages (copy-on-write) instead of re-deriving them —
and the outputs are token-identical to a run with sharing disabled (the
correctness contract). On the card decode reads the pool through the
hand-written paged decode kernel.

Runs the functional engine in three configurations: mirage + sharing,
mirage without sharing, and the vllm-style fixed-pool baseline.

  PYTHONPATH=src python examples/multi_turn_serving_torch.py      # card
  PYTHONPATH=src python examples/multi_turn_serving_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import ARCHS, scaled_config
from repro_torch.models import build_model
from repro_torch.serving import ConversationSpec, ServingEngine, TenantConfig
from repro_torch.serving.traces import multi_turn_trace


def build_tenants(device):
    cfg = scaled_config(ARCHS["llama3-8b"], num_layers=2)
    params = build_model(cfg).init(
        torch.Generator(device=device).manual_seed(0), device)
    # paged=True: decode reads the shared paged pool, the data plane that
    # makes cross-request KV sharing physically possible
    return {"llama3-8b": TenantConfig(cfg, params, max_batch=4,
                                      max_context=64, paged=True)}


def conversations():
    return multi_turn_trace([ConversationSpec(
        "llama3-8b", num_sessions=3, turns=3, system_prompt_len=12,
        user_len=4, assistant_len=4, max_new_tokens=4, think_time=10.0,
        session_rate=0.05, vocab=256, sigma=0.0)], seed=11)


def run(mode: str, sharing: bool, device):
    eng = ServingEngine(build_tenants(device), mode=mode,
                        scheduler="temporal", base_kv_pages=24, page_size=4,
                        quantum_steps=4, prefix_sharing=sharing,
                        device=device)
    eng.submit(conversations())
    eng.run(max_steps=3000)
    eng.allocator.check_invariants()
    return eng


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    runs = {
        "mirage+sharing": run("mirage", True, args.device),
        "mirage": run("mirage", False, args.device),
        "vllm": run("vllm", False, args.device),
    }
    outputs, saved = {}, {}
    for name, eng in runs.items():
        met = eng.metrics()
        outputs[name] = {r.rid: list(r.generated) for r in eng.finished}
        saved[name] = met.saved_prefill_tokens
        counts = {}
        for _, kind, _d in eng.events:
            counts[kind] = counts.get(kind, 0) + 1
        print(f"{name:16s} finished={len(eng.finished)} "
              f"saved_prefill_tokens={met.saved_prefill_tokens} "
              f"hit_rate={met.prefix_hit_rate:.2f} "
              f"events={ {k: v for k, v in sorted(counts.items())} }")
        if eng.prefix:
            print(f"{'':16s} index: {eng.prefix_stats()['llama3-8b']}")
    assert outputs["mirage+sharing"] == outputs["mirage"] == outputs["vllm"], \
        "sharing/mode must never change decoded tokens"
    print("\noutput equivalence across all three configurations: OK")
    return {"outputs": outputs["mirage"], "saved_prefill_tokens": saved}


if __name__ == "__main__":
    main()
