"""Quickstart on the PyTorch port: build a model, prefill, decode — then
remap half its layers' parameter memory MIRAGE-style and show that decode
is token-identical while the device parameter footprint shrinks. On the
card the cycling layers sit in pinned host memory and stream into device
slots on a copy stream (``core.StreamingFetch``).

  PYTHONPATH=src python examples/quickstart_torch.py               # card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import ARCHS, scaled_config
from repro_torch.core import make_fetch, make_plan, split_blocks
from repro_torch.models import build_model
from repro_torch.models.common import tree_bytes

STEPS, CONTEXT = 8, 32


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = scaled_config(ARCHS["llama3-8b"], num_layers=8)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    prompt = torch.randint(0, cfg.vocab_size, (1, 12),
                           generator=torch.Generator().manual_seed(1)).to(dev)

    def decode(p, fetch=None):
        # a fresh prefill each time: decode writes its K/V rows in place
        logits, st = model.prefill(params, {"tokens": prompt}, CONTEXT)
        tok = logits.argmax(-1)
        out = []
        for _ in range(STEPS):
            logits, st = model.decode_step(p, st, tok, CONTEXT,
                                           fetch=fetch() if fetch else None)
            tok = logits.argmax(-1)
            out.append(int(tok[0]))
        return out

    with torch.no_grad():
        first = int(model.prefill(params, {"tokens": prompt},
                                  CONTEXT)[0].argmax(-1)[0])
        print("prefill -> first token:", first)
        out_plain = decode(params)
        print("dense decode:  ", out_plain)

        # MIRAGE: donate 4 of 8 layers' memory to KV; 6 layers cycle
        # (m = alpha + 2)
        plan = make_plan(n=8, alpha=4, t_c=1.0, t_t=0.3, double_buffer=True)
        print(f"remap plan: alpha={plan.alpha} m={plan.m} "
              f"cycle={plan.cycle_layers} resident={plan.resident_layers}")
        resident, cycle, maps = split_blocks(params["blocks"], plan,
                                             pin_cycle=dev.type == "cuda")
        # the remapped decode reads no whole stack: every layer comes
        # through the fetch, the cycling ones from host on the card
        out_remap = decode(dict(params, blocks=None),
                           lambda: make_fetch(resident, cycle, maps,
                                              slots=plan.beta))
        print("remap decode:  ", out_remap)
    assert out_plain == out_remap, "remapping must never change outputs"

    full = tree_bytes(model.specs()["blocks"])
    freed = plan.alpha * full // plan.n
    print(f"device param bytes freed for KV: {freed:,} of {full:,} "
          f"({100 * freed / full:.0f}%) — outputs identical ✓")
    return {"plain": out_plain, "remap": out_remap, "freed": freed,
            "full": full}


if __name__ == "__main__":
    main()
