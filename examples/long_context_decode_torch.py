"""Long-context decode on the PyTorch port: the sliding-window ring-buffer
KV cache (danube-style) and the distributed flash-decode that makes
global_batch=1 x 500k-token contexts shardable (the KV sequence split over
ranks, each rank's partial attention LSE-combined). The flash-decode runs
on ``--ranks`` gloo ranks spawned on this host (sharing the card on a
GPU), each holding its slice of the sequence, against one local decode.

  PYTHONPATH=src python examples/long_context_decode_torch.py     # card
  PYTHONPATH=src python examples/long_context_decode_torch.py --device cpu
"""
import argparse
import json
import os
import tempfile

import torch

from repro_torch.configs import ARCHS, scaled_config
from repro_torch.models import attention_ops as aops
from repro_torch.models import build_model

B, S, HQ, HKV, D = 1, 4096, 8, 2, 64


def _inputs(device):
    g = torch.Generator().manual_seed(2)
    q, kc, vc = (torch.randn(shape, generator=g).to(device) for shape in (
        (B, HQ, D), (B, S, HKV, D), (B, S, HKV, D)))
    pos = torch.full((B,), S - 1, dtype=torch.int32, device=device)
    kv_pos = torch.arange(S, dtype=torch.int32, device=device)[None]
    return q, kc, vc, pos, kv_pos, kv_pos <= pos[:, None]


def flash_decode_rank(rank: int, device: str, out: str) -> None:
    """One rank of the flash-decode: its contiguous slice of the cache's
    sequence; rank 0 writes the largest difference from the local decode
    of the whole cache to ``out``."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import MeshLayout
    from repro_torch.launch.mesh import make_mesh
    n = dist.get_world_size()
    mesh = make_mesh(MeshLayout(("model",), (n,)), device)
    q, kc, vc, pos, kv_pos, valid = _inputs(device)
    blk = slice(rank * S // n, (rank + 1) * S // n)
    dist_out = aops.distributed_decode_attention(
        mesh, ("model",), q, kc[:, blk], vc[:, blk], pos, kv_pos[:, blk],
        valid[:, blk])
    local = aops.decode_attention(q, kc, vc, pos, kv_pos, valid)
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"err": float((local - dist_out).abs().max()),
                       "ranks": n}, f)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # 1. SWA ring buffer: a 23-token prompt through an 8-slot window
    cfg = scaled_config(ARCHS["h2o-danube-3-4b"], sliding_window=8)
    m = build_model(cfg)
    params = m.init(torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.randint(0, cfg.vocab_size, (1, 24),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.no_grad():
        lg_full, _ = m.prefill(params, {"tokens": toks}, 32)
        _, st = m.prefill(params, {"tokens": toks[:, :23]}, 32)
        lg_step, st = m.decode_step(params, st, toks[:, 23], 32)
    ring_err = float((lg_step - lg_full).abs().max() / lg_full.abs().max())
    kv = tuple(st["blocks"][0]["mixer"]["k"].shape)
    print(f"SWA ring KV cache shape {kv} (window=8, context 24) "
          f"decode==prefill err {ring_err:.1e}")
    assert ring_err < 1e-3, ring_err

    # 2. distributed flash-decode: the KV sequence split over the ranks
    from repro_torch.launch.mesh import spawn_ranks
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "flash_decode.json")
        spawn_ranks(flash_decode_rank, args.ranks, dev.type, out)
        with open(out) as f:
            res = json.load(f)
    print(f"distributed flash-decode over {res['ranks']} ranks vs local: "
          f"max err {res['err']:.1e}")
    assert res["err"] < 1e-4, res
    print("(the dry run's long_500k cells shard this over 512 ranks: "
          "524288-token KV, global_batch=1)")
    return {"ring_err": ring_err, "cache_shape": kv,
            "flash_decode_err": res["err"]}


if __name__ == "__main__":
    main()
