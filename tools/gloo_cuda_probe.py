"""Which gloo collectives take CUDA tensors, and give the right values: 2
ranks sharing one card each call every collective once on rank-dependent
inputs; rank 0 prints the Python, torch and CUDA versions, then "ok", a
wrong result, or the error of each.

    python3 tools/gloo_cuda_probe.py
"""
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _cases(rank, dev):
    """{name: (call, expected)}: each call returns its output tensor. Rank
    r holds x = [r, r + 1, r + 2, r + 3]."""
    x = torch.arange(4.0, device=dev) + rank
    both = torch.cat([torch.arange(4.0), torch.arange(4.0) + 1]).to(dev)
    total = (2 * torch.arange(4.0) + 1).to(dev)
    half = total[2 * rank:2 * rank + 2]

    def all_gather_list():
        parts = [torch.empty(4, device=dev) for _ in range(2)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    def all_gather_tensor():
        out = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out

    def reduce_scatter_tensor():
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x.clone())
        return out

    def reduce_scatter_list():
        out = torch.empty(2, device=dev)
        dist.reduce_scatter(out, [x[:2].clone(), x[2:].clone()])
        return out

    def all_reduce(op):
        def call():
            y = x.clone()
            dist.all_reduce(y, op=op)
            return y
        return call

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return y

    def all_to_all_single():
        out = torch.empty(4, device=dev)
        dist.all_to_all_single(out, x.clone())
        return out

    return {
        "all_gather (list)": (all_gather_list, both),
        "all_gather_into_tensor": (all_gather_tensor, both),
        "reduce_scatter_tensor": (reduce_scatter_tensor, half),
        "reduce_scatter (list)": (reduce_scatter_list, half),
        "all_reduce SUM": (all_reduce(dist.ReduceOp.SUM), total),
        "all_reduce MAX": (all_reduce(dist.ReduceOp.MAX),
                           torch.arange(4.0, device=dev) + 1),
        "broadcast": (broadcast, torch.arange(4.0, device=dev)),
        # rank r receives [x_0[2r:2r+2], x_1[2r:2r+2]]
        "all_to_all_single": (all_to_all_single, torch.tensor(
            [2.0 * rank, 2.0 * rank + 1, 2.0 * rank + 1, 2.0 * rank + 2],
            device=dev)),
    }


def _rank(rank: int, store: str) -> None:
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    dev = torch.device("cuda", 0)
    out = {}
    for name, (call, want) in _cases(rank, dev).items():
        try:
            got = call()
            torch.cuda.synchronize()
            out[name] = "ok" if torch.equal(got, want) else \
                f"wrong: {got.tolist()} where {want.tolist()}"
        except Exception as e:  # the probe reports what gloo refuses
            out[name] = repr(e)[:160]
    if rank == 0:
        print(sys.version.split()[0], torch.__version__, torch.version.cuda)
        for name, res in out.items():
            print(f"{name}: {res}")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(os.path.join(tmp, "store"),),
                           nprocs=2, start_method="spawn")
