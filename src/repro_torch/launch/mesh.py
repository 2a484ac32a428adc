"""Production and host meshes (PyTorch counterpart of
``repro.launch.mesh``).

  single pod : (16, 16)        axes ("data", "model")   = 256 ranks
  multi-pod  : (2, 16, 16)     axes ("pod", "data", "model") = 512 ranks

`pod` is the slowest axis (data-center interconnect): only DP gradient
reduction and optional FSDP parameter sharding cross it.

Each layout is available two ways: as a ``MeshLayout`` (axis names and
sizes, no ranks behind them: what ``spec_for`` and the analytic models
read, so a 512-rank layout resolves in one process), and as a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, which the caller initialises first (address, world size and
rank are its own to give). Building a mesh creates its process groups, a
collective call that every rank makes; importing this module does nothing.

``init_from_env`` joins the world a launcher such as ``torchrun``
describes in the environment. ``spawn_ranks`` starts such a world on one
host: processes made with
``spawn`` (CUDA cannot fork), which meet through a ``FileStore`` in a
temporary directory; several of them may share one card over gloo (NCCL
refuses two ranks on one device).
"""
from __future__ import annotations

import os
import tempfile

from repro_torch.distributed.sharding import MeshLayout

HOST_AXES = ("data", "model")


def production_layout(*, multi_pod: bool = False) -> MeshLayout:
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))


def host_layout(n: int) -> MeshLayout:
    """The host mesh over ``n`` ranks: (n // 2, 2) from four ranks up,
    else (n, 1)."""
    if n >= 4:
        return MeshLayout(HOST_AXES, (n // 2, 2))
    return MeshLayout(HOST_AXES, (n, 1))


def make_mesh(layout: MeshLayout, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``layout`` over the default process group's
    ranks in order; the world must hold exactly ``layout.size`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != layout.size:
        raise ValueError(
            f"a {dict(layout.shape)} mesh needs {layout.size} ranks; the "
            f"world holds {world}")
    return init_device_mesh(device_type, layout.sizes,
                            mesh_dim_names=layout.axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    return make_mesh(production_layout(multi_pod=multi_pod), device_type)


def make_host_mesh(device_type: str = "cuda"):
    """The host mesh over however many ranks the world holds."""
    import torch.distributed as dist
    return make_mesh(host_layout(dist.get_world_size()), device_type)


def init_from_env(device_type: str = "cuda") -> int:
    """Join the process group that a launcher (``torchrun``) describes in
    the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, ``LOCAL_RANK``) unless one is up; returns the world's
    size (1 with no launcher). NCCL where each rank has a card of its own,
    gloo where ranks share one (NCCL refuses two ranks on one device) or
    run on the CPU; a CUDA rank takes card ``LOCAL_RANK`` modulo the
    cards."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return 1
    backend = "gloo"
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % cards)
        if cards >= world:
            backend = "nccl"
    dist.init_process_group(backend)
    return world


def _rank_main(rank: int, fn, world: int, store: str, args: tuple) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args) -> None:
    """Run ``fn(rank, *args)`` on ``world`` local ranks of one gloo process
    group and wait for them. ``fn`` must be importable by name (a
    module-level function); it returns nothing, so results travel through
    files the caller names in ``args``. A rank that raises stops the
    others and makes this raise with its traceback."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _rank_main, args=(fn, world, os.path.join(tmp, "store"), args),
            nprocs=world, join=True, start_method="spawn")
