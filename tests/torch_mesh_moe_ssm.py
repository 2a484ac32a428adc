"""Inputs and rank functions of ``tests/test_torch_mesh_moe_ssm.py``: mesh
training of the scaled MoE, Mamba and xLSTM stacks (f32) and the MoE's
drop pattern under a mesh, on gloo ranks on the CPU. Like
``tests/torch_mesh.py`` (whose ``train`` runs the steps) it imports no JAX,
so that the spawned ranks start from torch alone; results travel through
files."""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import warnings

import numpy as np

import torch_mesh as tm

# name -> (arch, layers): moonshot (MHA, MoE on every layer); kimi (GQA,
# MoE on every layer); jamba at 8 layers, whose pattern holds Mamba/dense,
# Mamba/MoE and attention/MoE (a 4-layer cut has no attention); xlstm at 8
# layers, which holds its sLSTM (slstm_period 8)
MODELS = {"moonshot": ("moonshot-v1-16b-a3b", 2),
          "kimi": ("kimi-k2-1t-a32b", 2),
          "jamba": ("jamba-v0.1-52b", 8),
          "xlstm": ("xlstm-1.3b", 8)}
# global batches (rows, tokens a row): 8 experts, top-2 group all tokens
# at once while t * 2 <= 64 (SMALL: 32 tokens, g = 1, the count exchange),
# else one group per data rank (BIG: 64 tokens, g = data shards)
BIG, SMALL = (4, 16), (4, 8)
# (model, batch, mesh, optimizer)
CASES = tuple(
    [(name, BIG, layout, "adamw") for name in MODELS
     for layout in tm.MESHES]
    + [("moonshot", SMALL, layout, "adamw") for layout in tm.MESHES[:2]]
    + [("moonshot", BIG, (2, 2), "adafactor")])


def cfg(name: str):
    from repro_torch.configs import ARCHS, scaled_config
    arch, layers = MODELS[name]
    return scaled_config(ARCHS[arch], num_layers=layers)


def case_name(name: str, batch, layout, opt: str) -> str:
    return f"{name}_{batch[0]}x{batch[1]}_{layout[0]}x{layout[1]}_{opt}"


def same_groups(name: str, batch, layout) -> bool:
    """Whether the case's MoE layers route in the groups of one rank's run
    (one group of every token): a config without MoE, one data shard, or a
    batch small enough for g = 1."""
    return MODELS[name][0] == "xlstm-1.3b" or layout[0] == 1 \
        or batch == SMALL


def batches(seed: int = 0) -> dict:
    """Every model's steps at each batch of its cases, keyed
    "{model}/{b}x{s}/batch{i}/..."."""
    z = {}
    for name in MODELS:
        for b, s in sorted({c[1] for c in CASES if c[0] == name}):
            z.update(tm.make_batches(seed, cfg(name).vocab_size, b, s,
                                     f"{name}/{b}x{s}/"))
    return z


def train(z: dict, mesh, name: str, batch, opt: str):
    """``tm.train`` of model ``name`` from "{name}/params/..." on the steps
    of ``batch``."""
    b, s = batch
    sub = {k[len(name) + 1:]: v for k, v in z.items()
           if k.startswith(f"{name}/params/")}
    sub.update({k[len(f"{name}/{b}x{s}/"):]: v for k, v in z.items()
                if k.startswith(f"{name}/{b}x{s}/")})
    return tm.train(sub, mesh, opt, cfg(name), b, s)


# the launcher on the world's host mesh ((2, 2) from 4 ranks): a scaled MoE
# and a scaled Mamba hybrid (4 layers: Mamba/dense, Mamba/MoE, Mamba/dense,
# attention/MoE), 5 steps on one batch of 32 tokens (the MoE's one group)
CLI = {"moonshot": ["--arch", "moonshot-v1-16b-a3b", "--layers", "2"],
       "jamba": ["--arch", "jamba-v0.1-52b", "--layers", "4"]}
CLI_COMMON = ["--device", "cpu", "--scaled", "--fixed-batch", "--steps",
              "5", "--batch", "4", "--seq", "8", "--lr", "1e-2"]


def cli_losses(argv) -> list:
    """The losses ``launch.train.main(argv)`` prints (only rank 0 prints
    under a mesh)."""
    from repro_torch.launch import train as launch_train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_train.main(argv)
    return [float(line.split()[3]) for line in buf.getvalue().splitlines()
            if line.startswith("step")]


def train_rank(rank: int, inputs: str, out: str, cases=CASES) -> None:
    """One of 4 gloo ranks: every case of ``cases``, ``Model.init(mesh=)``
    of each of their models against the rank's block of one rank's init,
    and the launcher runs of ``CLI``. Rank 0 writes the results to ``out``
    (npz) and ``out``.json."""
    import torch
    from repro_torch.distributed.sharding import MeshLayout, local_shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    warnings.simplefilter("ignore", RuntimeWarning)
    z = dict(np.load(inputs))
    arrays, meta = {}, {}
    meshes = {layout: make_mesh(MeshLayout(tm.AXES, layout), "cpu")
              for layout in tm.MESHES}
    for name, batch, layout, opt in cases:
        case = case_name(name, batch, layout, opt)
        losses, norms, params, state, counts = train(
            z, meshes[layout], name, batch, opt)
        meta[case] = {"loss": losses, "grad_norm": norms,
                      "collectives": counts}
        for key, leaf in tm.paths({"params": params, "opt": state}):
            arrays[f"{case}/{key}"] = leaf.numpy()
    for name in sorted({c[0] for c in cases}):
        model = build_model(cfg(name))
        whole = model.init(torch.Generator().manual_seed(1), "cpu")
        for layout, mesh in meshes.items():
            sharded = model.init(torch.Generator().manual_seed(1), "cpu",
                                 mesh)
            meta[f"init_{name}_{layout[0]}x{layout[1]}"] = all(
                torch.equal(a, local_shard(b, sh.spec, mesh))
                for a, b, sh in zip(tree_leaves(sharded), tree_leaves(whole),
                                    tree_leaves(model.param_shardings(mesh))))
    for name, argv in CLI.items():
        meta[f"cli_{name}"] = cli_losses(argv + CLI_COMMON)
    if rank == 0:
        np.savez(out, **arrays)
        with open(out + ".json", "w") as f:
            json.dump(meta, f)


# ------------------------------------------------------- the drop pattern
# a moonshot MoE layer whose capacity binds (capacity factor 0.25, min 1)
# under routing skewed towards two experts; token counts (rows x tokens):
# 32 (t * k = 64 <= 8 E: g = 1) and 96 (g = data shards)
ROUTE_TOKENS = ((4, 8), (4, 24))
ROUTE_MESHES = ((2, 2), (4, 1))


def route_cfg():
    c = cfg("moonshot")
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=0.25, min_capacity=1))


def route_inputs(seed: int = 3) -> dict:
    """x of each token count, every token near one direction (so most
    pick the same experts and capacity drops the later ones)."""
    rng = np.random.default_rng(seed)
    d = route_cfg().d_model
    base = rng.standard_normal(d).astype(np.float32) * 3
    return {f"x{b}x{s}": (base + 0.3 * rng.standard_normal((b, s, d))
                          ).astype(np.float32) for b, s in ROUTE_TOKENS}


def route_rank(rank: int, inputs: str, out: str) -> None:
    """One of 4 gloo ranks: the MoE layer (params "moe/...") on each mesh
    of ``ROUTE_MESHES`` and token count of ``ROUTE_TOKENS``, on the rank's
    rows: ``route``'s slot and disp (disp's tokens in the global
    numbering, T where the slot is empty here), the output, the aux loss
    and the ``return_stats`` counts, and the gradients of the router and
    of the rank's expert blocks gathered whole. Rank 0 writes ``out``
    (npz) with every rank's slot/disp."""
    import torch
    from repro_torch.distributed.collectives import gather_over
    from repro_torch.distributed.sharding import (
        MeshLayout, gather_full, get_rules, local_shard, mesh_context,
        mesh_index, spec_for,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.blocks import MoE, _gathered
    warnings.simplefilter("ignore", RuntimeWarning)
    z = dict(np.load(inputs))
    c = route_cfg()
    moe = MoE()
    specs = moe.specs(c)
    full = {k[4:]: torch.from_numpy(v) for k, v in z.items()
            if k.startswith("moe/")}
    res = {}
    for layout in ROUTE_MESHES:
        mesh = make_mesh(MeshLayout(tm.AXES, layout), "cpu")
        data = mesh_index(mesh, ("data",))
        tag = f"{layout[0]}x{layout[1]}"
        with mesh_context(mesh):
            sp = {n: spec_for(s.logical, s.shape, mesh, get_rules())
                  for n, s in specs.items()}
            p = {n: local_shard(full[n], sp[n], mesh).requires_grad_()
                 for n in specs}
            for b, s in ROUTE_TOKENS:
                x = torch.from_numpy(z[f"x{b}x{s}"])
                rows = b // layout[0]
                xl = x[data * rows:(data + 1) * rows]
                w, _ = _gathered(moe, p, c, mesh)
                _, _, disp, _, slot, cap = moe.route(
                    w, xl.reshape(-1, c.d_model), c, mesh)
                t_l = rows * s
                gdisp = torch.where(disp < t_l, disp + data * t_l, b * s)
                key = f"{tag}/{b}x{s}"
                res[f"{key}/slot"] = gather_over(
                    slot, mesh, ("data",), "test").numpy()
                res[f"{key}/disp"] = gather_over(
                    gdisp, mesh, ("data",), "test").numpy()
                res[f"{key}/cap"] = np.array(cap)
                y, aux, counts = moe(p, xl, c, return_stats=True, mesh=mesh)
                res[f"{key}/y"] = gather_over(
                    y.detach(), mesh, ("data",), "test").numpy()
                res[f"{key}/aux"] = aux.detach().numpy()
                res[f"{key}/counts"] = counts.numpy()
                # the loss's gradient: each rank's part of the global one
                loss = (y * y).sum() / (b * s) + aux
                grads = torch.autograd.grad(loss, [p[n] for n in specs])
                for n, g in zip(specs, grads):
                    res[f"{key}/grad/{n}"] = gather_full(
                        g, sp[n], mesh).numpy()
    if rank == 0:
        np.savez(out, **res)
