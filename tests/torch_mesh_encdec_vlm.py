"""Inputs and rank functions of ``tests/test_torch_mesh_encdec_vlm.py``:
mesh training of scaled whisper (enc-dec) and scaled llava (VLM), f32, on
gloo ranks on the CPU; and ``tests/test_torch_dryrun.py``'s real step
(``step_stats_rank``), whose collectives the dry run's must equal. Like ``tests/torch_mesh.py`` (whose ``train`` runs
the steps) it imports no JAX, so that the spawned ranks start from torch
alone; results travel through files."""
from __future__ import annotations

import dataclasses
import json
import warnings

import numpy as np

import torch_mesh as tm

# name -> (arch, layers, vocab override): whisper at 2 + 2 layers (MHA: its
# 4 KV heads split with the query heads); its odd-vocabulary twin, whose
# 509 rows the model axis does not divide (the spec fallback keeps the
# vocabulary whole, as it keeps whisper-medium's 51865); llava at 2 layers
# with 16 patch rows (GQA 4/2)
MODELS = {"whisper": ("whisper-medium", 2, 0),
          "whisper_odd": ("whisper-medium", 2, 509),
          "llava": ("llava-next-34b", 2, 0)}
# global batch: 4 rows; whisper's 32 frames and 16 decoder tokens, llava's
# 16 patch rows and 16 tokens (32 positions)
BATCH, FRAMES, DEC, SEQ = 4, 32, 16, 32
# (model, mesh)
CASES = tuple([(name, layout) for name in ("whisper", "llava")
               for layout in tm.MESHES] + [("whisper_odd", (2, 2))])
# the per-leaf gradient checks of the first batch: FSDP x TP and TP alone
# (the frames split over the model axis, the encoder reached through every
# rank's cross-attention heads)
GRAD_CASES = (("whisper", (2, 2)), ("whisper", (1, 4)), ("llava", (2, 2)),
              ("llava", (1, 4)))


def cfg(name: str):
    from repro_torch.configs import ARCHS, scaled_config
    arch, layers, vocab = MODELS[name]
    c = scaled_config(ARCHS[arch], num_layers=layers)
    return dataclasses.replace(c, vocab_size=vocab) if vocab else c


def case_name(name: str, layout) -> str:
    return f"{name}_{layout[0]}x{layout[1]}"


def shape_seq(name: str) -> int:
    """The train shape's sequence: whisper's frames, llava's positions."""
    return FRAMES if MODELS[name][0] == "whisper-medium" else SEQ


def batches(seed: int = 0) -> dict:
    """Each model's ``tm.STEPS`` global batches, keyed
    "{model}/batch{i}/...": whisper's frames, tokens, targets and a mask
    with a few zeros; llava's patch rows, tokens, and targets and a mask
    over all positions (zero on the patch rows, as ``batch_for_step``)."""
    rng = np.random.default_rng(seed)
    z = {}
    for name in MODELS:
        c = cfg(name)
        whisper = c.is_encoder_decoder
        for i in range(tm.STEPS):
            pre = f"{name}/batch{i}/"
            n = DEC if whisper else SEQ
            toks = rng.integers(0, c.vocab_size, (BATCH, n + 1),
                                dtype=np.int32)
            mask = np.ones((BATCH, n), np.float32)
            mask[:, :i + 1] = 0.0
            p = 0
            if whisper:
                z[pre + "frames"] = rng.standard_normal(
                    (BATCH, FRAMES, c.d_model)).astype(np.float32)
            else:
                p = c.num_image_patches
                z[pre + "patch_embeds"] = rng.standard_normal(
                    (BATCH, p, c.d_model)).astype(np.float32) * 0.5
                mask[:, :p] = 0.0
            z[pre + "tokens"] = toks[:, p:-1].copy()
            z[pre + "targets"] = toks[:, 1:].copy()
            z[pre + "mask"] = mask
    return z


def _sub(z: dict, name: str) -> dict:
    """Model ``name``'s params and batches, keyed as ``tm.train`` reads
    them."""
    return {k[len(name) + 1:]: v for k, v in z.items()
            if k.startswith(name + "/")}


def train(z: dict, mesh, name: str):
    """``tm.train`` of model ``name`` (AdamW)."""
    return tm.train(_sub(z, name), mesh, "adamw", cfg(name), BATCH,
                    shape_seq(name))


def grads(z: dict, mesh, name: str) -> dict:
    """Every leaf's gradient of the loss of model ``name`` at its init on
    its first batch, the whole leaf (gathered from the rank's blocks and
    summed over the data axes that do not split it, as the train step
    sums it), keyed by path."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.collectives import sum_over
    from repro_torch.distributed.sharding import (
        batch_axis_names, gather_full, local_shard, mesh_context,
    )
    from repro_torch.launch.shardings import batch_shardings
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    model = build_model(cfg(name))
    sub = _sub(z, name)
    full = tm._unflatten(model.specs(), tm._tensors(sub, "params/"))
    batch = tm._tensors(sub, "batch0/")
    with mesh_context(mesh):
        ps = bs = None
        params = full
        if mesh is not None:
            ps = model.param_shardings(mesh)
            bs = batch_shardings(model, ShapeConfig(
                "t", shape_seq(name), BATCH, "train"), mesh)
            params = tree_map(lambda x, sh: local_shard(x, sh.spec, mesh),
                              full, ps)
            batch = {k: local_shard(v, bs[k].spec, mesh)
                     for k, v in batch.items()}
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        tree = tree_map(lambda _: next(it), params)
        loss = model.train_loss(tree, batch, "dots_saveable",
                                batch_shardings=bs)
        out = torch.autograd.grad(loss, leaves)
        if mesh is not None:
            data = batch_axis_names(mesh)
            out = [gather_full(sum_over(
                g, mesh, [ax for ax in data if ax not in sh.split_axes()],
                "check"), sh.spec, mesh)
                for g, sh in zip(out, tree_leaves(ps))]
    it = iter(out)
    return {k: v.numpy() for k, v in tm.paths(
        tree_map(lambda _: next(it), params))}


def train_rank(rank: int, inputs: str, out: str, cases=CASES,
               grad_cases=GRAD_CASES) -> None:
    """One of 4 gloo ranks: every case of ``cases`` (3 AdamW steps) and
    every gradient check of ``grad_cases``. Rank 0 writes the results to
    ``out`` (npz) and ``out``.json."""
    from repro_torch.distributed.sharding import MeshLayout
    from repro_torch.launch.mesh import make_mesh
    warnings.simplefilter("ignore", RuntimeWarning)
    z = dict(np.load(inputs))
    arrays, meta = {}, {}
    meshes = {layout: make_mesh(MeshLayout(tm.AXES, layout), "cpu")
              for layout in tm.MESHES}
    for name, layout in cases:
        case = case_name(name, layout)
        losses, norms, params, state, counts = train(z, meshes[layout], name)
        meta[case] = {"loss": losses, "grad_norm": norms,
                      "collectives": counts}
        for key, leaf in tm.paths({"params": params, "opt": state}):
            arrays[f"{case}/{key}"] = leaf.numpy()
    for name, layout in grad_cases:
        for key, g in grads(z, meshes[layout], name).items():
            arrays[f"grad/{case_name(name, layout)}/{key}"] = g
    if rank == 0:
        np.savez(out, **arrays)
        with open(out + ".json", "w") as f:
            json.dump(meta, f)


# ------------------------------------------- the dry run's collectives
def step_stats_rank(rank: int, cells, out: str) -> None:
    """One of 4 gloo ranks on the (2, 2) mesh: one ``make_train_step``
    step of each cell of ``cells`` ((name, config, shape, microbatches),
    remat "full", the dry run's defaults) on real tensors: the params
    drawn from a seeded generator, the batch made from
    ``Model.input_spec_tree`` (zero tokens, unit masks, normal frames and
    patch rows), each the rank's block; the step's collectives by op
    (``distributed.hlo_analysis``) and by kind. Rank 0 writes ``out``
    (json)."""
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.distributed.hlo_analysis import collective_stats
    from repro_torch.distributed.sharding import (
        MeshLayout, local_shard, mesh_context,
    )
    from repro_torch.launch.dryrun import pick_optimizer
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import batch_shardings
    from repro_torch.models import build_model
    from repro_torch.training import (
        OptimizerConfig, make_optimizer, make_train_step,
    )
    warnings.simplefilter("ignore", RuntimeWarning)
    mesh = make_mesh(MeshLayout(tm.AXES, (2, 2)), "cpu")
    res = {}
    for name, c, shape, mb in cells:
        model = build_model(c)
        gen = torch.Generator().manual_seed(0)
        with mesh_context(mesh):
            ps = model.param_shardings(mesh)
            params = model.init(gen, "cpu", mesh)
            opt = make_optimizer(OptimizerConfig(name=pick_optimizer(c)))
            state = opt.init(params, ps)
            bs = batch_shardings(model, shape, mesh)
            batch = {k: local_shard(s.materialize(gen, "cpu"), bs[k].spec,
                                    mesh)
                     for k, s in model.input_spec_tree(shape).items()}
            step = make_train_step(model, opt, remat_policy="full",
                                   microbatches=mb, batch_shardings=bs)
            collectives.reset_counts()
            step(params, state, batch)
            stats = collective_stats()
            res[name] = {"bytes_by_op": stats.bytes_by_op,
                         "count_by_op": stats.count_by_op,
                         "kinds": collectives.counts()}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
