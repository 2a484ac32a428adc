"""Inputs and rank functions of ``tests/test_torch_mesh_train.py`` and
``tests/test_torch_elastic_reshard.py``: mesh training, checkpoints and
resharding of scaled llama3-8b (2 layers, f32) on gloo ranks on the CPU.
This module imports no JAX, so that the spawned ranks start from torch
alone; results travel through files."""
from __future__ import annotations

import contextlib
import io
import json
import warnings

import numpy as np

ARCH, LAYERS = "llama3-8b", 2
BATCH, SEQ, STEPS = 4, 16, 3
# (data, model) meshes of 4 ranks: FSDP x TP, FSDP alone, TP alone (the
# scaled model's 2 KV heads do not split 4 ways: they stay whole and each
# rank takes the one its query head reads)
MESHES = ((2, 2), (4, 1), (1, 4))
OPTIMIZERS = ("adamw", "adafactor")
# AdamW's first steps move a weight by ~lr * g / (|g| + eps): with the
# default eps of 1e-8 a gradient entry near 1e-8 turns a last-bit
# difference in the gradient's partial sums into ~1e-4 of lr, so the
# comparisons take eps = 1e-3, as test_torch_training's step comparison.
# Adafactor's unfactored update g / sqrt(v) is as sensitive (no eps at
# all), so every leaf with two dims of 2 or more is factored here: that
# also puts the row and column means over the dims TP splits (the heads)
OPT_KW = {"adamw": dict(learning_rate=1e-2, warmup_steps=2, eps=1e-3),
          "adafactor": dict(learning_rate=1e-2, warmup_steps=2,
                            min_dim_size_to_factor=2)}
AXES = ("data", "model")


def cfg():
    from repro_torch.configs import ARCHS, scaled_config
    return scaled_config(ARCHS[ARCH], num_layers=LAYERS)


def case_name(layout, opt: str) -> str:
    return f"{layout[0]}x{layout[1]}_{opt}"


def paths(tree, prefix: str = ""):
    """(key path, leaf) in the checkpoint layout's order."""
    from repro_torch.training.checkpoint import _paths
    return _paths(tree, prefix)


def make_batches(seed: int = 0, vocab: int = 0, batch: int = BATCH,
                 seq: int = SEQ, prefix: str = "") -> dict:
    """STEPS global batches (tokens, targets, a mask with a few zeros),
    keyed "{prefix}batch{i}/{name}", from one numpy generator (``vocab``:
    the config's by default)."""
    rng = np.random.default_rng(seed)
    vocab = vocab or cfg().vocab_size
    z = {}
    for i in range(STEPS):
        toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
        mask = np.ones((batch, seq), np.float32)
        mask[:, :i + 1] = 0.0
        z[f"{prefix}batch{i}/tokens"] = toks[:, :-1].copy()
        z[f"{prefix}batch{i}/targets"] = toks[:, 1:].copy()
        z[f"{prefix}batch{i}/mask"] = mask
    return z


def _tensors(z: dict, prefix: str):
    import torch
    return {k[len(prefix):]: torch.from_numpy(np.array(v))
            for k, v in z.items() if k.startswith(prefix)}


def _unflatten(like, flat: dict):
    from repro_torch.training.checkpoint import _map_paths
    return _map_paths(lambda key, _: flat[key], like)


def train(z: dict, mesh, opt_name: str, model_cfg=None, batch: int = BATCH,
          seq: int = SEQ, prefix: str = ""):
    """STEPS steps of ``make_train_step`` from the params
    "{prefix}params/..." of ``z`` on the batches "{prefix}batch{i}/..." of
    ``make_batches`` (the rank's blocks of both on ``mesh``; one rank where
    it is None), of ``model_cfg`` (default: ``cfg()``). Returns (losses,
    grad norms, the params and the optimizer state gathered whole, the
    collectives' byte counts of the last step)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import (
        gather_full, local_shard, mesh_context,
    )
    from repro_torch.launch.shardings import batch_shardings, opt_shardings
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.training import (
        OptimizerConfig, make_optimizer, make_train_step,
    )
    model = build_model(model_cfg or cfg())
    shape = ShapeConfig("t", seq, batch, "train")
    full = _unflatten(model.specs(), _tensors(z, prefix + "params/"))
    opt = make_optimizer(OptimizerConfig(name=opt_name, **OPT_KW[opt_name]))
    losses, norms = [], []
    with mesh_context(mesh):
        ps = bs = None
        params = full
        if mesh is not None:
            ps = model.param_shardings(mesh)
            bs = batch_shardings(model, shape, mesh)
            params = tree_map(lambda x, sh: local_shard(x, sh.spec, mesh),
                              full, ps)
        state = opt.init(params, ps)
        step = make_train_step(model, opt, remat_policy="dots_saveable")
        for i in range(STEPS):
            b = _tensors(z, f"{prefix}batch{i}/")
            if bs is not None:
                b = {k: local_shard(v, bs[k].spec, mesh)
                     for k, v in b.items()}
            collectives.reset_counts()
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        counts = collectives.counts()
        if mesh is not None:
            tree = {"params": params, "opt": state}
            sh = {"params": ps, "opt": opt_shardings(state, ps, mesh)}
            params, state = (tree_map(
                lambda x, s: gather_full(x, s.spec, mesh), tree[k], sh[k])
                for k in ("params", "opt"))
    return losses, norms, params, state, counts


def train_rank(rank: int, inputs: str, out: str) -> None:
    """One of 4 gloo ranks: every (mesh, optimizer) case of ``train``, and
    ``Model.init(mesh=)`` against the rank's block of one rank's init.
    Rank 0 writes the results to ``out`` (npz) and ``out``.json."""
    import torch
    from repro_torch.distributed.sharding import MeshLayout, local_shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    warnings.simplefilter("ignore", RuntimeWarning)
    z = dict(np.load(inputs))
    arrays, meta = {}, {}
    for layout in MESHES:
        mesh = make_mesh(MeshLayout(AXES, layout), "cpu")
        for opt_name in OPTIMIZERS:
            name = case_name(layout, opt_name)
            losses, norms, params, state, counts = train(z, mesh, opt_name)
            meta[name] = {"loss": losses, "grad_norm": norms,
                          "collectives": counts}
            for key, leaf in paths({"params": params, "opt": state}):
                arrays[f"{name}/{key}"] = leaf.numpy()
        model = build_model(cfg())
        sharded = model.init(torch.Generator().manual_seed(1), "cpu", mesh)
        whole = model.init(torch.Generator().manual_seed(1), "cpu")
        meta[f"init_{layout[0]}x{layout[1]}"] = all(
            torch.equal(a, local_shard(b, sh.spec, mesh)) for a, b, sh in zip(
                tree_leaves(sharded), tree_leaves(whole),
                tree_leaves(model.param_shardings(mesh))))
    if rank == 0:
        np.savez(out, **arrays)
        with open(out + ".json", "w") as f:
            json.dump(meta, f)


# ------------------------------------------------------- moving the state
def elastic_rank(rank: int, ckpt_dir: str, out: str) -> None:
    """One of 4 gloo ranks: init on (2, 2) and save from the mesh (the
    test holds the files to a one-rank save); ``elastic_reshard`` to (4,
    1) and back, each against the rank's block of the one-rank init; one
    Adafactor step on (2, 2), saved, restored onto (4, 1) under
    ``opt_shardings`` and held to the live state resharded; then the
    launcher on the world's host mesh, stopped and resumed from its
    checkpoint. Each rank writes ``out`` % rank (json)."""
    import torch
    from repro_torch.distributed import elastic_reshard
    from repro_torch.distributed.sharding import (
        MeshLayout, local_shard, mesh_context,
    )
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import opt_shardings
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import (
        OptimizerConfig, checkpoint, make_optimizer, make_train_step,
    )
    warnings.simplefilter("ignore", RuntimeWarning)
    model = build_model(cfg())
    res = {}
    m22 = make_mesh(MeshLayout(AXES, (2, 2)), "cpu")
    m41 = make_mesh(MeshLayout(AXES, (4, 1)), "cpu")
    whole = model.init(torch.Generator().manual_seed(0), "cpu")
    params = model.init(torch.Generator().manual_seed(0), "cpu", m22)
    s22, s41 = model.param_shardings(m22), model.param_shardings(m41)
    opt = make_optimizer(OptimizerConfig(name="adamw"))
    state = opt.init(params, s22)
    checkpoint.save(ckpt_dir + "/adamw", 0, {"params": params, "opt": state},
                    shardings={"params": s22,
                               "opt": opt_shardings(state, s22, m22)})

    def diff(tree, shardings):
        """The largest difference of the rank's blocks from the one-rank
        init's blocks under ``shardings``."""
        return max(float((a - local_shard(b, s.spec, s.mesh)).abs().max())
                   for a, b, s in zip(tree_leaves(tree), tree_leaves(whole),
                                      tree_leaves(shardings)))
    moved = elastic_reshard(params, s22, s41)
    res["reshard_41"] = diff(moved, s41)
    res["shapes_41"] = [list(x.shape) for x in tree_leaves(moved)][:3]
    res["reshard_back"] = diff(elastic_reshard(moved, s41, s22), s22)
    # scaled moonshot (MoE) saved from (2, 2): the test holds the files to
    # a one-rank save of the same init
    moe = build_model(moe_cfg())
    mp = moe.init(torch.Generator().manual_seed(0), "cpu", m22)
    ms = moe.param_shardings(m22)
    mst = opt.init(mp, ms)
    checkpoint.save(ckpt_dir + "/moe", 0, {"params": mp, "opt": mst},
                    shardings={"params": ms,
                               "opt": opt_shardings(mst, ms, m22)})
    # Adafactor: one step on (2, 2), then its factored statistics moved
    ada = make_optimizer(OptimizerConfig(name="adafactor",
                                         **OPT_KW["adafactor"]))
    with mesh_context(m22):
        st = ada.init(params, s22)
        step = make_train_step(model, ada, remat_policy="none")
        rows = slice(rank // 2 * 2, rank // 2 * 2 + 2)      # data index
        gen = torch.Generator().manual_seed(3)
        toks = torch.randint(0, cfg().vocab_size, (BATCH, SEQ + 1),
                             generator=gen, dtype=torch.int32)
        batch = {"tokens": toks[rows, :-1], "targets": toks[rows, 1:],
                 "mask": torch.ones(2, SEQ)}
        params, st, _ = step(params, st, batch)
    o22, o41 = opt_shardings(st, s22, m22), opt_shardings(st, s41, m41)
    checkpoint.save(ckpt_dir + "/ada", 1, {"params": params, "opt": st},
                    shardings={"params": s22, "opt": o22})
    like = {"params": elastic_reshard(params, s22, s41),
            "opt": elastic_reshard(st, o22, o41)}
    got, _ = checkpoint.restore(ckpt_dir + "/ada", 1, like,
                                shardings={"params": s41, "opt": o41})
    res["restore_ada_41"] = max(
        float((a - b).abs().max()) for a, b in zip(tree_leaves(got),
                                                   tree_leaves(like)))
    vr = got["opt"]["v"]["embed"]["vr"]
    res["ada_embed_vr"] = [list(vr.shape),
                           list(o41["v"]["embed"]["vr"].spec)]
    res["ada_wq"] = {k: [list(v.shape), list(o22["v"]["blocks"][0]["mixer"]
                                             ["wq"][k].spec)]
                     for k, v in st["v"]["blocks"][0]["mixer"]["wq"].items()}
    # the launcher on the world's host mesh: 2 steps, then resumed to 4
    argv = ["--device", "cpu", "--mesh", "host", "--scaled", "--layers",
            "2", "--batch", "4", "--seq", "16", "--ckpt-dir",
            ckpt_dir + "/cli", "--ckpt-every", "2"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_train.main(argv + ["--steps", "2"])
        launch_train.main(argv + ["--steps", "4"])
    res["cli_out"] = buf.getvalue()
    with open(out % rank, "w") as f:
        json.dump(res, f)


def moe_cfg():
    from repro_torch.configs import ARCHS, scaled_config
    return scaled_config(ARCHS["moonshot-v1-16b-a3b"], num_layers=2)


def restore_rank(rank: int, ckpt_dir: str, out: str) -> None:
    """One of 2 gloo ranks: the (2, 2) world's checkpoints (scaled llama
    and scaled moonshot) restored onto ``host_layout(2)``, each block
    against the rank's block of the one-rank init."""
    import torch
    from repro_torch.launch.mesh import host_layout, make_mesh
    from repro_torch.launch.shardings import opt_shardings
    from repro_torch.distributed.sharding import local_shard
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import (
        OptimizerConfig, checkpoint, make_optimizer,
    )
    warnings.simplefilter("ignore", RuntimeWarning)
    layout = host_layout(2)
    mesh = make_mesh(layout, "cpu")
    opt = make_optimizer(OptimizerConfig(name="adamw"))
    res = {"layout": list(layout.sizes)}
    for tag, c, sub in (("", cfg(), "/adamw"), ("moe_", moe_cfg(), "/moe")):
        model = build_model(c)
        ps = model.param_shardings(mesh)
        whole = model.init(torch.Generator().manual_seed(0), "cpu")
        like = model.init(torch.Generator().manual_seed(9), "cpu", mesh)
        st = opt.init(like, ps)
        tree, _ = checkpoint.restore(
            ckpt_dir + sub, 0, {"params": like, "opt": st},
            shardings={"params": ps, "opt": opt_shardings(st, ps, mesh)})
        res[tag + "params"] = max(
            float((a - local_shard(b, s.spec, mesh)).abs().max())
            for a, b, s in zip(tree_leaves(tree["params"]),
                               tree_leaves(whole), tree_leaves(ps)))
        res[tag + "opt"] = max(float(x.abs().max())
                               for x in tree_leaves(tree["opt"]))
        res[tag + "blocks"] = [list(x.shape)
                               for x in tree_leaves(tree["params"])]
    with open(out % rank, "w") as f:
        json.dump(res, f)


def expert_move_rank(rank: int, out: str) -> None:
    """One of 2 gloo ranks: scaled moonshot's params initialised on (2, 1),
    moved to (1, 2) and back with ``elastic_reshard``; the largest
    difference of each move's blocks from the rank's blocks of one rank's
    init, and the first expert leaf's block shapes, to ``out`` % rank."""
    import torch
    from repro_torch.configs import ARCHS, scaled_config
    from repro_torch.distributed import elastic_reshard
    from repro_torch.distributed.sharding import MeshLayout, local_shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    warnings.simplefilter("ignore", RuntimeWarning)
    model = build_model(scaled_config(ARCHS["moonshot-v1-16b-a3b"],
                                      num_layers=2))
    m21 = make_mesh(MeshLayout(AXES, (2, 1)), "cpu")
    m12 = make_mesh(MeshLayout(AXES, (1, 2)), "cpu")
    s21, s12 = model.param_shardings(m21), model.param_shardings(m12)
    whole = model.init(torch.Generator().manual_seed(0), "cpu")
    params = model.init(torch.Generator().manual_seed(0), "cpu", m21)

    def diff(tree, shardings):
        return max(float((a - local_shard(b, s.spec, s.mesh)).abs().max())
                   for a, b, s in zip(tree_leaves(tree), tree_leaves(whole),
                                      tree_leaves(shardings)))
    moved = elastic_reshard(params, s21, s12)
    back = elastic_reshard(moved, s12, s21)
    res = {"to_model": diff(moved, s12), "back": diff(back, s21),
           "shapes": [list(params["blocks"][0]["ffn"]["w_in"].shape),
                      list(moved["blocks"][0]["ffn"]["w_in"].shape)]}
    with open(out % rank, "w") as f:
        json.dump(res, f)
