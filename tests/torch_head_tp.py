"""Inputs and rank functions of ``tests/test_torch_head_tp.py``: serving
(prefill, greedy decode) and the training loss's gradients of scaled llama
and xlstm under the dry run's ``head-tp`` rules (head_dim over "model", the
heads whole) on (data, model) meshes of gloo ranks on the CPU. This module
imports no JAX, so that the spawned ranks start from torch alone
(``JAX_SNIPPET``, the reference's side, runs in a subprocess); results
travel through files."""
from __future__ import annotations

import warnings

import numpy as np

# name -> (arch, layers): llama's scaled 2 KV heads split over model 2 on
# (2, 2) and fall back to a head_dim split on (1, 4), llama3-8b's case at
# model 16; xlstm at 8 layers holds its sLSTM (layer 7, slstm_period 8)
MODELS = {"llama": ("llama3-8b", 2), "xlstm": ("xlstm-1.3b", 8)}
MESHES = ((2, 2), (1, 4))
AXES = ("data", "model")
BATCH, PROMPT, STEPS, CONTEXT = 4, 16, 4, 32
SEQ = 16              # the train batch's tokens a row


def cfg(name: str):
    from repro_torch.configs import ARCHS, scaled_config
    arch, layers = MODELS[name]
    return scaled_config(ARCHS[arch], num_layers=layers)


def rules():
    from repro_torch.launch.dryrun import profile_rules
    return profile_rules("head-tp")


def make_inputs(seed: int = 0) -> dict:
    """Each model's prompt "{name}/tokens" [BATCH, PROMPT] and train batch
    "{name}/train/..." (tokens, targets, a mask with a few zeros), from one
    numpy generator; the params come from the JAX init
    ("{name}/params/...", added by the test)."""
    rng = np.random.default_rng(seed)
    z = {}
    for name in MODELS:
        v = cfg(name).vocab_size
        z[f"{name}/tokens"] = rng.integers(0, v, (BATCH, PROMPT),
                                           dtype=np.int32)
        toks = rng.integers(0, v, (BATCH, SEQ + 1), dtype=np.int32)
        mask = np.ones((BATCH, SEQ), np.float32)
        mask[:, :2] = 0.0
        z[f"{name}/train/tokens"] = toks[:, :-1].copy()
        z[f"{name}/train/targets"] = toks[:, 1:].copy()
        z[f"{name}/train/mask"] = mask
    return z


def run(z: dict, name: str, mesh) -> dict:
    """On the rank's blocks of ``mesh`` under the head-tp rules (one rank
    where it is None): the prefill's logits, ``STEPS`` greedy decode steps
    (logits and tokens), the decode state after them, whole; the loss of
    the train batch and every parameter's gradient, summed over the data
    axes its leaf is not split on and gathered whole. Numpy, keyed as the
    JAX side keys them."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.collectives import sum_over
    from repro_torch.distributed.sharding import (
        batch_axis_names, gather_full, local_shard, mesh_context,
    )
    from repro_torch.models import build_model
    from repro_torch.models.blocks import rows_axes
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.training.train_step import _unflatten
    from torch_mesh import _tensors, paths
    from torch_mesh import _unflatten as _by_paths
    model = build_model(cfg(name))
    full = _by_paths(model.specs(), _tensors(z, f"{name}/params/"))
    out = {}
    with mesh_context(mesh, rules()):
        params, ps = full, None
        toks = torch.from_numpy(np.array(z[f"{name}/tokens"]))
        batch = _tensors(z, f"{name}/train/")
        sh = ShapeConfig("serve", PROMPT, BATCH, "prefill")
        rows = ()
        if mesh is not None:
            ps = model.param_shardings(mesh)
            params = tree_map(lambda x, s: local_shard(x, s.spec, mesh),
                              full, ps)
            rows = (rows_axes(mesh, BATCH),)
            toks = local_shard(toks, rows, mesh)
            batch = {k: local_shard(v, rows, mesh) for k, v in batch.items()}

        def whole(t):
            return gather_full(t, rows, mesh) if rows else t

        with torch.no_grad():
            logits, state = model.prefill(params, {"tokens": toks}, CONTEXT,
                                          shape=sh)
            out["logits0"] = whole(logits)
            for i in range(STEPS):
                tok = logits.argmax(-1).to(torch.int32)
                out[f"tokens{i}"] = whole(tok)
                logits, state = model.decode_step(params, state, tok,
                                                  CONTEXT,
                                                  global_batch=BATCH)
                out[f"logits{i + 1}"] = whole(logits)
            if mesh is not None:
                st = model.decode_state_shardings(BATCH, CONTEXT, mesh)
                state = tree_map(lambda x, s: gather_full(x, s.spec, mesh),
                                 state, st)
            for k, v in paths(state):
                out[f"state/{k}"] = v
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = model.train_loss(_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        out["loss"] = loss.detach()
        if mesh is not None:
            data = batch_axis_names(mesh)
            grads = [gather_full(sum_over(
                g, mesh, [ax for ax in data if ax not in s.split_axes()],
                "test"), s.spec, mesh)
                for g, s in zip(grads, tree_leaves(ps))]
        for k, g in paths(_unflatten(params, grads)):
            out[f"grad/{k}"] = g
    return {k: v.detach().numpy() for k, v in out.items()}


def case_name(name: str, layout) -> str:
    return f"{name}/{layout[0]}x{layout[1]}"


# jamba's Mamba mixer: under head-tp its channels ("ssm_inner") split over
# "model" while its per-head leaves ("heads") stay whole
MAMBA_ARCH = "jamba-v0.1-52b"


def mamba_inputs(seed: int = 1) -> dict:
    """The scaled jamba Mamba mixer's leaves "mamba/p/...", its input x
    and an output gradient dy [BATCH, SEQ, D], from one numpy generator."""
    from repro_torch.configs import ARCHS, scaled_config
    from repro_torch.models.blocks import Mamba
    c = scaled_config(ARCHS[MAMBA_ARCH])
    rng = np.random.default_rng(seed)
    z = {f"mamba/p/{n}": (0.1 * rng.standard_normal(s.shape)).astype(
        np.float32) for n, s in Mamba().specs(c).items()}
    for n in ("x", "dy"):
        z[f"mamba/{n}"] = rng.standard_normal(
            (BATCH, SEQ, c.d_model)).astype(np.float32)
    return z


def mamba_block(z: dict, mesh) -> dict:
    """The Mamba mixer's ``fwd_seq`` on the rank's rows and blocks under
    the head-tp rules (one rank where ``mesh`` is None): its output and,
    under ``dy``, every leaf's gradient, summed over the data axes its leaf
    is not split on and gathered whole (numpy)."""
    import torch
    from repro_torch.configs import ARCHS, scaled_config
    from repro_torch.distributed.collectives import sum_over
    from repro_torch.distributed.sharding import (
        NamedSharding, batch_axis_names, gather_full, local_shard,
        mesh_context, spec_for,
    )
    from repro_torch.models.blocks import Mamba, rows_axes
    c = scaled_config(ARCHS[MAMBA_ARCH])
    block = Mamba()
    x, dy = (torch.from_numpy(z[f"mamba/{n}"]) for n in ("x", "dy"))
    p = {n: torch.from_numpy(z[f"mamba/p/{n}"]) for n in block.specs(c)}
    with mesh_context(mesh, rules()):
        if mesh is not None:
            sp = {n: spec_for(s.logical, s.shape, mesh, rules())
                  for n, s in block.specs(c).items()}
            rows = (rows_axes(mesh, BATCH),)
            p = {n: local_shard(t, sp[n], mesh) for n, t in p.items()}
            x, dy = (local_shard(t, rows, mesh) for t in (x, dy))
        p = {n: t.requires_grad_() for n, t in p.items()}
        y, _ = block.fwd_seq(p, x, {"mesh": mesh}, c)
        grads = dict(zip(p, torch.autograd.grad((y * dy).sum(),
                                                list(p.values()))))
        y = y.detach()
        if mesh is not None:
            y = gather_full(y, rows, mesh)
            for n, g in grads.items():
                split = NamedSharding(mesh, sp[n]).split_axes()
                grads[n] = gather_full(sum_over(
                    g, mesh, [ax for ax in batch_axis_names(mesh)
                              if ax not in split], "test"), sp[n], mesh)
    out = {"y": y.numpy()}
    out.update({f"grad/{n}": g.numpy() for n, g in grads.items()})
    return out


def rank_fn(rank: int, inputs_path: str, out: str) -> None:
    """One of 4 gloo ranks: every model on every mesh of ``MESHES``. Rank 0
    writes the results to ``out`` (npz)."""
    from repro_torch.distributed.sharding import MeshLayout
    from repro_torch.launch.mesh import make_mesh
    warnings.simplefilter("ignore", RuntimeWarning)
    z = dict(np.load(inputs_path))
    arrays = {}
    for layout in MESHES:
        mesh = make_mesh(MeshLayout(AXES, layout), "cpu")
        for name in MODELS:
            for k, v in run(z, name, mesh).items():
                arrays[f"{case_name(name, layout)}/{k}"] = v
        for k, v in mamba_block(z, mesh).items():
            arrays[f"{case_name('mamba', layout)}/{k}"] = v
    if rank == 0:
        np.savez(out, **arrays)


# the JAX package under the same meshes and the reference's head-tp rules
# (``repro.launch.dryrun``'s), on 4 forced host devices: prefill and greedy
# decode under ``jax.jit``, and ``jax.value_and_grad`` of ``train_loss``
JAX_SNIPPET = r"""
import json, sys, warnings
import numpy as np
import jax
import jax.numpy as jnp
from repro.configs import ARCHS, scaled_config
from repro.distributed.sharding import (
    ShardingRules, mesh_context, sharding_for)
from repro.launch.mesh import make_auto_mesh
from repro.models import build_model
from repro.training.checkpoint import _flatten_with_paths
warnings.simplefilter("ignore")
assert len(jax.devices()) == 4, jax.devices()
z = dict(np.load(sys.argv[1]))
sp = json.loads(sys.argv[3])
rules = ShardingRules.make(profile="serving", head_dim=("model",), heads=())
out = {}
for layout in sp["meshes"]:
    mesh = make_auto_mesh(tuple(layout), ("data", "model"))
    for name, (arch, layers) in sp["models"].items():
        key = f"{name}/{layout[0]}x{layout[1]}"
        model = build_model(scaled_config(ARCHS[arch], num_layers=layers))
        abst = model.abstract_params()
        params = jax.tree.unflatten(jax.tree.structure(abst), [
            z[f"{name}/params/" + k] for k, _ in _flatten_with_paths(abst)])
        ctx = sp["context"]
        with mesh_context(mesh, rules):
            params = jax.device_put(params, model.param_shardings(mesh, rules))

            def put(a, logical):
                return jax.device_put(a, sharding_for(logical, a.shape, mesh,
                                                      rules))
            rows = lambda a: put(a, ("batch",) + (None,) * (a.ndim - 1))
            prefill = jax.jit(lambda p, bt: model.prefill(p, bt, ctx))
            step = jax.jit(lambda p, st, t: model.decode_step(p, st, t, ctx))
            logits, state = prefill(params,
                                    {"tokens": rows(z[f"{name}/tokens"])})
            out[f"{key}/logits0"] = np.asarray(logits)
            for i in range(sp["steps"]):
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                out[f"{key}/tokens{i}"] = np.asarray(tok)
                logits, state = step(params, state, rows(np.asarray(tok)))
                out[f"{key}/logits{i + 1}"] = np.asarray(logits)
            for k, leaf in _flatten_with_paths(state):
                out[f"{key}/state/{k}"] = np.asarray(leaf)
            batch = {k: rows(z[f"{name}/train/{k}"])
                     for k in ("tokens", "targets", "mask")}
            loss, grads = jax.jit(jax.value_and_grad(model.train_loss))(
                params, batch)
            out[f"{key}/loss"] = np.asarray(loss)
            for k, g in _flatten_with_paths(grads):
                out[f"{key}/grad/{k}"] = np.asarray(g)
np.savez(sys.argv[2], **out)
"""


def run_everything(tmp: str, z: dict, root: str) -> dict:
    """The cases three ways: JAX under the same meshes (one subprocess,
    started first), the port on 4 gloo ranks (one spawn) and the port on
    one rank (each model once). Returns {"jax": arrays, "mesh": arrays,
    "one": {name: arrays}}."""
    import json
    import os
    import subprocess
    import sys
    from repro_torch.launch.mesh import spawn_ranks
    inputs_path = os.path.join(tmp, "inputs.npz")
    np.savez(inputs_path, **z)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(root, "src"),
                                           os.environ.get("PYTHONPATH",
                                                          "")]))
    jax_out = os.path.join(tmp, "jax.npz")
    spec = json.dumps({"models": MODELS, "meshes": MESHES, "steps": STEPS,
                       "context": CONTEXT})
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SNIPPET, inputs_path, jax_out, spec],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        mesh_out = os.path.join(tmp, "mesh.npz")
        spawn_ranks(rank_fn, 4, inputs_path, mesh_out)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            one = {name: run(z, name, None) for name in MODELS}
            one["mamba"] = mamba_block(z, None)
    finally:
        log = proc.communicate(timeout=900)[0]
    assert proc.returncode == 0, log[-3000:]
    return {"jax": dict(np.load(jax_out)), "mesh": dict(np.load(mesh_out)),
            "one": one}
