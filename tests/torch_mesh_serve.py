"""Inputs and rank functions of ``tests/test_torch_mesh_serve.py`` and
``tests/test_torch_mesh_serve_moe_ssm.py``: prefill and decode of scaled
configs over a (data, model) ``DeviceMesh`` of gloo ranks on the CPU, on
the rank's blocks of the params, inputs and decode state, under both rule
profiles, and with the MIRAGE remap tiers. This module imports no JAX, so
that the spawned ranks start from torch alone (``JAX_SNIPPET``, the
reference's side, runs in subprocesses); results travel through files."""
from __future__ import annotations

import json
import warnings

import numpy as np

# name -> (arch, layers, config overrides). danube's window is cut to 8
# so that the 16-token prompt wraps its ring and decode keeps wrapping it
MODELS = {
    "llama": ("llama3-8b", 6, {}),
    "danube": ("h2o-danube-3-4b", 2, {"sliding_window": 8}),
    "llava": ("llava-next-34b", 2, {}),
    "whisper": ("whisper-medium", 2, {}),
    "moonshot": ("moonshot-v1-16b-a3b", 2, {}),
    "jamba": ("jamba-v0.1-52b", 8, {}),
    "xlstm": ("xlstm-1.3b", 8, {}),
}
BATCH, PROMPT, STEPS = 4, 16, 4
CONTEXT = 32          # the dense decode cache's length (danube: its ring)
PATCHES = 8           # llava's prefix rows
FRAMES = 32           # whisper's encoder rows (the scaled max_source_len 64)
AXES = ("data", "model")
MESHES = ((2, 2), (4, 1), (1, 4))
RULES = ("train", "serving")
REMAP_TIER = 0.5


def cfg(name: str):
    from repro_torch.configs import ARCHS, scaled_config
    arch, layers, over = MODELS[name]
    return scaled_config(ARCHS[arch], num_layers=layers, **over)


def rules(profile: str):
    from repro_torch.distributed.sharding import DEFAULT_RULES, SERVING_RULES
    return SERVING_RULES if profile == "serving" else DEFAULT_RULES


def case_name(name, layout, profile, batch=BATCH, tier=0.0) -> str:
    tag = f"{name}/{layout[0]}x{layout[1]}_{profile}_b{batch}"
    return tag + (f"_remap{tier:g}" if tier else "")


def cases(names, *, b1=(), remap=(), cross=()):
    """(name, layout, profile, batch, tier, cross-KV remap) of every run:
    each model on every mesh under both profiles at ``BATCH`` rows; the
    models of ``b1`` at one row on (2, 2) (the cache's sequence over
    every axis); the remap tier on (2, 2) for ``remap`` (layers) and
    ``cross`` (whisper's cross K/V), under both profiles."""
    out = [(n, m, r, BATCH, 0.0, False) for n in names for m in MESHES
           for r in RULES]
    out += [(n, (2, 2), r, 1, 0.0, False) for n in b1 for r in RULES]
    out += [(n, (2, 2), r, BATCH, REMAP_TIER, False) for n in remap
            for r in RULES]
    out += [(n, (2, 2), r, BATCH, 0.0, True) for n in cross for r in RULES]
    return out


def run_name(name, layout, profile, batch, tier, cross) -> str:
    return case_name(name, layout, profile, batch, tier) + (
        "_crosskv" if cross else "")


def make_inputs(names, seed: int = 0) -> dict:
    """Each model's prompt inputs and decode tokens at ``BATCH`` rows and
    at one ("{name}/b1/..."), from one numpy generator; the params come
    from the JAX init ("{name}/params/...", added by the test)."""
    rng = np.random.default_rng(seed)
    z = {}
    for name in names:
        c = cfg(name)
        for b, tag in ((BATCH, ""), (1, "b1/")):
            pre = f"{name}/{tag}"
            z[pre + "tokens"] = rng.integers(0, c.vocab_size, (b, PROMPT),
                                             dtype=np.int32)
            z[pre + "decode"] = rng.integers(0, c.vocab_size, (b, STEPS),
                                             dtype=np.int32)
            if c.num_image_patches:
                z[pre + "patch_embeds"] = rng.standard_normal(
                    (b, PATCHES, c.d_model), np.float32)
            if c.is_encoder_decoder:
                z[pre + "frames"] = rng.standard_normal(
                    (b, FRAMES, c.d_model), np.float32)
    return z


def inputs(z: dict, name: str, batch: int) -> dict:
    """The model's prompt batch (numpy) at ``batch`` rows."""
    pre = f"{name}/" + ("b1/" if batch == 1 else "")
    return {k: z[pre + k] for k in ("tokens", "patch_embeds", "frames")
            if pre + k in z}


def decode_tokens(z: dict, name: str, batch: int) -> np.ndarray:
    return z[f"{name}/" + ("b1/" if batch == 1 else "") + "decode"]


def shape(name: str, batch: int):
    """The prefill cell's ``ShapeConfig``: the encoder's rows for an enc-dec
    config, the prefix and tokens for a VLM, the tokens otherwise."""
    from repro_torch.configs.base import ShapeConfig
    c = cfg(name)
    s = FRAMES if c.is_encoder_decoder else PROMPT + (
        PATCHES if c.num_image_patches else 0)
    return ShapeConfig("serve", s, batch, "prefill")


def serve(z: dict, name: str, mesh, profile: str = "train",
          batch: int = BATCH, tier: float = 0.0, cross: bool = False):
    """Prefill of the model's prompt, then ``STEPS`` decode steps on the
    given tokens (teacher-forced), on the rank's blocks of ``mesh`` under
    ``profile``'s rules (one rank where ``mesh`` is None). ``tier``: the
    layers' remap tier (``tier_split`` of the rank's blocks, fetched each
    step); ``cross``: whisper's cross K/V remapped (``cross_kv_to_host``).
    Returns (the logits of prefill and each step, each [batch, V], the
    decode state after the last step, whole; numpy), and the remap
    record."""
    import torch
    from repro_torch.core.transfer_engine import (
        cross_kv_to_host, make_fetch, tier_split,
    )
    from repro_torch.distributed.sharding import (
        gather_full, local_shard, mesh_context,
    )
    from repro_torch.models import build_model
    from repro_torch.models.blocks import rows_axes
    from repro_torch.models.common import tree_leaves, tree_map
    from torch_mesh import _tensors, _unflatten, paths
    model = build_model(cfg(name))
    sh = shape(name, batch)
    full = _unflatten(model.specs(), _tensors(z, f"{name}/params/"))
    rec = {}
    with mesh_context(mesh, rules(profile)), torch.no_grad():
        params = full
        data = {k: torch.from_numpy(np.array(v))
                for k, v in inputs(z, name, batch).items()}
        toks = torch.from_numpy(np.array(decode_tokens(z, name, batch)))
        if mesh is not None:
            ps = model.param_shardings(mesh)
            params = tree_map(lambda x, s: local_shard(x, s.spec, mesh),
                              full, ps)
            bs = model.batch_shardings(sh, mesh)
            data = {k: local_shard(v, bs[k].spec, mesh)
                    for k, v in data.items()}
            toks = local_shard(toks, (rows_axes(mesh, batch),), mesh)
        logits, state = model.prefill(params, data, CONTEXT, shape=sh)
        outs = [logits]
        fetch_args = None
        kw = {}
        if tier:
            plan, res, cyc, maps = tier_split(params["blocks"], tier)
            fetch_args = (res, cyc, maps, plan.beta)
            rec.update(alpha=plan.alpha, m=plan.m, beta=plan.beta,
                       cycle_layers=list(plan.cycle_layers))
        if cross:
            blocks = state["blocks"][0]["mixer"]
            host, kw["cross_transform"] = cross_kv_to_host(blocks["cross"])
            blocks["cross"] = host
            rec["cross_kv_bytes"] = sum(t.numel() * t.element_size()
                                        for t in tree_leaves(host))
        for i in range(STEPS):
            fetch = make_fetch(*fetch_args[:3], slots=fetch_args[3]) \
                if fetch_args else None
            logits, state = model.decode_step(
                params, state, toks[:, i], CONTEXT, fetch=fetch,
                global_batch=batch, **kw)
            outs.append(logits)
        if mesh is not None:
            rows = (rows_axes(mesh, batch),)
            outs = [gather_full(o, rows, mesh) for o in outs]
            st_sh = model.decode_state_shardings(batch, CONTEXT, mesh)
            state = tree_map(lambda x, s: gather_full(x, s.spec, mesh),
                             state, st_sh)
    return ([o.numpy() for o in outs],
            {k: v.numpy() for k, v in paths(state)}, rec)


def serve_rank(rank: int, inputs_path: str, out: str, runs) -> None:
    """One of 4 gloo ranks: every run of ``runs`` (``cases``) on its mesh.
    Rank 0 writes the logits and the whole state to ``out`` (npz) and the
    remap records to ``out``.json."""
    from repro_torch.distributed.sharding import MeshLayout
    from repro_torch.launch.mesh import make_mesh
    warnings.simplefilter("ignore", RuntimeWarning)
    z = dict(np.load(inputs_path))
    arrays, meta = {}, {}
    meshes = {}
    for name, layout, profile, batch, tier, cross in runs:
        layout = tuple(layout)
        if layout not in meshes:
            meshes[layout] = make_mesh(MeshLayout(AXES, layout), "cpu")
        key = run_name(name, layout, profile, batch, tier, cross)
        logits, state, rec = serve(z, name, meshes[layout], profile, batch,
                                   tier, cross)
        for i, lg in enumerate(logits):
            arrays[f"{key}/logits{i}"] = lg
        for k, v in state.items():
            arrays[f"{key}/state/{k}"] = v
        meta[key] = rec
    if rank == 0:
        np.savez(out, **arrays)
        with open(out + ".json", "w") as f:
            json.dump(meta, f)


# the JAX package under the same meshes: one subprocess a model on 4
# forced host devices, ``Model.prefill`` and ``Model.decode_step`` under
# ``jax.jit`` with the params and inputs placed by the reference's rules
JAX_SNIPPET = r"""
import json, sys, warnings
import numpy as np
import jax
from repro.configs import ARCHS, scaled_config
from repro.distributed.sharding import (
    DEFAULT_RULES, SERVING_RULES, mesh_context, sharding_for)
from repro.launch.mesh import make_auto_mesh
from repro.models import build_model
from repro.training.checkpoint import _flatten_with_paths
warnings.simplefilter("ignore")
assert len(jax.devices()) == 4, jax.devices()
z = dict(np.load(sys.argv[1]))
sp = json.loads(sys.argv[3])
out = {}
for key, name, layout, profile, b in sp["runs"]:
    arch, layers, over = sp["models"][name]
    model = build_model(scaled_config(ARCHS[arch], num_layers=layers, **over))
    rules = SERVING_RULES if profile == "serving" else DEFAULT_RULES
    abst = model.abstract_params()
    params = jax.tree.unflatten(jax.tree.structure(abst), [
        z[f"{name}/params/" + k] for k, _ in _flatten_with_paths(abst)])
    pre = f"{name}/" + ("b1/" if b == 1 else "")
    batch = {k: z[pre + k] for k in ("tokens", "patch_embeds", "frames")
             if pre + k in z}
    toks = z[pre + "decode"]
    ctx = sp["context"]
    mesh = make_auto_mesh(tuple(layout), ("data", "model"))
    with mesh_context(mesh, rules):
        params = jax.device_put(params, model.param_shardings(mesh, rules))

        def put(a, logical):
            return jax.device_put(a, sharding_for(logical, a.shape, mesh,
                                                  rules))
        batch = {k: put(v, ("batch",) + (None,) * (v.ndim - 1))
                 for k, v in batch.items()}
        prefill = jax.jit(lambda p, bt: model.prefill(p, bt, ctx))
        step = jax.jit(lambda p, st, t: model.decode_step(p, st, t, ctx))
        logits, state = prefill(params, batch)
        out[f"{key}/logits0"] = np.asarray(logits)
        for i in range(toks.shape[1]):
            logits, state = step(params, state, put(toks[:, i], ("batch",)))
            out[f"{key}/logits{i + 1}"] = np.asarray(logits)
    for k, leaf in _flatten_with_paths(state):
        out[f"{key}/state/{k}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
"""


def run_everything(tmp: str, z: dict, runs, root: str) -> dict:
    """Every run of ``runs`` three ways: JAX under the same mesh (one
    subprocess a model, side by side, remap runs left out: the tiers are
    the port's), the port on 4 gloo ranks (one spawn), and the port on
    one rank (each model and batch once). ``z``: the inputs with the
    params. Returns {"jax": arrays, "mesh": (arrays, records), "one":
    {(name, batch): (logits, state)}}."""
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
    procs = {}
    for name in dict.fromkeys(r[0] for r in runs):
        mine = [[run_name(*r), r[0], list(r[1]), r[2], r[3]] for r in runs
                if r[0] == name and not r[4] and not r[5]]
        spec = json.dumps({"models": MODELS, "context": CONTEXT,
                           "runs": mine})
        out = os.path.join(tmp, f"jax_{name}.npz")
        procs[out] = subprocess.Popen(
            [sys.executable, "-c", JAX_SNIPPET, inputs_path, out, spec],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    try:
        mesh_out = os.path.join(tmp, "mesh.npz")
        spawn_ranks(serve_rank, 4, inputs_path, mesh_out, runs)
        one = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for name, _, _, batch, _, _ in runs:
                if (name, batch) not in one:
                    one[name, batch] = serve(z, name, None, batch=batch)[:2]
    finally:
        logs = {out: proc.communicate(timeout=900)[0]
                for out, proc in procs.items()}
    for out, proc in procs.items():
        assert proc.returncode == 0, logs[out][-3000:]
    jax_arrays = {}
    for out in procs:
        jax_arrays.update(np.load(out))
    with open(mesh_out + ".json") as f:
        meta = json.load(f)
    return {"jax": jax_arrays, "mesh": (dict(np.load(mesh_out)), meta),
            "one": one}


def rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    """The largest difference over the reference's largest magnitude."""
    if not ref.size:
        return 0.0
    ref = ref.astype(np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    return float(np.abs(got.astype(np.float64) - ref).max()) / scale


def same_groups(name: str, layout, batch: int) -> bool:
    """Whether the MoE routes the mesh's tokens in one rank's groups at
    prefill and at decode: no MoE, one data rank, rows no data axis
    splits, or one group of every token (t * k <= 8 E)."""
    c = cfg(name)
    if c.moe is None or layout[0] == 1 or batch == 1:
        return True
    tokens = batch * shape(name, batch).seq_len
    return tokens * c.moe.top_k <= 8 * c.moe.num_experts
