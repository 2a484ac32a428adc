"""The port's training over a (data, model) ``DeviceMesh`` of 4 gloo ranks
on the CPU against the JAX package's under the same mesh, and against the
port's own training on one rank.

Scaled llama3-8b (2 layers, f32) takes 3 steps of AdamW and 3 of Adafactor
(``make_train_step``, ``dots_saveable``) on meshes (2, 2) (FSDP x TP), (4,
1) (FSDP alone) and (1, 4) (TP alone; the 2 KV heads stay whole under the
divisibility fallback and each rank takes the one its query head reads),
from the JAX package's init and seeded numpy batches. One spawn runs every
case (``launch.mesh.spawn_ranks``, rank functions in
``tests/torch_mesh.py``); one JAX subprocess, which alone sets
``XLA_FLAGS`` for its 4 host devices, runs the same steps under
``jax.jit`` with the params and batches placed by ``param_shardings`` and
``batch_shardings`` on ``make_auto_mesh`` of each shape. Tensor
parallelism splits the contractions into partial sums: each step's loss
and grad norm agree within 1e-5 relative (the worst measured, over all six
cases and both references, was 1.4e-7) and every leaf of the params and
the optimizer state after step 3 within 2e-5 of the leaf's largest
magnitude (the worst measured 2.4e-6). AdamW runs with eps 1e-3 and
Adafactor factors every leaf of two dims (``tests/torch_mesh.py`` says
why)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
import torch_mesh as tm  # noqa: E402

from repro.configs import ARCHS, scaled_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.training.checkpoint import _flatten_with_paths  # noqa: E402

from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models.blocks import _kv_heads_read  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL_SCALAR = 1e-5
TOL_LEAF = 2e-5
CASES = [(layout, opt) for layout in tm.MESHES for opt in tm.OPTIMIZERS]

JAX_SNIPPET = r"""
import json, sys, warnings
import numpy as np
import jax
from repro.configs import ARCHS, scaled_config
from repro.configs.base import ShapeConfig
from repro.distributed.sharding import DEFAULT_RULES, mesh_context
from repro.launch.mesh import make_auto_mesh
from repro.launch.shardings import batch_shardings
from repro.models import build_model
from repro.training import make_optimizer, make_train_step
from repro.training.checkpoint import _flatten_with_paths
from repro.training.optimizer import OptimizerConfig
warnings.simplefilter("ignore")
assert len(jax.devices()) == 4, jax.devices()
z = dict(np.load(sys.argv[1]))
sp = json.loads(sys.argv[3])
model = build_model(scaled_config(ARCHS[sp["arch"]],
                                  num_layers=sp["layers"]))
shape = ShapeConfig("t", sp["seq"], sp["batch"], "train")
abst = model.abstract_params()
params0 = jax.tree.unflatten(jax.tree.structure(abst), [
    z["params/" + k] for k, _ in _flatten_with_paths(abst)])
out, meta = {}, {}
for layout in sp["meshes"]:
    mesh = make_auto_mesh(tuple(layout), ("data", "model"))
    for opt_name in sp["optimizers"]:
        name = f"{layout[0]}x{layout[1]}_{opt_name}"
        with mesh_context(mesh, DEFAULT_RULES):
            params = jax.device_put(
                params0, model.param_shardings(mesh, DEFAULT_RULES))
            opt = make_optimizer(OptimizerConfig(name=opt_name,
                                                 **sp["opt_kw"][opt_name]))
            state = opt.init(params)
            step = jax.jit(make_train_step(model, opt,
                                           remat_policy="dots_saveable"))
            bs = batch_shardings(model, shape, mesh, DEFAULT_RULES)
            losses, norms = [], []
            for i in range(sp["steps"]):
                batch = jax.device_put(
                    {k: z[f"batch{i}/{k}"] for k in bs}, bs)
                params, state, m = step(params, state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        meta[name] = {"loss": losses, "grad_norm": norms}
        for key, leaf in _flatten_with_paths({"params": params,
                                              "opt": state}):
            out[f"{name}/{key}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
with open(sys.argv[2] + ".json", "w") as f:
    json.dump(meta, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": (arrays, meta), "mesh": (arrays, meta), "one": {case:
    (losses, norms, leaves by key)}}: the JAX subprocess started first and
    run beside the spawn; the port's one-rank runs after."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    jm = jax_build(scaled_config(ARCHS[tm.ARCH], num_layers=tm.LAYERS))
    jp = jm.init(jax.random.PRNGKey(0))
    z = {f"params/{k}": np.asarray(v) for k, v in _flatten_with_paths(jp)}
    z.update(tm.make_batches(0))
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **z)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    spec = json.dumps({"arch": tm.ARCH, "layers": tm.LAYERS,
                       "seq": tm.SEQ, "batch": tm.BATCH, "steps": tm.STEPS,
                       "meshes": tm.MESHES, "optimizers": tm.OPTIMIZERS,
                       "opt_kw": tm.OPT_KW})
    jax_out = str(tmp / "jax.npz")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SNIPPET, inputs, jax_out, spec],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        mesh_out = str(tmp / "mesh")
        spawn_ranks(tm.train_rank, 4, inputs, mesh_out)
        one = {}
        for opt in tm.OPTIMIZERS:
            losses, norms, params, state, _ = tm.train(z, None, opt)
            one[opt] = (losses, norms, {
                k: v.numpy() for k, v in tm.paths({"params": params,
                                                    "opt": state})})
    finally:
        log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-3000:]

    def load(path):
        with open(path + ".json") as f:
            return dict(np.load(path if path.endswith(".npz")
                                else path + ".npz")), json.load(f)
    return {"jax": load(jax_out), "mesh": load(mesh_out), "one": one,
            "inputs": z}


def _leaves_close(got: dict, ref: dict, tol: float):
    """Every leaf of ``ref`` (key -> array) in ``got`` within tol of the
    leaf's largest magnitude; returns the worst relative error."""
    assert set(got) == set(ref), set(got) ^ set(ref)
    worst = 0.0
    for key, r in ref.items():
        r = r.astype(np.float64)
        scale = max(np.abs(r).max(), 1e-30) if r.size else 1.0
        err = float(np.abs(got[key].astype(np.float64) - r).max()) / scale \
            if r.size else 0.0
        assert err <= tol, (key, err)
        worst = max(worst, err)
    return worst


def _case_leaves(arrays: dict, name: str) -> dict:
    return {k[len(name) + 1:]: v for k, v in arrays.items()
            if k.startswith(name + "/")}


@pytest.mark.parametrize("layout,opt", CASES,
                         ids=[tm.case_name(*c) for c in CASES])
def test_mesh_training_matches_jax_under_the_same_mesh(runs, layout, opt):
    name = tm.case_name(layout, opt)
    (ja, jmeta), (ma, mmeta) = runs["jax"], runs["mesh"]
    for key in ("loss", "grad_norm"):
        for got, ref in zip(mmeta[name][key], jmeta[name][key]):
            assert np.isfinite(got) and \
                abs(got - ref) <= TOL_SCALAR * abs(ref), (key, got, ref)
    _leaves_close(_case_leaves(ma, name), _case_leaves(ja, name), TOL_LEAF)
    # every weight moved from its init
    z = runs["inputs"]
    for key, v in _case_leaves(ma, name).items():
        if key.startswith("params/"):
            assert not np.array_equal(v, z[key]), key


@pytest.mark.parametrize("layout,opt", CASES,
                         ids=[tm.case_name(*c) for c in CASES])
def test_mesh_training_matches_one_rank(runs, layout, opt):
    name = tm.case_name(layout, opt)
    losses, norms, leaves = runs["one"][opt]
    meta = runs["mesh"][1][name]
    for got, ref in zip(meta["loss"] + meta["grad_norm"], losses + norms):
        assert abs(got - ref) <= TOL_SCALAR * abs(ref), (got, ref)
    _leaves_close(_case_leaves(runs["mesh"][0], name), leaves, TOL_LEAF)


@pytest.mark.parametrize("layout", tm.MESHES,
                         ids=[f"{a}x{b}" for a, b in tm.MESHES])
def test_init_on_a_mesh_keeps_the_blocks_of_one_rank_init(runs, layout):
    assert runs["mesh"][1][f"init_{layout[0]}x{layout[1]}"] is True


def test_collectives_of_a_step_by_kind(runs):
    """The bytes through each kind of collective in step 3 on (2, 2): the
    FSDP gathers forward and again in the recompute, their reduce-scatter
    backward, the TP all-reduces, the vocab-parallel cross-entropy's
    terms, the replicated leaves' gradient sums; none on the TP-free (4,
    1) mesh's model axis."""
    c22 = runs["mesh"][1]["2x2_adamw"]["collectives"]
    assert {"fsdp_all_gather", "fsdp_reduce_scatter", "tp_all_reduce",
            "ce_all_reduce", "loss_all_reduce", "grad_all_reduce",
            "norm_all_reduce"} <= set(c22)
    # each weight is gathered once forward and once in its recompute, and
    # its gradient reduce-scattered once
    fwd = c22["fsdp_all_gather"]["bytes"]
    assert fwd >= c22["fsdp_reduce_scatter"]["bytes"] > 0
    c41 = runs["mesh"][1]["4x1_adamw"]["collectives"]
    assert "tp_all_reduce" not in c41 and "ce_all_reduce" not in c41
    c14 = runs["mesh"][1]["1x4_adafactor"]["collectives"]
    assert "fsdp_all_gather" not in c14 and "optimizer_all_reduce" in c14


class _Cfg:
    def __init__(self, hq, hkv):
        self.num_heads, self.num_kv_heads = hq, hkv


@pytest.mark.parametrize("hq,hkv,hq_local,block,want", [
    (4, 2, 1, 3, slice(1, 2)),          # scaled llama at model = 4
    (32, 8, 8, 1, slice(2, 4)),         # whole groups per rank
    (32, 4, 2, 5, slice(1, 2)),         # several ranks share a KV head
    (6, 2, 2, 1, slice(0, 2)),          # one query head per KV head
    (6, 3, 3, 1, [1, 2, 2]),            # unequal groups: a head each
])
def test_kv_heads_a_rank_reads(hq, hkv, hq_local, block, want):
    assert _kv_heads_read(_Cfg(hq, hkv), hq_local, block) == want


class _Mesh:
    """Axis names and sizes, as the reference's ``spec_for`` reads a
    mesh (it needs no devices behind them)."""
    def __init__(self, layout):
        self.axis_names = tm.AXES
        self.shape = dict(zip(tm.AXES, layout))


@pytest.mark.parametrize("layout", tm.MESHES + ((16, 16),),
                         ids=[f"{a}x{b}" for a, b in tm.MESHES + ((16, 16),)])
def test_param_shardings_are_the_references(layout):
    """Every parameter's spec on the mesh equals the reference's
    ``spec_for`` under the train rules, and ``Spec.local_shape`` divides
    each dim by its axes' sizes (full llama3-8b widths at (16, 16))."""
    import warnings
    from repro.distributed.sharding import DEFAULT_RULES, spec_for
    from repro_torch.configs import ARCHS as TARCHS
    from repro_torch.distributed.sharding import MeshLayout
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    cfg = tm.cfg() if layout != (16, 16) else TARCHS[tm.ARCH]
    model = build_model(cfg)
    mesh = MeshLayout(tm.AXES, layout)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        specs = tree_leaves(model.specs())
        got = tree_leaves(model.param_shardings(mesh))
        for spec, sh in zip(specs, got):
            assert sh.spec == tuple(spec_for(spec.logical, spec.shape,
                                             _Mesh(layout), DEFAULT_RULES))
            sizes = dict(zip(tm.AXES, layout))
            want = tuple(n // int(np.prod([sizes[a] for a in sh.axes(i)]))
                         for i, n in enumerate(spec.shape))
            assert spec.local_shape(mesh) == want
