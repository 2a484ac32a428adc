"""The port's enc-dec and VLM training over a (data, model) ``DeviceMesh``
of 4 gloo ranks on the CPU, against the JAX package's under the same mesh
and against the port's own training on one rank.

Scaled whisper (2 + 2 layers), its twin with an odd vocabulary of 509
(which the model axis does not divide: the spec fallback keeps it whole)
and scaled llava (2 layers, 16 patch rows), f32, take 3 AdamW steps
(``make_train_step``, ``dots_saveable``) on meshes (2, 2), (4, 1) and (1,
4) (the odd twin on (2, 2)) at a global batch of 4 rows: whisper's 32
frames, split over the model axis as the reference's "seq_cp" places them,
and 16 decoder tokens; llava's 16 patch rows and 16 tokens. Parameters
come from the JAX init, batches from seeded numpy. One spawn runs every
case (``tests/torch_mesh_encdec_vlm.py``); one JAX subprocess a model runs
the same steps under ``jax.jit`` on 4 forced host devices, as
``tests/test_torch_mesh_moe_ssm.py`` does. Each step's loss and grad norm
agree with JAX's and one rank's within 1e-5 relative and every leaf of the
params and the optimizer state after step 3 within 2e-5 of the leaf's
largest magnitude.

A gradient check holds every leaf's gradient of the first batch's loss on
(2, 2) and (1, 4), gathered whole, to one rank's within 2e-5 of the leaf's
largest magnitude: the encoder's leaves, which the decoder reaches only
through cross-attention, see a missing *copy to region* of the encoder's
output (their gradient would be one model rank's part of the sum)."""
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
import torch_mesh_encdec_vlm as ev  # noqa: E402

from repro.configs import ARCHS, scaled_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.training.checkpoint import _flatten_with_paths  # noqa: E402

from repro_torch.launch.mesh import spawn_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL_SCALAR = 1e-5
TOL_LEAF = 2e-5
IDS = [ev.case_name(*c) for c in ev.CASES]

JAX_SNIPPET = r"""
import dataclasses, json, sys, warnings
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
out, meta = {}, {}
for name, layout, case in sp["cases"]:
    arch, layers, vocab = sp["models"][name]
    cfg = scaled_config(ARCHS[arch], num_layers=layers)
    if vocab:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    model = build_model(cfg)
    shape = ShapeConfig("t", sp["seq"][name], sp["batch"], "train")
    abst = model.abstract_params()
    params = jax.tree.unflatten(jax.tree.structure(abst), [
        z[f"{name}/params/" + k] for k, _ in _flatten_with_paths(abst)])
    mesh = make_auto_mesh(tuple(layout), ("data", "model"))
    with mesh_context(mesh, DEFAULT_RULES):
        params = jax.device_put(params,
                                model.param_shardings(mesh, DEFAULT_RULES))
        opt = make_optimizer(OptimizerConfig(name="adamw", **sp["opt_kw"]))
        state = opt.init(params)
        step = jax.jit(make_train_step(model, opt,
                                       remat_policy="dots_saveable"))
        bs = batch_shardings(model, shape, mesh, DEFAULT_RULES)
        losses, norms = [], []
        for i in range(sp["steps"]):
            batch = jax.device_put(
                {k: z[f"{name}/batch{i}/{k}"] for k in bs}, bs)
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    meta[case] = {"loss": losses, "grad_norm": norms}
    for key, leaf in _flatten_with_paths({"params": params, "opt": state}):
        out[f"{case}/{key}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
with open(sys.argv[2] + ".json", "w") as f:
    json.dump(meta, f)
"""


def _jax_cfg(name):
    import dataclasses
    arch, layers, vocab = ev.MODELS[name]
    c = scaled_config(ARCHS[arch], num_layers=layers)
    return dataclasses.replace(c, vocab_size=vocab) if vocab else c


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": (arrays, meta), "mesh": (arrays, meta), "one": {model:
    (losses, norms, leaves by key, gradients by key)}, "inputs": z}: the
    JAX subprocesses started first and run beside the spawn; the port's
    one-rank runs after."""
    tmp = tmp_path_factory.mktemp("mesh_encdec_vlm")
    z = {}
    for i, name in enumerate(ev.MODELS):
        jp = jax_build(_jax_cfg(name)).init(jax.random.PRNGKey(i))
        z.update({f"{name}/params/{k}": np.asarray(v)
                  for k, v in _flatten_with_paths(jp)})
    z.update(ev.batches(0))
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **z)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = {}
    for name in ev.MODELS:
        spec = json.dumps({
            "models": ev.MODELS, "steps": tm.STEPS, "batch": ev.BATCH,
            "seq": {n: ev.shape_seq(n) for n in ev.MODELS},
            "cases": [[n, list(lay), ev.case_name(n, lay)]
                      for n, lay in ev.CASES if n == name],
            "opt_kw": tm.OPT_KW["adamw"]})
        out = str(tmp / f"jax_{name}.npz")
        procs[out] = subprocess.Popen(
            [sys.executable, "-c", JAX_SNIPPET, inputs, out, spec], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        mesh_out = str(tmp / "mesh")
        spawn_ranks(ev.train_rank, 4, inputs, mesh_out)
        one = {}
        for name in ev.MODELS:
            losses, norms, params, state, _ = ev.train(z, None, name)
            one[name] = (losses, norms, {
                k: v.numpy() for k, v in tm.paths({"params": params,
                                                    "opt": state})},
                ev.grads(z, None, name))
    finally:
        logs = {out: proc.communicate(timeout=900)[0]
                for out, proc in procs.items()}
    for out, proc in procs.items():
        assert proc.returncode == 0, logs[out][-3000:]

    def load(path):
        with open(path + ".json") as f:
            return dict(np.load(path if path.endswith(".npz")
                                else path + ".npz")), json.load(f)
    jax_arrays, jax_meta = {}, {}
    for out in procs:
        arrays, meta = load(out)
        jax_arrays.update(arrays)
        jax_meta.update(meta)
    return {"jax": (jax_arrays, jax_meta), "mesh": load(mesh_out),
            "one": one, "inputs": z}


def _leaves_close(got: dict, ref: dict, tol: float):
    """Every leaf of ``ref`` (key -> array) in ``got`` within tol of the
    leaf's largest magnitude."""
    assert set(got) == set(ref), set(got) ^ set(ref)
    for key, r in ref.items():
        r = r.astype(np.float64)
        scale = max(np.abs(r).max(), 1e-30)
        err = float(np.abs(got[key].astype(np.float64) - r).max()) / scale
        assert err <= tol, (key, err)


def _case_leaves(arrays: dict, case: str) -> dict:
    return {k[len(case) + 1:]: v for k, v in arrays.items()
            if k.startswith(case + "/")}


@pytest.mark.parametrize("name,layout", ev.CASES, ids=IDS)
def test_mesh_training_matches_jax_under_the_same_mesh(runs, name, layout):
    case = ev.case_name(name, layout)
    (ja, jmeta), (ma, mmeta) = runs["jax"], runs["mesh"]
    for key in ("loss", "grad_norm"):
        for got, ref in zip(mmeta[case][key], jmeta[case][key]):
            assert np.isfinite(got) and \
                abs(got - ref) <= TOL_SCALAR * abs(ref), (key, got, ref)
    _leaves_close(_case_leaves(ma, case), _case_leaves(ja, case), TOL_LEAF)
    z = runs["inputs"]
    for key, v in _case_leaves(ma, case).items():
        if key.startswith("params/"):
            assert not np.array_equal(v, z[f"{name}/{key}"]), key


@pytest.mark.parametrize("name,layout", ev.CASES, ids=IDS)
def test_mesh_training_matches_one_rank(runs, name, layout):
    case = ev.case_name(name, layout)
    losses, norms, leaves, _ = runs["one"][name]
    meta = runs["mesh"][1][case]
    for got, ref in zip(meta["loss"] + meta["grad_norm"], losses + norms):
        assert abs(got - ref) <= TOL_SCALAR * abs(ref), (got, ref)
    _leaves_close(_case_leaves(runs["mesh"][0], case), leaves, TOL_LEAF)


@pytest.mark.parametrize("name,layout", ev.GRAD_CASES,
                         ids=[ev.case_name(*c) for c in ev.GRAD_CASES])
def test_every_leaf_gradient_matches_one_rank(runs, name, layout):
    """Each leaf's gradient on the mesh, gathered whole, within 2e-5 of
    its largest magnitude of one rank's, the encoder's leaves included;
    every leaf's gradient is nonzero."""
    ref = runs["one"][name][3]
    got = _case_leaves(runs["mesh"][0], f"grad/{ev.case_name(name, layout)}")
    _leaves_close(got, ref, TOL_LEAF)
    assert all(np.abs(g).max() > 0 for g in ref.values())
    if name == "whisper":
        assert any(k.startswith("encoder/") for k in ref)


def test_collectives_of_a_step_by_kind(runs):
    """Whisper's frames are gathered over the model axis where it splits
    their sequence, and only there; the odd vocabulary keeps the
    embedding's vocab whole (its lookup makes no all-reduce over the model
    axis, so fewer tensor-parallel all-reduces than the even twin's)."""
    meta = runs["mesh"][1]
    c = {case: meta[case]["collectives"] for case in meta}
    assert c["whisper_2x2"]["frames_all_gather"]["calls"] == 1
    assert c["whisper_1x4"]["frames_all_gather"]["calls"] == 1
    assert "frames_all_gather" not in c["whisper_4x1"]
    assert "frames_all_gather" not in c["llava_2x2"]
    assert c["whisper_odd_2x2"]["tp_all_reduce"]["calls"] < \
        c["whisper_2x2"]["tp_all_reduce"]["calls"]
