"""The port's MoE, Mamba and xLSTM stacks trained over a (data, model)
``DeviceMesh`` of 4 gloo ranks on the CPU, against the JAX package's under
the same mesh and against the port's own training on one rank.

Scaled moonshot (2 layers, 8 experts, top-2), kimi (2 layers, GQA), jamba
(8 layers: Mamba/dense, Mamba/MoE and attention/MoE) and xlstm (8 layers:
7 mLSTM and an sLSTM), f32, take 3 AdamW steps (``make_train_step``,
``dots_saveable``) on meshes (2, 2), (4, 1) and (1, 4) at a global batch
of 4 x 16 tokens, where the MoE routes one group per data rank; moonshot
also at 4 x 8 tokens on (2, 2) and (4, 1), where all tokens form one group
and the data ranks exchange their per-expert counts, and 3 Adafactor steps
on (2, 2), which factor the 3-D expert leaves. Parameters come from the
JAX init, batches from seeded numpy. One spawn runs every case
(``tests/torch_mesh_moe_ssm.py``), and the launcher on the host mesh with
a scaled MoE and a scaled Mamba config; JAX subprocesses run the same
steps under ``jax.jit`` on 4 forced host devices, as
``tests/test_torch_mesh_train.py`` does (one subprocess a model, side
by side). Each step's loss and grad norm
agree with JAX's within 1e-5 relative and every leaf of the params and
the optimizer state after step 3 within 2e-5 of the leaf's largest
magnitude. Against one rank the same limits hold wherever the MoE routes
in one rank's groups (``same_groups``: xlstm, every (1, 4) case and the
4 x 8 batch); where a data rank's tokens form a group of their own, the
smaller groups drop other assignments than one rank's single group, and
JAX under the same mesh is the reference.

A layer test holds the mesh's drop pattern (``route``'s slot and disp)
bitwise to one rank's ``route`` run on each group's tokens, at 32 tokens
(g = 1, through the count exchange) and 96 (g = data shards), under
routing skewed so that capacity drops; its ``return_stats`` counts equal
the JAX block's and its aux loss is the global batch's; the router's
gradient equals one rank's (no model-axis factor)."""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
import torch_mesh as tm  # noqa: E402
import torch_mesh_moe_ssm as mm  # noqa: E402

from repro.configs import ARCHS, scaled_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.blocks import MoE as JaxMoE  # noqa: E402
from repro.models.common import tree_init  # noqa: E402
from repro.training.checkpoint import _flatten_with_paths  # noqa: E402

from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models.blocks import MoE  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL_SCALAR = 1e-5
TOL_LEAF = 2e-5
# the launcher prints losses to 4 decimals
TOL_CLI = 1e-4
IDS = [mm.case_name(*c) for c in mm.CASES]
ONE_RANK = [c for c in mm.CASES if mm.same_groups(c[0], c[1], c[2])]

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
out, meta = {}, {}
for name, (b, s), layout, opt_name, case in sp["cases"]:
    arch, layers = sp["models"][name]
    model = build_model(scaled_config(ARCHS[arch], num_layers=layers))
    shape = ShapeConfig("t", s, b, "train")
    abst = model.abstract_params()
    params = jax.tree.unflatten(jax.tree.structure(abst), [
        z[f"{name}/params/" + k] for k, _ in _flatten_with_paths(abst)])
    mesh = make_auto_mesh(tuple(layout), ("data", "model"))
    with mesh_context(mesh, DEFAULT_RULES):
        params = jax.device_put(params,
                                model.param_shardings(mesh, DEFAULT_RULES))
        opt = make_optimizer(OptimizerConfig(name=opt_name,
                                             **sp["opt_kw"][opt_name]))
        state = opt.init(params)
        step = jax.jit(make_train_step(model, opt,
                                       remat_policy="dots_saveable"))
        bs = batch_shardings(model, shape, mesh, DEFAULT_RULES)
        losses, norms = [], []
        for i in range(sp["steps"]):
            batch = jax.device_put(
                {k: z[f"{name}/{b}x{s}/batch{i}/{k}"] for k in bs}, bs)
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
    arch, layers = mm.MODELS[name]
    return scaled_config(ARCHS[arch], num_layers=layers)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": (arrays, meta), "mesh": (arrays, meta), "one": {(model,
    batch, opt): (losses, norms, leaves by key)}, "cli": {model: one
    rank's launcher losses}}: the JAX subprocesses started first and run
    beside the spawn; the port's one-rank runs after."""
    tmp = tmp_path_factory.mktemp("mesh_moe_ssm")
    z = {}
    for i, name in enumerate(mm.MODELS):
        jp = jax_build(_jax_cfg(name)).init(jax.random.PRNGKey(i))
        z.update({f"{name}/params/{k}": np.asarray(v)
                  for k, v in _flatten_with_paths(jp)})
    z.update(mm.batches(0))
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **z)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    # one JAX subprocess a model, side by side (their compiles dominate)
    procs = {}
    for name in mm.MODELS:
        spec = json.dumps({"models": mm.MODELS, "steps": tm.STEPS,
                           "cases": [list(c) + [mm.case_name(*c)]
                                     for c in mm.CASES if c[0] == name],
                           "opt_kw": tm.OPT_KW})
        out = str(tmp / f"jax_{name}.npz")
        procs[out] = subprocess.Popen(
            [sys.executable, "-c", JAX_SNIPPET, inputs, out, spec], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        mesh_out = str(tmp / "mesh")
        spawn_ranks(mm.train_rank, 4, inputs, mesh_out, mm.CASES)
        one = {}
        for name, batch, _, opt in ONE_RANK:
            if (name, batch, opt) not in one:
                losses, norms, params, state, _ = mm.train(z, None, name,
                                                           batch, opt)
                one[name, batch, opt] = (losses, norms, {
                    k: v.numpy() for k, v in tm.paths({"params": params,
                                                        "opt": state})})
        cli = {name: mm.cli_losses(argv + mm.CLI_COMMON)
               for name, argv in mm.CLI.items()}
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
            "one": one, "cli": cli, "inputs": z}


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


@pytest.mark.parametrize("name,batch,layout,opt", mm.CASES, ids=IDS)
def test_mesh_training_matches_jax_under_the_same_mesh(runs, name, batch,
                                                       layout, opt):
    case = mm.case_name(name, batch, layout, opt)
    (ja, jmeta), (ma, mmeta) = runs["jax"], runs["mesh"]
    for key in ("loss", "grad_norm"):
        for got, ref in zip(mmeta[case][key], jmeta[case][key]):
            assert np.isfinite(got) and \
                abs(got - ref) <= TOL_SCALAR * abs(ref), (key, got, ref)
    _leaves_close(_case_leaves(ma, case), _case_leaves(ja, case), TOL_LEAF)
    # every weight moved from its init
    z = runs["inputs"]
    for key, v in _case_leaves(ma, case).items():
        if key.startswith("params/"):
            assert not np.array_equal(v, z[f"{name}/{key}"]), key


@pytest.mark.parametrize("name,batch,layout,opt", ONE_RANK,
                         ids=[mm.case_name(*c) for c in ONE_RANK])
def test_mesh_training_matches_one_rank(runs, name, batch, layout, opt):
    case = mm.case_name(name, batch, layout, opt)
    losses, norms, leaves = runs["one"][name, batch, opt]
    meta = runs["mesh"][1][case]
    for got, ref in zip(meta["loss"] + meta["grad_norm"], losses + norms):
        assert abs(got - ref) <= TOL_SCALAR * abs(ref), (got, ref)
    _leaves_close(_case_leaves(runs["mesh"][0], case), leaves, TOL_LEAF)


@pytest.mark.parametrize("name", list(mm.MODELS))
@pytest.mark.parametrize("layout", tm.MESHES,
                         ids=[f"{a}x{b}" for a, b in tm.MESHES])
def test_init_on_a_mesh_keeps_the_blocks_of_one_rank_init(runs, name,
                                                          layout):
    assert runs["mesh"][1][f"init_{name}_{layout[0]}x{layout[1]}"] is True


def test_collectives_of_a_step_by_kind(runs):
    """The count exchange runs only where all tokens form one group (4 x 8
    tokens on (2, 2)), never where each data rank routes its own; Mamba's
    in_proj is gathered over the model axis and reduce-scattered back;
    the aux loss's sums cross the data axes."""
    meta = runs["mesh"][1]
    small = meta[mm.case_name("moonshot", mm.SMALL, (2, 2), "adamw")]
    big = meta[mm.case_name("moonshot", mm.BIG, (2, 2), "adamw")]
    assert small["collectives"]["moe_counts"]["calls"] > 0
    assert "moe_counts" not in big["collectives"]
    assert big["collectives"]["moe_aux_all_reduce"]["calls"] > 0
    jamba = meta[mm.case_name("jamba", mm.BIG, (2, 2), "adamw")]
    assert {"tp_all_gather", "tp_reduce_scatter"} <= set(
        jamba["collectives"])
    xl = meta[mm.case_name("xlstm", mm.BIG, (1, 4), "adamw")]
    assert "tp_all_reduce" in xl["collectives"] and \
        "fsdp_all_gather" not in xl["collectives"]


@pytest.mark.parametrize("name", list(mm.CLI))
def test_launcher_on_the_host_mesh_matches_one_rank(runs, name):
    """``launch.train --mesh host`` on the 4-rank world ((2, 2)): the
    losses fall over the 5 steps and equal one rank's launcher run to the
    printed digits."""
    got, ref = runs["mesh"][1][f"cli_{name}"], runs["cli"][name]
    assert len(got) == 5 and got[-1] < got[0], got
    assert np.allclose(got, ref, rtol=0, atol=TOL_CLI), (got, ref)


# ---------------------------------------------------------- drop pattern
@pytest.fixture(scope="module")
def routes(tmp_path_factory):
    """The mesh's route results (``mm.route_rank``), the layer's params
    (JAX init) and inputs."""
    tmp = tmp_path_factory.mktemp("mesh_route")
    jc = _jax_cfg("moonshot")
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, capacity_factor=0.25, min_capacity=1))
    jp = tree_init(JaxMoE().specs(jc), jax.random.PRNGKey(7))
    z = {f"moe/{k}": np.asarray(v) for k, v in jp.items()}
    z.update(mm.route_inputs())
    inputs, out = str(tmp / "inputs.npz"), str(tmp / "route.npz")
    np.savez(inputs, **z)
    spawn_ranks(mm.route_rank, 4, inputs, out)
    return jc, jp, z, dict(np.load(out))


def _groups(layout, tokens):
    """The JAX block's group count of ``tokens`` (rows, per row) on a mesh
    of ``layout``: 1 where t * k <= 8 E, else gcd(t, data shards)."""
    t = tokens[0] * tokens[1]
    c = mm.route_cfg()
    if t * c.moe.top_k <= 8 * c.moe.num_experts:
        return 1
    return math.gcd(t, layout[0])


CASES_ROUTE = [(lay, tok) for lay in mm.ROUTE_MESHES
               for tok in mm.ROUTE_TOKENS]


@pytest.mark.parametrize("layout,tokens", CASES_ROUTE,
                         ids=[f"{a}x{b}_{r}x{s}"
                              for (a, b), (r, s) in CASES_ROUTE])
def test_drop_pattern_is_the_reference_grouping(routes, layout, tokens):
    """slot and disp bitwise equal to one rank's ``route`` on each group's
    tokens (the JAX block's groups); capacity drops assignments in every
    case; output, aux loss and the gradients of the router and the
    experts equal one rank's per-group layer; the counts equal the JAX
    block's."""
    jc, jp, z, res = routes
    c = mm.route_cfg()
    e, k = c.moe.num_experts, c.moe.top_k
    key = f"{layout[0]}x{layout[1]}/{tokens[0]}x{tokens[1]}"
    x = torch.from_numpy(z[f"x{tokens[0]}x{tokens[1]}"])
    t = x.shape[0] * x.shape[1]
    xf = x.reshape(t, -1)
    p = {n[4:]: torch.tensor(v, requires_grad=True)
         for n, v in z.items() if n.startswith("moe/")}
    g = _groups(layout, tokens)
    assert g == (1 if tokens == mm.ROUTE_TOKENS[0] else layout[0])
    tg = t // g
    moe = MoE()
    slots, disps, ys = [], [], []
    for i in range(g):
        _, _, disp, _, slot, cap = moe.route(p, xf[i * tg:(i + 1) * tg], c)
        slots.append(slot)
        disps.append(torch.where(disp < tg, disp + i * tg, t))
        ys.append(moe.forward(p, xf[i * tg:(i + 1) * tg], c)[0])
        assert int(res[f"{key}/cap"]) == cap
    # every data rank's slots, in token order; each group's disp merged
    # over the ranks that share it (T where another rank's token sits)
    got_slot = res[f"{key}/slot"].reshape(t, k)
    assert np.array_equal(got_slot, torch.cat(slots).numpy())
    assert (got_slot == e * cap).any() and (got_slot < e * cap).any()
    per = layout[0] // g
    got_disp = res[f"{key}/disp"].reshape(g, per, -1).min(axis=1)
    assert np.array_equal(got_disp, torch.stack(disps).numpy())
    # the layer's output, aux loss and gradients against one rank's on the
    # same groups
    y = torch.cat(ys)
    aux = moe(p, xf, c)[1]
    y_ref = y.detach()
    assert np.allclose(res[f"{key}/y"].reshape(t, -1), y_ref.numpy(),
                       rtol=0, atol=1e-5 * float(y_ref.abs().max()))
    assert abs(float(res[f"{key}/aux"]) - aux.item()) <= 1e-6 * aux.item()
    loss = (y * y).sum() / t + aux
    grads = torch.autograd.grad(loss, list(p.values()))
    for n, gr in zip(p, grads):
        got = res[f"{key}/grad/{n}"]
        assert np.abs(got - gr.numpy()).max() <= \
            2e-5 * float(gr.abs().max()), n
    # the pre-capacity counts and the aux loss are the JAX block's (they
    # do not depend on the groups)
    _, jaux, jcounts = JaxMoE()(jp, jnp.asarray(xf.numpy()), jc,
                                return_stats=True)
    assert np.array_equal(res[f"{key}/counts"], np.asarray(jcounts))
    assert abs(float(res[f"{key}/aux"]) - float(jaux)) <= 1e-5 * float(jaux)


@pytest.mark.parametrize("layout", tm.MESHES + ((16, 16),),
                         ids=[f"{a}x{b}" for a, b in tm.MESHES + ((16, 16),)])
@pytest.mark.parametrize("name", list(mm.MODELS))
def test_param_shardings_are_the_references(name, layout):
    """Every parameter's spec on the mesh equals the reference's
    ``spec_for`` under the train rules (the published widths at (16,
    16)), the expert and SSM leaves included."""
    import warnings
    from repro.distributed.sharding import DEFAULT_RULES, spec_for
    from repro_torch.configs import ARCHS as TARCHS
    from repro_torch.configs import scaled_config as tscaled
    from repro_torch.distributed.sharding import MeshLayout
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    arch, layers = mm.MODELS[name]
    cfg = tscaled(TARCHS[arch], num_layers=layers) \
        if layout != (16, 16) else TARCHS[arch]
    model = build_model(cfg)

    class _Mesh:
        axis_names = tm.AXES
        shape = dict(zip(tm.AXES, layout))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = tree_leaves(model.param_shardings(MeshLayout(tm.AXES, layout)))
        for spec, sh in zip(tree_leaves(model.specs()), got):
            assert sh.spec == tuple(spec_for(spec.logical, spec.shape,
                                             _Mesh(), DEFAULT_RULES))


@pytest.mark.parametrize("layout", tm.MESHES,
                         ids=[f"{a}x{b}" for a, b in tm.MESHES])
def test_moe_batch_the_data_shards_do_not_split_raises(layout):
    """An MoE config's token groups read a rank's rows as its block of the
    global batch, so ``batch_shardings`` refuses a batch that the data
    shards do not divide (the fallback would keep it whole on every rank);
    a dense config keeps the fallback, and a batch they divide splits."""
    import warnings
    from repro_torch.configs import ARCHS as TARCHS
    from repro_torch.configs import scaled_config as tscaled
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import DEFAULT_RULES, MeshLayout
    from repro_torch.launch.shardings import batch_shardings
    from repro_torch.models import build_model
    mesh = MeshLayout(tm.AXES, layout)
    odd = ShapeConfig("odd", 8, 2 * layout[0] - 1, "train")
    even = ShapeConfig("even", 8, 2 * layout[0], "train")
    moe = build_model(tscaled(TARCHS["moonshot-v1-16b-a3b"], num_layers=2))
    dense = build_model(tscaled(TARCHS["llama3-8b"], num_layers=2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if layout[0] > 1:
            with pytest.raises(ValueError, match="data shards"):
                batch_shardings(moe, odd, mesh, DEFAULT_RULES)
        assert batch_shardings(dense, odd, mesh, DEFAULT_RULES)[
            "tokens"].local_shape((odd.global_batch, 8)) == \
            (odd.global_batch, 8)
        sh = batch_shardings(moe, even, mesh, DEFAULT_RULES)
        for leaf in sh.values():
            assert leaf.local_shape((even.global_batch, 8)) == (2, 8)
