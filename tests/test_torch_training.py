"""The port's training path against the JAX package on the CPU (f32,
``scaled_config``): the optimizers' updates on the same gradients, one
``make_train_step`` step (microbatches 1 and 2, clipped) against the JAX
step, overfitting one batch, a crash at step 5 and a bitwise resume, the
step watchdog, ``python -m repro_torch.launch.train``, the data pipeline's
batches, and the checkpoint layout both packages share (including the
reference's bf16 restore fault, ROADMAP queue 3)."""
import dataclasses
import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, scaled_config  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.training import batch_for_step as jax_batch  # noqa: E402
from repro.training import checkpoint as jax_ckpt  # noqa: E402
from repro.training import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.training import make_train_step as jax_make_step  # noqa: E402
from repro.training.optimizer import (  # noqa: E402
    OptimizerConfig as JaxOptConfig,
)

import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    StepWatchdog, TrainRunner, elastic_reshard,
)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import host_layout  # noqa: E402
from repro_torch.models import (  # noqa: E402
    build_model, opt_state_from_jax, params_from_jax,
)
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.training import (  # noqa: E402
    OptimizerConfig, batch_for_step, checkpoint, make_optimizer,
    make_train_step,
)
from repro_torch.training.train_step import (  # noqa: E402
    clip_by_global_norm, global_norm,
)

# f32 on both sides: the updates run the same arithmetic; XLA and PyTorch
# may round a power, a mean or an rsqrt differently in the last bit, so
# the leaves agree to ~1e-7 relative (1e-5 after a few steps)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _paths(v, f"{prefix}/[{i}]")]
    return [(prefix, tree)]


def _close(port_tree, jax_tree, tol=TOL):
    """Every leaf of the port's tree within tol * max(1, max|ref|) of the
    JAX tree's leaf at the same path."""
    ref = dict(_paths(jax.tree.map(np.asarray, jax_tree)))
    got = _paths(port_tree)
    assert {p for p, _ in got} == set(ref)
    for path, t in got:
        r = ref[path].astype(np.float64)
        err = np.abs(t.double().numpy() - r).max() if r.size else 0.0
        assert err <= tol * max(1.0, np.abs(r).max()), (path, err)


def _models(name="llama3-8b", layers=2):
    jm = jax_build(scaled_config(ARCHS[name], num_layers=layers))
    tm = build_model(tcfgs.scaled_config(tcfgs.ARCHS[name],
                                         num_layers=layers))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm


def _to_port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


# ------------------------------------------------------------ optimizers
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_jax(name):
    """Three updates on the same gradients; then the JAX state, bridged with
    ``opt_state_from_jax``, takes a fourth step in the port."""
    _, jp, _ = _models()
    cfg = dict(name=name, learning_rate=1e-2, warmup_steps=2)
    jopt = jax_make_optimizer(JaxOptConfig(**cfg))
    topt = make_optimizer(OptimizerConfig(**cfg))
    tp = _to_port(jp)
    js, ts = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(0)
    for _ in range(4):
        grads = jax.tree.map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), jp)
        jp, js = jopt.update(grads, js, jp)
        tp, ts = topt.update(_to_port(grads), ts, tp)
    _close(tp, jp)
    _close(ts, js)
    if name == "adafactor":      # the embedding [512, 128] is factored
        v = ts["v"]["embed"]
        assert set(v) == {"vr", "vc"} and v["vr"].shape == (512,) \
            and v["vc"].shape == (128,)
        assert set(ts["v"]["final_norm"]) == {"v"}
    bridged = opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    grads = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), jp)
    tp2 = tree_map(torch.clone, tp)
    jp, js = jopt.update(grads, js, jp)
    tp2, bridged = topt.update(_to_port(grads), bridged, tp2)
    _close(tp2, jp)
    _close(bridged, js)


def test_optimizer_updates_in_place():
    tp = {"w": torch.ones(3, 4), "b": torch.ones(4)}
    opt = make_optimizer(OptimizerConfig(warmup_steps=1))
    st = opt.init(tp)
    w, mu = tp["w"], st["mu"]["w"]
    new, st2 = opt.update({"w": torch.ones(3, 4), "b": torch.ones(4)}, st,
                          tp)
    assert new["w"] is w and st2["mu"]["w"] is mu
    assert not torch.equal(w, torch.ones(3, 4))
    assert st2["step"].item() == 1 and st2["step"].dtype == torch.int32


def test_opt_state_from_jax_refuses_params():
    with pytest.raises(ValueError, match="optimizer state"):
        opt_state_from_jax({"w": np.zeros(2, np.float32)}, "cpu")


def test_global_norm_and_clip():
    tree = [torch.tensor([3.0, 0.0]), torch.tensor([[4.0]]).bfloat16()]
    assert global_norm(tree).item() == 5.0
    clipped, norm = clip_by_global_norm(tree, 1.0)
    assert clipped is tree and norm.item() == 5.0
    assert all(g.dtype == torch.float32 for g in clipped)
    assert abs(global_norm(clipped).item() - 1.0) < 1e-6
    kept, _ = clip_by_global_norm([torch.tensor([0.3])], 1.0)
    assert kept[0].item() == pytest.approx(0.3)


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches, optimizer):
    """One step of each package's ``make_train_step`` on the same params
    and batch, the gradients clipped (0.5 is below their norm). AdamW's
    first step moves each weight by lr * g / (|g| + eps): with the default
    eps of 1e-8 a gradient entry near 1e-8 turns a last-bit difference
    between the two packages' gradients into ~1e-4 of lr, so this step
    comparison takes eps = 1e-3 (the optimizers' own arithmetic is held to
    the reference at the default above)."""
    jm, jp, tm = _models()
    cfg = dict(name=optimizer, learning_rate=1e-2, warmup_steps=1, eps=1e-3)
    jopt = jax_make_optimizer(JaxOptConfig(**cfg))
    topt = make_optimizer(OptimizerConfig(**cfg))
    batch = jax_batch(jm, JaxShape("t", 24, 4, "train"), 0, 0)
    jstep = jax.jit(jax_make_step(jm, jopt, remat_policy="dots_saveable",
                                  microbatches=microbatches, grad_clip=0.5))
    tstep = make_train_step(tm, topt, remat_policy="dots_saveable",
                            microbatches=microbatches, grad_clip=0.5)
    tp = _to_port(jp)
    ts = topt.init(tp)
    jp2, js2, jmet = jstep(jp, jopt.init(jp), batch)
    tp2, ts2, tmet = tstep(tp, ts, {k: torch.from_numpy(np.array(v))
                                    for k, v in batch.items()})
    assert float(jmet["grad_norm"]) > 0.5
    for key in ("loss", "grad_norm"):
        assert abs(tmet[key].item() - float(jmet[key])) <= \
            TOL * abs(float(jmet[key])), key
    _close(tp2, jp2)
    _close(ts2, js2)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_overfits_a_fixed_batch(optimizer):
    _, _, tm = _models()
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    opt = make_optimizer(OptimizerConfig(name=optimizer, learning_rate=1e-2,
                                         warmup_steps=2))
    step = make_train_step(tm, opt, remat_policy="none")
    batch = batch_for_step(tm, ShapeConfig("t", 32, 2, "train"), 0, 0,
                           device="cpu")
    state = opt.init(params)
    losses = []
    for _ in range(15):
        params, state, m = step(params, state, batch)
        losses.append(m["loss"].item())
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.5 * losses[0], losses


# ------------------------------------------------------ fault tolerance
def _runner_setup(tmp, name="llama3-8b", dtype="bfloat16"):
    cfg = dataclasses.replace(
        tcfgs.scaled_config(tcfgs.ARCHS[name], num_layers=2), dtype=dtype)
    model = build_model(cfg)
    opt = make_optimizer(OptimizerConfig(learning_rate=1e-2,
                                         warmup_steps=2))
    shape = ShapeConfig("t", 16, 2, "train")
    params = model.init(torch.Generator().manual_seed(3), "cpu")
    runner = TrainRunner(
        make_train_step(model, opt, remat_policy="full"),
        lambda s: batch_for_step(model, shape, 7, s, device="cpu"),
        str(tmp), ckpt_every=2)
    return runner, params, opt.init(params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crash_and_resume_is_bitwise(tmp_path, dtype):
    """A crash at step 5 (checkpoints at 2 and 4), then ``resume`` from
    step 4 to 8, against 8 uninterrupted steps: the same params, optimizer
    state and losses, bit for bit (the CPU is deterministic; on the card
    CUDA's embedding backward sums with atomics)."""
    ref_runner, p, s = _runner_setup(tmp_path / "ref", dtype=dtype)
    ref_p, ref_s = ref_runner.run(p, s, num_steps=8)
    runner, p, s = _runner_setup(tmp_path / "crash", dtype=dtype)
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        runner.run(p, s, num_steps=8, fail_at=5)
    assert checkpoint.latest_step(str(tmp_path / "crash")) == 4
    _, like_p, like_s = _runner_setup(tmp_path / "unused", dtype=dtype)
    new_p, new_s = runner.resume(like_p, like_s, num_steps=8)
    for a, b in zip(tree_leaves((new_p, new_s)), tree_leaves((ref_p, ref_s))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [m["loss"] for m in runner.metrics_log] == \
        [m["loss"] for m in ref_runner.metrics_log[:5]] + \
        [m["loss"] for m in ref_runner.metrics_log[4:]]
    assert sorted(os.listdir(tmp_path / "crash")) == \
        ["step_00000004", "step_00000006", "step_00000008"]


def test_non_finite_loss_raises(tmp_path):
    def step(p, s, b):
        return p, s, {"loss": torch.tensor(float("nan"))}
    runner = TrainRunner(step, lambda s: {}, str(tmp_path))
    with pytest.raises(FloatingPointError, match="step 0"):
        runner.run({}, {}, num_steps=2)
    with pytest.raises(FileNotFoundError):
        TrainRunner(step, lambda s: {}, str(tmp_path / "none")).resume(
            {}, {}, num_steps=1)


def test_step_watchdog_flags_slow_steps():
    wd = StepWatchdog(threshold=2.0, alpha=0.5)
    assert wd.observe(0, 1.0) is None and wd.baseline == 1.0
    assert wd.observe(1, 1.5) is None and wd.baseline == 1.25
    ev = wd.observe(2, 3.0)
    assert ev is not None and (ev.step, ev.duration, ev.baseline) == \
        (2, 3.0, 1.25)
    assert wd.events == [ev] and wd.baseline == pytest.approx(2.125)


def test_elastic_reshard_moves_expert_leaves(tmp_path):
    """Scaled moonshot's parameters have shardings now (ROADMAP 9b'):
    ``elastic_reshard`` on 2 gloo ranks moves its expert leaves from (2,
    1), where each expert's d dim splits over "data", to (1, 2), where the
    experts split over "model", and back, each block equal to the rank's
    block of one rank's init; on a one-rank world the move is the
    identity."""
    import json
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    import torch_mesh as tmesh
    from repro_torch.launch.mesh import spawn_ranks
    out = str(tmp_path / "move%d.json")
    spawn_ranks(tmesh.expert_move_rank, 2, out)
    for r in range(2):
        res = json.load(open(out % r))
        assert res["to_model"] == 0.0 and res["back"] == 0.0, res
        # w_in [R, E, d, f] = [2, 8, 128, 64]: d over 2 data ranks, then
        # the 8 experts over 2 model ranks
        assert res["shapes"] == [[2, 8, 64, 64], [2, 4, 128, 64]]
    moe = build_model(tcfgs.scaled_config(
        tcfgs.ARCHS["moonshot-v1-16b-a3b"], num_layers=2))
    sh = moe.param_shardings(host_layout(1))
    params = moe.init(torch.Generator().manual_seed(0), "cpu")
    moved = elastic_reshard(params, sh, sh)
    assert all(a is b for a, b in zip(tree_leaves(moved),
                                      tree_leaves(params)))


@pytest.mark.parametrize("name", ["whisper-medium", "llava-next-34b"])
def test_encdec_and_vlm_shardings_are_the_references(name):
    """An enc-dec and a VLM config train over a mesh: on the host mesh of 4
    ranks, (2, 2), every parameter's spec and every train input's (whisper's
    frames split over the model axis as "seq_cp", llava's patch rows whole
    but for their batch) equals the reference's placement under the train
    rules, and ``elastic_reshard`` moves a params tree between the host
    meshes of 1 rank (the tree as it is)."""
    import warnings
    from repro.configs import ARCHS as JARCHS
    from repro.configs import scaled_config as jscaled
    from repro.distributed.sharding import DEFAULT_RULES, spec_for
    from repro.models import build_model as jbuild
    layers = dict(num_layers=2)
    model = build_model(tcfgs.scaled_config(tcfgs.ARCHS[name], **layers))
    jmodel = jbuild(jscaled(JARCHS[name], **layers))
    layout = host_layout(4)

    class _Mesh:
        axis_names = layout.axis_names
        shape = layout.shape
    shape = ShapeConfig("t", 64, 4, "train")
    jshape = JaxShape("t", 64, 4, "train")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = dict(checkpoint._paths(model.param_shardings(layout)))
        want = dict(jax_ckpt._flatten_with_paths(jmodel.specs()))
        assert set(got) == set(want)
        for key, s in want.items():
            assert got[key].spec == tuple(spec_for(
                s.logical, s.shape, _Mesh(), DEFAULT_RULES)), key
        inputs = model.batch_shardings(shape, layout)
        jinputs = jmodel.input_spec_tree(jshape)
        assert set(inputs) == set(jinputs)
        for k, sh in inputs.items():
            s = jinputs[k]
            assert model.input_spec_tree(shape)[k].shape == s.shape, k
            assert sh.spec == tuple(spec_for(s.logical, s.shape, _Mesh(),
                                             DEFAULT_RULES)), k
    if name == "whisper-medium":
        assert inputs["frames"].spec == ("data", "model")
    else:
        assert inputs["patch_embeds"].spec == ("data",)
    one = host_layout(1)
    sh = model.param_shardings(one)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    moved = elastic_reshard(params, sh, sh)
    assert all(a is b for a, b in zip(tree_leaves(moved),
                                      tree_leaves(params)))


# ---------------------------------------------------------------- launch
def test_launch_train_on_cpu_overfits(capsys):
    launch_train.main(["--device", "cpu", "--scaled", "--fixed-batch",
                       "--layers", "2", "--steps", "12", "--batch", "2",
                       "--seq", "32"])
    losses = [float(line.split()[3]) for line in
              capsys.readouterr().out.splitlines()
              if line.startswith("step")]
    assert len(losses) >= 2 and losses[-1] < 0.5 * losses[0], losses


def test_launch_train_resumes_from_its_checkpoint(tmp_path, capsys):
    argv = ["--device", "cpu", "--scaled", "--layers", "2", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    launch_train.main(argv + ["--steps", "2"])
    launch_train.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "resuming from step 2" in out and "'step': 3" in out
    assert checkpoint.latest_step(str(tmp_path)) == 4


class _Built(Exception):
    pass


@pytest.mark.parametrize("argv,layers,width", [
    ([], 32, 4096),
    (["--layers", "3"], 3, 4096),
    (["--scaled"], 4, 128),
    (["--scaled", "--layers", "3"], 3, 128),
])
def test_launch_train_layers_without_scaled_cuts_the_published_config(
        monkeypatch, argv, layers, width):
    """``--layers`` cuts the model with or without ``--scaled``: without
    it the published width runs at that depth (a deliberate difference:
    the reference's launcher reads ``--layers`` only with ``--scaled``;
    the card's training phases run full-width llama3-8b cut in depth).
    The config is read where the model is built, before any weight
    exists."""
    seen = {}

    def build(cfg):
        seen["cfg"] = cfg
        raise _Built

    monkeypatch.setattr(launch_train, "build_model", build)
    with pytest.raises(_Built):
        launch_train.main(["--device", "cpu"] + argv)
    cfg = seen["cfg"]
    assert (cfg.num_layers, cfg.d_model) == (layers, width)


@pytest.mark.parametrize("mesh", ["single_pod", "multi_pod"])
def test_launch_train_production_meshes_raise(mesh):
    """The production meshes need their 256 / 512 ranks; a world of one
    has 1."""
    ranks = 512 if mesh == "multi_pod" else 256
    with pytest.raises(ValueError, match=f"needs {ranks} ranks; the world "
                       "holds 1"):
        launch_train.main(["--device", "cpu", "--mesh", mesh])


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("name,seq", [("llama3-8b", 24),
                                      ("llava-next-34b", 24),
                                      ("whisper-medium", 40)])
def test_batches_match_the_reference_layout(name, seq):
    jm = jax_build(scaled_config(ARCHS[name], num_layers=2))
    tm = build_model(tcfgs.scaled_config(tcfgs.ARCHS[name], num_layers=2))
    jb = jax_batch(jm, JaxShape("t", seq, 3, "train"), 0, 5)
    tb = batch_for_step(tm, ShapeConfig("t", seq, 3, "train"), 0, 5,
                        device="cpu")
    assert list(tb) == list(jb)
    for k in jb:
        a = np.asarray(jb[k])
        assert tuple(tb[k].shape) == a.shape, k
        assert str(tb[k].dtype).removeprefix("torch.") == str(a.dtype), k
    assert torch.equal(tb["mask"], torch.from_numpy(np.array(jb["mask"])))
    for k in ("tokens", "targets"):
        assert 0 <= tb[k].min() and tb[k].max() < tm.cfg.vocab_size
    if "patch_embeds" in tb:     # no loss on the 16 patch positions
        assert tb["mask"][:, :16].sum() == 0 and tb["mask"][:, 16:].all()
    # tokens and targets are cut from one draw, targets one token on
    n = tb["tokens"].shape[1]
    assert torch.equal(tb["targets"][:, :n - 1], tb["tokens"][:, 1:])


def test_batch_is_a_pure_function_of_seed_and_step():
    tm = build_model(tcfgs.scaled_config(tcfgs.ARCHS["llama3-8b"]))
    shape = ShapeConfig("t", 16, 2, "train")

    def b(seed, step):
        return batch_for_step(tm, shape, seed, step, device="cpu")["tokens"]
    assert torch.equal(b(0, 3), b(0, 3))
    assert not torch.equal(b(0, 3), b(0, 4))
    assert not torch.equal(b(0, 3), b(1, 3))


# ------------------------------------------------------------ checkpoint
def _ckpt_tree(lib, dtype):
    """A params-and-optimizer-like tree: nested dicts, a tuple, a scalar."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    if lib == "jax":
        return {"params": {"w": jnp.asarray(w, dtype), "blocks": (
            {"b": jnp.asarray(b)},)}, "opt": {"step": jnp.int32(7)}}
    tdt = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[dtype]
    return {"params": {"w": torch.from_numpy(w).to(tdt), "blocks": (
        {"b": torch.from_numpy(b)},)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _same_dir(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n


def test_bf16_checkpoint_of_the_reference_restores_in_the_port(tmp_path):
    """ROADMAP queue 3: the JAX package writes a bf16 leaf as a '<V2'
    payload it cannot read back; the port writes the same bytes and reads
    them bitwise."""
    jax_ckpt.save(str(tmp_path / "jax"), 3, _ckpt_tree("jax", jnp.bfloat16))
    like = _ckpt_tree("torch", jnp.bfloat16)
    got, extra = checkpoint.restore(str(tmp_path / "jax"), 3, like)
    assert extra == {}
    for a, b in zip(tree_leaves(got), tree_leaves(like)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(TypeError, match="V2"):
        jax_ckpt.restore(str(tmp_path / "jax"), 3,
                         _ckpt_tree("jax", jnp.bfloat16))
    checkpoint.save(str(tmp_path / "port"), 3, like)
    _same_dir(tmp_path / "jax" / "step_00000003",
              tmp_path / "port" / "step_00000003")


def test_f32_checkpoints_cross_both_ways(tmp_path):
    jt, tt = _ckpt_tree("jax", jnp.float32), _ckpt_tree("torch", jnp.float32)
    jax_ckpt.save(str(tmp_path / "jax"), 1, jt, extra={"note": "x"})
    checkpoint.save(str(tmp_path / "port"), 1, tt, extra={"note": "x"})
    _same_dir(tmp_path / "jax" / "step_00000001",
              tmp_path / "port" / "step_00000001")
    got, extra = checkpoint.restore(str(tmp_path / "jax"), 1, tt)
    assert extra == {"note": "x"}
    for a, b in zip(tree_leaves(got), tree_leaves(tt)):
        assert torch.equal(a, b)
    back, _ = jax_ckpt.restore(str(tmp_path / "port"), 1, jt)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jt)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_keeps_the_three_newest(tmp_path):
    tree = {"x": torch.zeros(2)}
    for step in range(1, 6):
        checkpoint.save(str(tmp_path), step, tree)
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000003", "step_00000004", "step_00000005"]
    assert checkpoint.latest_step(str(tmp_path)) == 5
    assert checkpoint.latest_step(str(tmp_path / "absent")) is None
