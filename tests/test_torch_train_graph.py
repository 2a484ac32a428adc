"""The compiled training step's CPU side (``training.train_graph``; the
graphs themselves run only on a CUDA device, in
``test_torch_train_graph_gpu.py``): the cache key stays the same over
in-place steps with either optimizer and misses after a restore, a resume
or a batch of another shape; the step counter stays one tensor; the
compiled step refuses the CPU and a mesh; the launcher's ``--graphs``; the
checkpoints without RNG state give the gradients they gave with it."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, scaled_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import TrainRunner  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    MeshLayout, mesh_context,
)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.training import (  # noqa: E402
    OptimizerConfig, batch_for_step, checkpoint, make_optimizer,
    make_train_step,
)
from repro_torch.training.train_graph import (  # noqa: E402
    compile_train_step, step_in_place, train_key,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(optimizer="adamw", arch="llama3-8b", layers=2, remat="full",
           microbatches=1):
    cfg = scaled_config(ARCHS[arch], num_layers=layers)
    model = build_model(cfg)
    opt = make_optimizer(OptimizerConfig(name=optimizer, learning_rate=1e-2,
                                         warmup_steps=2))
    step = make_train_step(model, opt, remat_policy=remat,
                           microbatches=microbatches)
    params = model.init(torch.Generator().manual_seed(0), "cpu")

    def batch(s, seq=16):
        return batch_for_step(model, ShapeConfig("t", seq, 2, "train"), 3, s,
                              device="cpu")
    return model, opt, step, params, opt.init(params), batch


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_in_place_steps_keep_the_key_and_the_counter(optimizer):
    """Steps that leave the state in its tensors (as the graph's do) keep
    the key; the counter is the same tensor and counts; each step equals
    the eager step on a copy of the state, bit for bit."""
    _, _, step, params, state, batch = _setup(optimizer)
    key, counter = train_key(step, params, state, batch(0)), state["step"]
    ref_p = [x.clone() for x in tree_leaves(params)]
    ref = (common.tree_map(lambda x: x.clone(), params),
           common.tree_map(lambda x: x.clone(), state))
    for s in range(3):
        loss, gnorm = step_in_place(step, params, state, batch(s))
        ref_p2, ref_s2, m = step(*ref, batch(s))
        ref = (ref_p2, ref_s2)
        assert torch.equal(loss, m["loss"])
        assert torch.equal(gnorm, m["grad_norm"])
    assert train_key(step, params, state, batch(3)) == key
    assert state["step"] is counter and int(counter) == 3
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves((params, state)), tree_leaves(ref)))
    assert not all(torch.equal(a, b)
                   for a, b in zip(tree_leaves(params), ref_p))
    # the eager step returns a new counter: its key would change
    p2, s2, _ = step(params, state, batch(3))
    assert s2["step"] is not counter
    assert train_key(step, p2, s2, batch(4)) != key


def test_the_key_misses_after_a_restore_or_a_resume(tmp_path):
    _, opt, step, params, state, batch = _setup()
    key = train_key(step, params, state, batch(0))
    checkpoint.save(str(tmp_path / "ck"), 1, {"params": params,
                                              "opt": state})
    tree, _ = checkpoint.restore(str(tmp_path / "ck"), 1,
                                 {"params": params, "opt": state})
    assert train_key(step, tree["params"], tree["opt"], batch(0)) != key
    seen = []

    def recording(p, s, b):
        seen.append(train_key(step, p, s, b))
        loss, gnorm = step_in_place(step, p, s, b)
        return p, s, {"loss": loss, "grad_norm": gnorm}
    runner = TrainRunner(recording, batch, str(tmp_path / "run"),
                         ckpt_every=2)
    runner.run(params, state, num_steps=2)
    runner.resume(params, state, num_steps=3)
    assert len(seen) == 3 and seen[0] != seen[2]
    # another batch shape misses too; another step's microbatches as well
    assert train_key(step, params, state, batch(0, seq=8)) != key
    other = make_train_step(build_model(scaled_config(ARCHS["llama3-8b"],
                                                      num_layers=2)),
                            opt, remat_policy="full", microbatches=2)
    assert train_key(other, params, state, batch(0)).storage == key.storage
    assert train_key(other, params, state, batch(0)) != key


def test_compiled_step_refuses_the_cpu_and_a_mesh():
    _, _, step, _, _, _ = _setup()
    with pytest.raises(ValueError, match="needs a CUDA device, not cpu"):
        compile_train_step(step, "cpu")
    layout = MeshLayout(("data", "model"), (2, 2))
    with mesh_context(layout):
        with pytest.raises(ValueError, match="cannot be captured"):
            compile_train_step(step)

    def built_on_a_mesh(p, s, b):
        return step(p, s, b)
    built_on_a_mesh.mesh = layout
    with pytest.raises(ValueError, match="cannot be captured"):
        compile_train_step(built_on_a_mesh)


def test_train_step_carries_what_the_key_reads():
    _, _, step, _, _, _ = _setup(remat="dots_saveable", microbatches=2)
    assert (step.microbatches, step.remat_policy, step.mesh) == \
        (2, "dots_saveable", None)


@pytest.mark.parametrize("argv,first", [
    ([], "train step: eager (--device cpu)"),
    (["--graphs", "off"], "train step: eager (--graphs off)"),
])
def test_launcher_names_the_step_it_runs(capsys, argv, first):
    launch_train.main(["--device", "cpu", "--scaled", "--fixed-batch",
                       "--layers", "2", "--steps", "12", "--batch", "2",
                       "--seq", "32"] + argv)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == first
    losses = [float(line.split()[3]) for line in lines
              if line.startswith("step")]
    assert len(losses) >= 2 and losses[-1] < 0.5 * losses[0], losses


def test_launcher_refuses_graphs_on_the_cpu():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        launch_train.main(["--device", "cpu", "--graphs", "on", "--scaled",
                           "--layers", "2", "--steps", "1", "--batch", "2",
                           "--seq", "16"])
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu", "--graphs", "auto"])


@pytest.mark.parametrize("arch,remat", [("llama3-8b", "full"),
                                        ("llama3-8b", "dots_saveable"),
                                        ("xlstm-1.3b", "none")])
def test_checkpoints_without_rng_state_give_the_same_gradients(
        monkeypatch, arch, remat):
    """``remat`` keeps no RNG state; with it (the checkpoint's default) the
    gradients are the same, bit for bit (nothing in a step is random).
    xlstm under "none" still checkpoints its sLSTM time chunks ("full")."""
    layers = 8 if arch == "xlstm-1.3b" else 2
    model, _, _, params, _, batch = _setup(arch=arch, layers=layers)
    b = batch(0)

    def grads():
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        loss = model.train_loss(common.tree_map(lambda _: next(it), params),
                                b, remat_policy=remat)
        return [loss] + list(torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True))
    calls = []
    real = common.checkpoint

    def counting(*args, **kw):
        calls.append(kw["preserve_rng_state"])
        return real(*args, **kw)
    monkeypatch.setattr(common, "checkpoint", counting)
    without = grads()
    assert calls and not any(calls)

    def preserving(*args, **kw):
        return real(*args, **dict(kw, preserve_rng_state=True))
    monkeypatch.setattr(common, "checkpoint", preserving)
    with_rng = grads()
    assert all(torch.equal(a, b) for a, b in zip(without, with_rng))


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-34b"])
def test_the_key_covers_every_batch_entry(arch):
    """An enc-dec's frames and a VLM's patches are batch entries: the key
    holds each one's shape, so another frame or patch count misses."""
    model = build_model(scaled_config(ARCHS[arch], num_layers=2))
    opt = make_optimizer(OptimizerConfig())
    step = make_train_step(model, opt)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    state = opt.init(params)
    b = batch_for_step(model, ShapeConfig("t", 24, 2, "train"), 0, 0,
                       device="cpu")
    key = train_key(step, params, state, b)
    assert [k for k, _, _ in key.batch] == list(b)
    for name in b:
        shorter = dict(b, **{name: b[name][:1]})
        assert train_key(step, params, state, shorter) != key
