"""The compiled training step on a CUDA device (skipped elsewhere): from one
start state, 3 steps through ``compile_train_step`` against 3 eager steps
(``make_train_step``). The losses, grad norms, every parameter leaf and
every optimizer moment must be bitwise equal to the eager run's
(``chip_smoke.differences``, which phase 14 (e) holds them to). Covered:
every
stack at a scaled width in bf16 (dense llama, MoE moonshot, jamba's Mamba
hybrid, xLSTM, whisper's enc-dec, llava's VLM), AdamW and Adafactor with 1
and 2 microbatches under each remat policy, a crash and a resume through
graphs (the restore captures again), a batch of another shape, a capture
that fails (it raises), and a dropped step freeing its memory pool by
reference count. Imports neither JAX nor ``repro``:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_graph_gpu.py
"""
import dataclasses
import gc
import sys
import weakref
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import ARCHS, scaled_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import TrainRunner  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.training import (  # noqa: E402
    OptimizerConfig, batch_for_step, checkpoint, make_optimizer,
    make_train_step,
)
from repro_torch.training import train_graph  # noqa: E402

pytestmark = pytest.mark.gpu

# scaled depth per stack: jamba's and xlstm's 8-layer patterns hold their
# attention / sLSTM layer
STACKS = {"llama3-8b": 2, "moonshot-v1-16b-a3b": 2, "jamba-v0.1-52b": 8,
          "xlstm-1.3b": 8, "whisper-medium": 2, "llava-next-34b": 2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the compiled step is a CUDA graph)")
    return torch.device("cuda")


def _setup(arch="llama3-8b", layers=2, optimizer="adamw",
           remat="dots_saveable", microbatches=1, seq=32):
    """(eager step, start state maker, batches of ``seq`` tokens by step)."""
    cfg = dataclasses.replace(scaled_config(ARCHS[arch], num_layers=layers),
                              dtype="bfloat16")
    model = build_model(cfg)
    opt = make_optimizer(OptimizerConfig(name=optimizer, learning_rate=1e-2,
                                         warmup_steps=2))
    step = make_train_step(model, opt, remat_policy=remat,
                           microbatches=microbatches)

    def start():
        params = model.init(torch.Generator(device="cuda").manual_seed(4),
                            "cuda")
        return params, opt.init(params)

    def batch(s, seq=seq):
        return batch_for_step(model, ShapeConfig("t", seq, 2, "train"), 7, s,
                              device="cuda")
    return step, start, batch


def _run(step, state, batches):
    """(losses and grad norms, the last state's leaves): the quantities of
    ``chip_smoke.differences``."""
    params, opt_state = state
    nums = []
    for b in batches:
        params, opt_state, m = step(params, opt_state, b)
        nums += [m["loss"].item(), m["grad_norm"].item()]
    torch.cuda.synchronize()
    return nums, tree_leaves((params, opt_state))


def _hold(graph, eager):
    """The graph run bitwise equal to the eager run in every quantity."""
    diffs = chip_smoke.differences(graph, eager)
    assert not diffs, f"{len(diffs)} quantities differ: {diffs}"


def _two_runs(step, start, batches):
    """The eager run and the graph run from one start state; the graph's
    kernel launches (recorded at capture, added per replay) equal the eager
    run's."""
    kernels.reset_launch_counts()
    eager = _run(step, start(), batches)
    counts = kernels.launch_counts()
    compiled = train_graph.compile_train_step(step)
    state = start()
    counter = state[1]["step"]
    kernels.reset_launch_counts()
    graph = _run(compiled, state, batches)
    assert kernels.launch_counts() == counts
    assert state[1]["step"] is counter and int(counter) == len(batches)
    assert (compiled.stats.captures, compiled.stats.replays) == \
        (1, len(batches) - 1)
    return graph, eager


@pytest.mark.parametrize("arch", sorted(STACKS))
def test_every_stack_graph_matches_eager(cuda, arch):
    step, start, batch = _setup(arch, STACKS[arch])
    _hold(*_two_runs(step, start, [batch(s) for s in range(3)]))


@pytest.mark.parametrize("optimizer,microbatches,remat", [
    ("adamw", 1, "none"), ("adamw", 1, "full"), ("adamw", 2, "dots_saveable"),
    ("adafactor", 1, "dots_saveable"), ("adafactor", 2, "full"),
    ("adafactor", 2, "none")])
def test_optimizers_microbatches_and_remat(cuda, optimizer, microbatches,
                                           remat):
    step, start, batch = _setup(optimizer=optimizer, remat=remat,
                                microbatches=microbatches)
    _hold(*_two_runs(step, start, [batch(s) for s in range(3)]))


def test_crash_and_resume_through_graphs(cuda, tmp_path):
    """A crash at step 5 (checkpoints at 2 and 4) and a resume from step 4
    through the same compiled step, which captures again on the restored
    state and drops the old graph, against 8 uninterrupted steps through
    graphs."""
    step, start, batch = _setup(remat="full")

    def runner(name, compiled):
        return TrainRunner(compiled, batch, str(tmp_path / name),
                           ckpt_every=2)

    def nums(log):
        return [m[k] for m in log for k in ("loss", "grad_norm")]
    r = runner("ref", train_graph.compile_train_step(step))
    state = r.run(*start(), num_steps=8)
    ref = (nums(r.metrics_log), tree_leaves(state))
    compiled = train_graph.compile_train_step(step)
    r = runner("crash", compiled)
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        r.run(*start(), num_steps=8, fail_at=5)
    assert checkpoint.latest_step(str(tmp_path / "crash")) == 4
    state = r.resume(*start(), num_steps=8)
    assert (compiled.stats.captures, compiled.stats.dropped) == (2, 1)
    assert len(compiled.graphs) == 1
    resumed = nums(r.metrics_log[:4] + r.metrics_log[5:])
    assert len(resumed) == 16
    _hold((resumed, tree_leaves(state)), ref)


def test_another_batch_shape_captures_again(cuda):
    step, start, batch = _setup()
    compiled = train_graph.compile_train_step(step)
    params, state = start()
    for seq in (32, 16, 32, 16):
        params, state, m = compiled(params, state, batch(0, seq=seq))
        assert torch.isfinite(m["loss"])
    assert (compiled.stats.captures, compiled.stats.replays,
            compiled.stats.dropped) == (2, 2, 0)


def test_a_failed_capture_raises(cuda, monkeypatch):
    """A step that waits for the device (``.item()``) cannot be captured:
    the compiled step raises after its warm-up (that call's one eager
    step), and runs nothing eagerly in the capture's place."""
    step, start, batch = _setup()
    calls = []

    def syncing(p, s, b):
        calls.append(1)
        p, s, m = step(p, s, b)
        m["loss"].item()
        return p, s, m
    for k in ("microbatches", "remat_policy", "mesh"):
        setattr(syncing, k, getattr(step, k))
    compiled = train_graph.compile_train_step(syncing)
    params, state = start()
    with pytest.raises(RuntimeError, match="train graph capture failed"):
        compiled(params, state, batch(0))
    torch.cuda.synchronize()
    assert len(calls) == 2 and int(state["step"]) == 1   # warm-up, capture
    assert compiled.stats.captures == 0 and not compiled.graphs


def test_dropping_the_step_frees_its_pool(cuda):
    """The compiled step and its graphs hold no reference cycle: dropped
    with the collector off, the graph goes at once and its pool's bytes
    return to the device."""
    step, start, batch = _setup()
    params, state = start()
    gc.collect()
    gc.disable()
    try:
        compiled = train_graph.compile_train_step(step)
        for s in range(2):
            params, state, _ = compiled(params, state, batch(s))
        torch.cuda.synchronize()
        pool = compiled.stats.pool_bytes
        graph = weakref.ref(next(iter(compiled.graphs.values())))
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved()
        del compiled
        torch.cuda.empty_cache()
        assert graph() is None
        assert pool > 0 and held - torch.cuda.memory_reserved() >= pool
    finally:
        gc.enable()


def test_launcher_compiles_the_step_on_the_card(cuda, capsys):
    launch_train.main(["--scaled", "--fixed-batch", "--layers", "2",
                       "--steps", "12", "--batch", "2", "--seq", "32"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "train step: compiled (a CUDA graph, replayed)"
    losses = [float(line.split()[3]) for line in lines
              if line.startswith("step")]
    assert losses[-1] < 0.5 * losses[0], losses
