"""chip_smoke.py's phases 20 (the examples' twins) and 21 (the head-tp
rules on a (2, 2) mesh of gloo ranks) rehearsed on the CPU at a small size
with the kernels' plain versions, and their configurations. A file of its
own beside ``tests/test_torch_chip_smoke.py``, so that the suite's workers
share the rehearsals."""
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.configs import ARCHS, scaled_config  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def head_tp_on_cpu(monkeypatch):
    """Phase 21 at a small width on the CPU: the scaled xlstm at 8 layers
    (head_dim 32: 16 a rank), f32, 2 x 32 prompt tokens, a 64-token
    context."""
    cfg = scaled_config(ARCHS["xlstm-1.3b"], num_layers=8)
    for name, value in (("DEVICE", "cpu"), ("HEADTP_CFG", cfg),
                        ("HEADTP_PROMPT", 32), ("HEADTP_CONTEXT", 64)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_head_tp_phase_runs(head_tp_on_cpu, capsys):
    """Phase 21 on 4 gloo ranks on the CPU: the rank's wq block splits
    head_dim, the logits and every greedy token against one rank's, the
    train step's loss and updates, and the head_dim collectives (q/k
    gathered, sLSTM's recurrent sums reduce-scattered)."""
    counts = chip_smoke.phase_head_tp()
    assert counts["ssd_scan"] == 0                 # the plain versions
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if "logits row_err" in x)
    assert "wq block [1, 128, 4, 16]" in line
    assert "equal to one rank's at 4 of 4 steps" in line
    assert float(line.split("worst ")[1].split()[0]) <= \
        chip_smoke.ROW_RTOL[torch.float32]
    step = next(x for x in out.splitlines() if "one AdamW step" in x)
    assert float(step.split("update error ")[1].split()[0]) <= 1e-3
    prefill = next(x for x in out.splitlines()
                   if "collectives of rank 0's prefill" in x)
    for kind in ("head_dim_all_gather", "slstm_rec_reduce_scatter",
                 "state_head_dim_all_gather"):
        assert kind in prefill


def test_head_tp_phase_sees_a_wrong_recurrence(head_tp_on_cpu,
                                               monkeypatch):
    """A head-tp sLSTM whose recurrent partial sums are not reduced fails
    the phase (the spawned ranks import the patched module afresh, so the
    fault sits in the one-rank reference: its sLSTM drops the recurrent
    product, which the mesh's keeps)."""
    from repro_torch.models.blocks import SLSTM
    cell = SLSTM._cell
    monkeypatch.setattr(SLSTM, "_cell", staticmethod(
        lambda p, wx, state, rec_sum=None: cell(dict(p, r=p["r"] * 0), wx,
                                                state, rec_sum)))
    with pytest.raises(SystemExit, match="head-tp"):
        chip_smoke.phase_head_tp()


def test_head_tp_phase_is_xlstm_cut_in_depth():
    """Phase 21 runs xlstm-1.3b at full width, 8 of its 48 layers (its
    sLSTM at layer 7), on phase 16's (2, 2) mesh under the dry run's
    head-tp rules: each rank holds head_dim blocks of 256 of every head."""
    from repro_torch.distributed.sharding import MeshLayout, spec_for
    from repro_torch.launch.dryrun import profile_rules
    from repro_torch.models.blocks import MLSTM
    from repro_torch.models.lm import block_pattern
    cfg = chip_smoke.HEADTP_CFG
    full = ARCHS["xlstm-1.3b"]
    assert dataclasses.replace(cfg, num_layers=full.num_layers) == full
    pattern, _ = block_pattern(cfg)
    assert [ld.mixer for ld in pattern] == ["mlstm"] * 7 + ["slstm"]
    mesh = MeshLayout(("data", "model"), chip_smoke.MESH_LAYOUT)
    spec = spec_for(MLSTM().specs(cfg)["wq"].logical, (2048, 4, 512), mesh,
                    profile_rules("head-tp"))
    assert spec == (None, None, "model")
    assert 512 // chip_smoke.MESH_LAYOUT[1] == 256


@pytest.fixture
def examples_on_cpu(monkeypatch):
    """Phase 20 on the CPU with two of its twins (the others run in
    tests/test_torch_examples.py)."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TWINS", (
        ("quickstart_torch", [], True),
        ("multi_replica_serving_torch", [], False)))


def test_examples_phase_runs(examples_on_cpu, capsys):
    counts = chip_smoke.phase_examples()
    assert sum(counts.values()) == 0               # the plain versions
    out = capsys.readouterr().out
    assert "[examples] quickstart_torch --device cpu: its check held" in out
    assert "[examples] multi_replica_serving_torch : its check held" in out


def test_examples_phase_fails_with_a_twin(examples_on_cpu, monkeypatch):
    """A twin whose check fails fails the phase."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    import quickstart_torch
    monkeypatch.setattr(quickstart_torch, "STEPS", 0)
    monkeypatch.setattr(quickstart_torch, "make_plan",
                        lambda **kw: (_ for _ in ()).throw(
                            AssertionError("remapping must never change")))
    with pytest.raises(SystemExit, match="quickstart_torch"):
        chip_smoke.phase_examples()


def test_examples_phase_runs_every_twin():
    """Phase 20's twins are the six ``examples/*_torch.py``."""
    root = Path(__file__).resolve().parents[1] / "examples"
    assert sorted(t[0] for t in chip_smoke.TWINS) == sorted(
        p.stem for p in root.glob("*_torch.py"))
    assert len(chip_smoke.TWINS) == 6
