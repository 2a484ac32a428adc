"""Whole runs of tiny cells on the CPU (everything but the look for a
card): a sound run is correct; the float8 control, judged as the program
is, fails the cell's limits;
each fault a serving cell can have, planted in the timed path, makes
``correct`` false; in f32 the reference follows the program to rounding,
MoE capacity drops included."""
import sys
import types

import numpy as np
import pytest

import benchkit
from reference import lm


@pytest.mark.parametrize("workload", ["tiny-dense.open", "tiny-moe.closed"])
def test_sound_run_is_correct(monkeypatch, workload):
    rc, line, err = benchkit.run_tiny(monkeypatch, workload)
    assert rc == 0, err
    assert line["correct"] is True
    assert line["attempted"] > 5 and line["failed"] == 0
    assert set(line["metrics"]) == {
        m["name"] for m in benchkit.bench()["end_to_end"]}
    assert list(line)[-1] == "check"
    assert err.strip().splitlines()[-1].startswith("[check]")


@pytest.mark.parametrize("workload", ["tiny-dense.open", "tiny-moe.closed"])
def test_control_fails(monkeypatch, workload):
    """The reference in float8 in the program's place is judged by the
    cell's limits as the program is, and fails them; the program passes."""
    rc, line, err = benchkit.run_tiny(monkeypatch, workload, control=True)
    assert rc == 0, err
    assert line["correct"] is True and line["control_correct"] is False
    chk = line["check"]["logit_gap"]
    assert chk["value"] <= chk["limit"] < line["control"]["logit_gap"]
    assert list(line)[-1] == "check"


def test_a_control_that_passes_refuses_the_run(monkeypatch):
    """Limits the control passes separate nothing: the run exits with 4,
    says so and prints no result."""
    cells = dict(benchkit.CELLS)
    cells["tiny-moe.closed"] = benchkit.cell(
        "tiny-moe", "tiny-closed", 1,
        check={"sample_tokens": 60, "min_tokens": 10,
               "limits": {"logit_gap": 100.0, "logit_gap_mean": 100.0}})
    rc, line, err = benchkit.run_tiny(monkeypatch, "tiny-moe.closed",
                                      control=True, cells=cells)
    assert rc == 4 and line is None
    assert "control passes" in err.strip().splitlines()[-1]


def _alter_tokens(engine):
    """Every third decode step hands out each row's token plus one."""
    inner = engine._decode_tokens
    count = [0]

    def wrapped(t, tokens, plan):
        logits, choices = inner(t, tokens, plan)
        count[0] += 1
        if count[0] % 3 == 0:
            choices = (np.asarray(choices) + 1) % t.cfg.vocab_size
        return logits, choices
    engine._decode_tokens = wrapped


def _state_unchanged(engine):
    """A decode step leaves the K/V pools as they were (writes nothing)."""
    inner = engine._decode_fn

    def wrapped(t, tokens, fetch=None):
        keep = {k: t.state[k].clone() for k in ("pool_k", "pool_v")}
        out = inner(t, tokens, fetch)
        for k, v in keep.items():
            t.state[k].copy_(v)
        return out
    engine._decode_fn = wrapped


def _half_batch(engine):
    """A decode step computes the first half of its running rows and hands
    the second half the first half's tokens."""
    inner = engine._decode_tokens

    def wrapped(t, tokens, plan):
        logits, choices = inner(t, tokens, plan)
        choices = np.asarray(choices).copy()
        rows = sorted(r.slot for r in t.running() if not r.prefilling)
        h = len(rows) // 2
        choices[rows[h:2 * h]] = choices[rows[:h]]
        return logits, choices
    engine._decode_tokens = wrapped


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged,
                                   _half_batch])
@pytest.mark.parametrize("workload", ["tiny-dense.open", "tiny-moe.closed"])
def test_fault_is_caught(monkeypatch, workload, fault):
    rc, line, err = benchkit.run_tiny(monkeypatch, workload, hooks=fault)
    assert rc == 0, err
    assert line["correct"] is False, line["check"]


def test_f32_reference_follows_the_program(monkeypatch):
    """With f32 weights the program and the reference differ by rounding
    only: the dense cell, and an MoE whose decode calls drop assignments
    (capacity 3 of 8 rows), which the reference reproduces call by call."""
    dense = dict(benchkit.DENSE, dtype="float32")
    moe = dict(benchkit.MOE, dtype="float32", num_layers=3,
               moe=dict(benchkit.MOE["moe"], num_experts=16, top_k=1,
                        min_capacity=1))
    monkeypatch.setitem(benchkit.CONFIGS, "f32-dense", {"port": dense})
    monkeypatch.setitem(benchkit.CONFIGS, "f32-moe", {"port": moe})
    mix = dict(benchkit.CLOSED_MIX, clients=8)
    monkeypatch.setitem(benchkit.MIXES, "f32-closed", mix)
    cells = dict(benchkit.CELLS)
    cells["f32-dense.open"] = benchkit.cell("f32-dense", "tiny-open", 2)
    cells["f32-moe.closed"] = benchkit.cell(
        "f32-moe", "f32-closed", 1, slots=8,
        check={"sample_tokens": 60, "min_tokens": 10,
               "limits": {"logit_gap": 1e-3}})
    dropped = []
    inner = lm.kept

    def counting(*a, **k):
        keep = inner(*a, **k)
        dropped.append(int((~keep).sum()))
        return keep
    monkeypatch.setattr(lm, "kept", counting)
    for name in ("f32-dense.open", "f32-moe.closed"):
        rc, line, err = benchkit.run_tiny(monkeypatch, name, cells=cells)
        assert rc == 0, err
        assert line["check"]["logit_gap"]["value"] < 1e-4, err
    assert sum(dropped) > 0


def test_a_forbidden_module_loaded_in_the_run_refuses(monkeypatch):
    """A run in whose process a JAX module turns up exits with an error,
    names it and prints no result."""
    from harness import cli
    name = next(n for n in cli.FORBIDDEN if n not in cli.forbidden_modules())
    rc, line, err = benchkit.run_tiny(
        monkeypatch, "tiny-dense.open", hooks=lambda engine:
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name)))
    assert rc != 0 and line is None
    assert name in err.strip().splitlines()[-1]
