"""Each cell on the card: a short window ends with 0, its result line is
correct and carries the cell's end-to-end metrics; and at the cell's own
size, load and window, on three seeds, the float8 control fails the limits
committed in the cell's file while the program passes them. Skips where
there is no card."""
import json
import os
import subprocess
import sys

import pytest

import benchkit
from harness import registry


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")


@pytest.mark.gpu
@pytest.mark.parametrize("w", registry.benchmark()["workloads"],
                         ids=lambda w: w["name"])
def test_cell_on_the_card(w):
    _card()
    line = _run(w["name"], 2147483659, 8)
    assert line["correct"] is True, line["check"]
    assert set(line["metrics"]) == {
        m["name"] for m in registry.metrics_of(w["name"], False)}


def _run(workload, seed, seconds, *extra):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", workload, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", "0", *extra],
        cwd=benchkit.ROOT, capture_output=True, text=True, timeout=900,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    # exit 4: the control passed the cell's limits
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2147483671, 2147483693, 4294967311])
@pytest.mark.parametrize("w", registry.benchmark()["workloads"],
                         ids=lambda w: w["name"])
def test_control_fails_the_committed_limits(w, seed):
    _card()
    line = _run(w["name"], seed, registry.benchmark()["run_seconds"],
                "--control", "1")
    assert line["correct"] is True, line["check"]
    assert line["control_correct"] is False, line["control"]
    limits = registry.cell(w["name"])["check"]["limits"]
    assert any(line["control"][k] > lim for k, lim in limits.items())
