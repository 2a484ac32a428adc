"""The torch twins of the six examples (``examples/*_torch.py``) on the CPU
with ``--device cpu``, at the scripts' own sizes, each held to the check
of its JAX script: quickstart's remapped decode token-identical to the
dense one; the three-tenant engine finishing every request with a remap
and its allocator invariants; multi-turn outputs equal under
mirage+sharing, mirage and vllm; the replica fleet's printed metrics
equal to the JAX script's, line for line; the danube ring and the
distributed flash-decode (2 gloo ranks) against local decode; the loss
falling (train_100m at 2 steps of 2 x 16 tokens: its AdamW over 64M
parameters takes seconds a step on the CPU)."""
import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
sys.path.insert(0, str(EXAMPLES))
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(module: str, argv):
    """(main's result, its printout) of a twin, imported by name (the
    long-context twin's spawned ranks import it so)."""
    mod = __import__(module)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = mod.main() if argv is None else mod.main(argv)
    return res, buf.getvalue()


def test_quickstart_remap_decodes_the_dense_tokens():
    res, out = _run("quickstart_torch", CPU)
    assert res["plain"] == res["remap"] and len(res["plain"]) == 8
    assert res["freed"] * 2 == res["full"]
    assert "outputs identical" in out


def test_quickstart_runs_as_a_script():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / "quickstart_torch.py"), *CPU],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "outputs identical" in proc.stdout.splitlines()[-1]


def test_multi_tenant_serving_remaps_and_keeps_invariants():
    res, out = _run("multi_tenant_serving_torch", CPU)
    assert res["finished"] == 9
    assert "allocator invariants OK" in out
    assert "remap" in res["events"] and max(res["remap"].values()) >= 1
    assert res["transfers"].remap_drops_bytes > 0
    assert "remap state:" in out and "transfer stats:" in out


def test_multi_turn_outputs_equal_across_modes():
    res, out = _run("multi_turn_serving_torch", CPU)
    assert "output equivalence across all three configurations: OK" in out
    assert len(res["outputs"]) == 9
    assert res["saved_prefill_tokens"]["mirage+sharing"] > 0
    assert res["saved_prefill_tokens"]["vllm"] == 0


def test_multi_replica_serving_prints_the_jax_scripts_metrics():
    res, out = _run("multi_replica_serving_torch", [])
    _, ref = _run("multi_replica_serving", None)
    assert out.splitlines() == ref.splitlines()
    assert len(out.splitlines()) == 4
    assert set(res) == {"uncoordinated", "coordinated"}


def test_long_context_ring_and_flash_decode():
    res, out = _run("long_context_decode_torch", CPU)
    assert res["cache_shape"][2] == 8          # the 8-slot ring
    assert res["ring_err"] < 1e-3
    assert res["flash_decode_err"] < 1e-4
    assert "over 2 ranks" in out


def test_train_100m_loss_falls():
    res, out = _run("train_100m_torch",
                    CPU + ["--steps", "2", "--batch", "2", "--seq", "16"])
    assert len(res["losses"]) == 2
    assert res["losses"][1] < res["losses"][0]
    assert "OK: learning" in out
