"""What the harness and the reference import, in a fresh interpreter: no
module whose top-level name (the part before the first dot) is ``jax``,
``jaxlib``, ``flax`` or ``repro``; and the reference nothing of the
port."""
import json
import os
import subprocess
import sys

import benchkit

PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {src!r}]
import {mods}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(mods):
    code = PROBE.format(bench=benchkit.BENCH,
                        src=os.path.join(benchkit.ROOT, "src"),
                        mods=", ".join(mods))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(["harness.cli", "harness.check", "harness.serve",
                        "harness.trace", "harness.registry",
                        "repro_torch.serving"])
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    names = _top_level(["reference.lm"])
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch",
                        "harness"}


def test_run_refuses_without_the_repository(tmp_path):
    """A directory with only BENCHMARK.json and bench/ (no src/) exits with
    an error and prints no result."""
    import shutil
    shutil.copytree(benchkit.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(benchkit.ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "granite-3-8b.two-tenant.sharegpt", "--seed", "1", "--seconds",
         "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
