"""Import hygiene of the port: importing any module of ``repro_torch``,
``chip_smoke.py`` or a torch twin of the examples (``examples/*_torch.py``)
loads neither JAX nor anything of the ``repro`` package. Each subprocess
starts from a different entry module, so an import cycle that only one
import order reaches shows up too. The twins' own imports are torch, the
port and the standard library."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FIRST = ["repro_torch.kernels", "repro_torch.models", "repro_torch.core",
         "repro_torch.serving", "repro_torch.configs", "repro_torch.cluster",
         "repro_torch.training", "repro_torch.distributed",
         "repro_torch.distributed.sharding",
         "repro_torch.distributed.analytic_cost",
         "repro_torch.distributed.collectives",
         "repro_torch.distributed.fault_tolerance",
         "repro_torch.distributed.hlo_analysis",
         "repro_torch.launch.shardings",
         "repro_torch.models.attention_ops", "repro_torch.models.blocks",
         "repro_torch.serving.perf_model", "repro_torch.launch",
         "repro_torch.launch.mesh", "repro_torch.launch.serve",
         "repro_torch.launch.train", "repro_torch.launch.dryrun",
         "repro_torch.training.train_graph",
         "repro_torch.serving.prefill_graph",
         "repro_torch.models.slstm_graph", "chip_smoke"]
TWINS = sorted(p.stem for p in (ROOT / "examples").glob("*_torch.py"))

PROBE = """
import importlib, pkgutil, sys
import {first}
import repro_torch
import chip_smoke
for m in {twins}:
    importlib.import_module(m)
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("IMPORTED", len([m for m in sys.modules if m.startswith("repro_torch")]))
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT), str(ROOT / "examples")]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", PROBE.format(first=first, twins=TWINS)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
        for first in FIRST + TWINS]
    for first, p in zip(FIRST + TWINS, procs):
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"starting from {first}:\n{out}"
        assert "IMPORTED" in out


def test_example_twins_import_only_torch_and_the_port():
    """Each of the six twins imports torch, ``repro_torch`` and the
    standard library, and nothing else."""
    assert TWINS == sorted(p.stem + "_torch" for p in
                           (ROOT / "examples").glob("*.py")
                           if not p.stem.endswith("_torch"))
    assert len(TWINS) == 6
    for name in TWINS:
        tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)}
        tops = {m.split(".")[0] for m in mods}
        assert tops <= {"torch", "repro_torch"} | set(
            sys.stdlib_module_names), (name, tops)
        assert {"torch", "repro_torch"} & tops, name
