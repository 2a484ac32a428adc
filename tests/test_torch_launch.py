"""The port's launch layer against the JAX package's: the serve CLI on the
CPU with the same flags as ``repro.launch.serve`` (the CLI's default
tenants, llama3-8b and h2o-danube-3-4b scaled to 4 layers) gives the same
event counts, transfer statistics, pool segments, per-request lengths and
preemptions on its own weights, and, when the JAX CLI's
``PRNGKey(seed + i)`` weights are bridged in through ``params_from_jax``,
the same tokens and the same printout line for line; and the mesh
functions' layouts are those the JAX functions build."""
import contextlib
import dataclasses
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.launch.mesh as jmesh  # noqa: E402
import repro.launch.serve as jserve  # noqa: E402
from repro.configs import get_arch, scaled_config  # noqa: E402
from repro.models import build_model  # noqa: E402

import repro_torch.launch.serve as tserve  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _main(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eng = mod.main(argv)
    return eng, buf.getvalue()


def _bridged(cfg, seed, device):
    """The JAX CLI's weights for ``cfg``: its model's init under
    ``PRNGKey(seed)`` (``seed`` is the CLI's seed plus the tenant's
    index), moved to the port."""
    jcfg = scaled_config(get_arch(cfg.name), num_layers=cfg.num_layers)
    jp = build_model(jcfg).init(jax.random.PRNGKey(seed))
    return params_from_jax(jax.tree.map(np.asarray, jp), device)


@pytest.fixture(scope="module")
def cli():
    """The JAX CLI with its default flags; the port's with --device cpu, on
    its own weights and on the JAX CLI's."""
    ref = _main(jserve, [])
    own = _main(tserve, ["--device", "cpu"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tserve, "init_params", _bridged)
        bridged = _main(tserve, ["--device", "cpu"])
    return {"jax": ref, "own": own, "bridged": bridged}


def _summary(eng):
    kinds = {}
    for _, k, _d in eng.events:
        kinds[k] = kinds.get(k, 0) + 1
    return {"events": kinds, "xfer": dataclasses.asdict(eng.xfer.stats),
            "segments": [(s.source, s.num_pages)
                         for s in eng.allocator.segments],
            "requests": [(r.rid, r.prompt_len, len(r.generated),
                          r.preemptions) for r in eng.finished],
            "steps": eng.step_idx}


@pytest.mark.parametrize("weights", ["own", "bridged"])
def test_serve_cli_runs_as_the_jax_cli(cli, weights):
    ref = _summary(cli["jax"][0])
    got = _summary(cli[weights][0])
    assert got == ref
    assert len(got["requests"]) == 8 and got["events"]["finish"] == 8


def test_serve_cli_on_bridged_weights_gives_the_jax_tokens(cli):
    ref_eng, ref_out = cli["jax"]
    eng, out = cli["bridged"]
    assert {r.rid: list(r.generated) for r in eng.finished} == \
        {r.rid: list(r.generated) for r in ref_eng.finished}
    assert out == ref_out
    assert eng.metrics().row() == ref_eng.metrics().row()


def test_serve_cli_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "4", "--max-new", "4", "--layers", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "events: {'prefill': 4" in out.stdout
    assert "metrics: " in out.stdout


def test_mesh_layouts_match_jax(monkeypatch):
    """The port's production and host layouts are the shapes and axes the
    JAX functions hand ``make_auto_mesh`` (captured, no devices made)."""
    made = []
    monkeypatch.setattr(jmesh, "make_auto_mesh",
                        lambda shape, axes: made.append((shape, axes)))
    for multi in (False, True):
        jmesh.make_production_mesh(multi_pod=multi)
        layout = tmesh.production_layout(multi_pod=multi)
        assert (layout.sizes, layout.axis_names) == made.pop()
        assert layout.size == (512 if multi else 256)
    for n in (1, 2, 3, 4, 8, 16):
        monkeypatch.setattr(jmesh.jax, "devices", lambda n=n: [None] * n)
        jmesh.make_host_mesh()
        layout = tmesh.host_layout(n)
        assert (layout.sizes, layout.axis_names) == made.pop()
