"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: the
rank's argument bytes of five train cells on both production meshes
against the reference's shard bytes (a JAX subprocess on 512 forced host
devices, ``abstract_params``, ``opt_shardings``, ``abstract_inputs`` and
``shard_shape``, no compile); the collectives of a dry-run step on a fake
(2, 2) group against those of the same step on 4 real gloo ranks;
``benchmarks/roofline.py`` reading a port artifact unedited; the serving
cells' refusal; and the reference's byte rule of a reduce-scatter."""
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

sys.path.insert(0, str(Path(__file__).parent))
import torch_mesh as tm  # noqa: E402
import torch_mesh_encdec_vlm as ev  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES_BY_NAME  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed.sharding import MeshLayout  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_mesh, production_layout, spawn_ranks,
)
from repro_torch.models import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH_CELLS = ("llama3-8b", "moonshot-v1-16b-a3b", "whisper-medium",
              "llava-next-34b", "xlstm-1.3b")
MESHES = ("single_pod", "multi_pod")

JAX_BYTES = r"""
import json, sys, warnings
import numpy as np
import jax
from repro.configs import SHAPES_BY_NAME, get_arch
from repro.distributed.sharding import DEFAULT_RULES, mesh_context
from repro.launch.dryrun import pick_optimizer
from repro.launch.mesh import make_production_mesh
from repro.launch.shardings import opt_shardings
from repro.models import build_model
from repro.training import OptimizerConfig, make_optimizer
warnings.simplefilter("ignore")
assert len(jax.devices()) == 512, len(jax.devices())

def rank_bytes(tree, shardings=None):
    leaves = jax.tree.leaves(tree)
    shs = (jax.tree.leaves(shardings) if shardings is not None
           else [a.sharding for a in leaves])
    return sum(int(np.prod(sh.shard_shape(a.shape))) * a.dtype.itemsize
               for a, sh in zip(leaves, shs))

out = {}
shape = SHAPES_BY_NAME["train_4k"]
for mesh_name in ("single_pod", "multi_pod"):
    mesh = make_production_mesh(multi_pod=mesh_name == "multi_pod")
    for arch in sys.argv[1].split(","):
        cfg = get_arch(arch)
        model = build_model(cfg)
        with mesh_context(mesh, DEFAULT_RULES):
            params = model.abstract_params(mesh, DEFAULT_RULES)
            opt = make_optimizer(OptimizerConfig(name=pick_optimizer(cfg)))
            opt_abs = jax.eval_shape(opt.init, params)
            o_sh = opt_shardings(opt_abs, model.param_shardings(
                mesh, DEFAULT_RULES), mesh)
            batch = model.abstract_inputs(shape, mesh, DEFAULT_RULES)
            out[f"{mesh_name}/{arch}"] = {
                "params": rank_bytes(params),
                "opt": rank_bytes(opt_abs, o_sh),
                "batch": rank_bytes(batch)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_bytes():
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", JAX_BYTES, ",".join(ARCH_CELLS)], env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_CELLS)
def test_argument_bytes_are_the_references_shard_bytes(reference_bytes,
                                                       arch, mesh_name):
    """The rank's params, optimizer state and batch on the production
    mesh, byte for byte the reference's (the layout alone: no world)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    model = build_model(ARCHS[arch])
    layout = production_layout(multi_pod=mesh_name == "multi_pod")
    with warnings.catch_warnings(), FakeTensorMode():
        warnings.simplefilter("ignore", RuntimeWarning)
        params, _, state, _, batch = dryrun.abstract_state(
            model, SHAPES_BY_NAME["train_4k"], layout)
        got = {"params": dryrun._nbytes(params),
               "opt": dryrun._nbytes(state),
               "batch": dryrun._nbytes(batch)}
    assert got == reference_bytes[f"{mesh_name}/{arch}"]


# the dry run's defaults on (2, 2): remat "full"; llama at 2 microbatches
DRY_CELLS = (
    ("llama", tm.cfg(), ShapeConfig("t", 16, 4, "train"), 2),
    ("whisper", ev.cfg("whisper"), ShapeConfig("t", 64, 2, "train"), 1))


@pytest.fixture(scope="module")
def dry_2x2():
    """{name: the dry run's record} of each cell of ``DRY_CELLS`` as rank
    0 of a fake (2, 2) world."""
    out = {}
    with warnings.catch_warnings(), dryrun.fake_world(4):
        warnings.simplefilter("ignore")
        mesh = make_mesh(MeshLayout(tm.AXES, (2, 2)), "cpu")
        for name, c, shape, mb in DRY_CELLS:
            rec, model, shape = dryrun.lower_cell(c, shape, mesh,
                                                  microbatches=mb)
            out[name] = dryrun.analyze(rec, model, shape, mesh)
    return out


def test_collectives_equal_a_real_step(dry_2x2, tmp_path):
    """Each op's calls and result bytes of the dry-run step on the fake
    group equal those of the same step (same cell, microbatches and
    remat) on 4 gloo ranks, and every kind the real step counts is one of
    them; whisper's frames are gathered."""
    out = str(tmp_path / "real.json")
    spawn_ranks(ev.step_stats_rank, 4, DRY_CELLS, out)
    with open(out) as f:
        real = json.load(f)
    for name, rec in dry_2x2.items():
        got = rec["collectives"]
        assert got["bytes_by_op"] == real[name]["bytes_by_op"], name
        assert got["count_by_op"] == real[name]["count_by_op"], name
        assert got["total_bytes"] == sum(real[name]["bytes_by_op"].values())
        assert set(got["count_by_op"]) == {"all-reduce", "all-gather",
                                           "reduce-scatter"}
    assert "frames_all_gather" in real["whisper"]["kinds"]


def test_record_schema(dry_2x2):
    """The reference's keys; the argument bytes hold the aliased state and
    the batch; the step allocated memory and counted FLOPs."""
    rec = dry_2x2["whisper"]
    assert rec["lowering"] == "torch-fake-cpu"
    m = rec["memory"]
    assert set(m) == {"argument_bytes", "output_bytes", "temp_bytes",
                      "alias_bytes", "code_bytes", "host_argument_bytes",
                      "host_temp_bytes"}
    assert m["argument_bytes"] > m["alias_bytes"] > 0 and m["temp_bytes"] > 0
    assert rec["cost_analysis_raw"]["flops"] > 0
    assert rec["mesh"] == {"shape": {"data": 2, "model": 2}, "devices": 4}
    assert rec["analytic"]["total_flops"] > 0


def test_roofline_reads_a_port_artifact(dry_2x2, tmp_path):
    """``benchmarks.roofline`` reads a record the port wrote, unedited:
    scaled llama's record at (2, 2), named as its published config's cell
    (the reader recomputes the analytic cost from the names)."""
    from benchmarks import roofline
    rec = dict(dry_2x2["llama"], arch="llama3-8b", shape="train_4k",
               mesh_name="single_pod", remap_tier=0.0, remat_policy="full",
               profile="train")
    (tmp_path / "single_pod").mkdir()
    path = tmp_path / "single_pod" / (dryrun.cell_tag("llama3-8b",
                                                      "train_4k") + ".json")
    path.write_text(json.dumps(rec))
    recs = roofline.load_records("single_pod", art_dir=str(tmp_path))
    assert len(recs) == 1
    t = roofline.terms(recs[0])
    assert t["collective_s"] == rec["collectives"]["total_bytes"] / \
        roofline.LINK_BW
    assert "llama3-8b" in roofline.table(recs)


@pytest.mark.parametrize("shape,tier", [("prefill_32k", 0.0),
                                        ("decode_32k", 0.0),
                                        ("decode_32k", 0.25)])
def test_serving_cells_wait_for_9d(shape, tier, tmp_path, capsys):
    with pytest.raises(NotImplementedError, match="9d"):
        dryrun.lower_cell("llama3-8b", shape, None, remap_tier=tier)
    argv = ["--arch", "llama3-8b", "--shape", shape, "--mesh",
            "single_pod", "--out-dir", str(tmp_path)]
    if tier:
        argv += ["--remap-tier", str(tier)]
    assert dryrun.main(argv) == 0
    out = capsys.readouterr().out
    assert "WAIT" in out and "9d" in out and "0 ok, 1 wait, 0 failed" in out


def test_reduce_scatter_counts_its_result_bytes():
    """An [8, 4] f32 reduce-scatter over 2 ranks counts its rank's block,
    64 bytes, by op; its kind keeps counting the full input, 128."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.hlo_analysis import collective_stats
    with dryrun.fake_world(2):
        mesh = make_mesh(MeshLayout(("model",), (2,)), "cpu")
        collectives.reset_counts()
        out = collectives.reduce_scatter_dim(
            torch.ones(8, 4), mesh.get_group("model"), 0, "t")
        assert out.shape == (4, 4)
        stats = collective_stats()
        assert stats.bytes_by_op == {"reduce-scatter": 64}
        assert stats.count_by_op == {"reduce-scatter": 1}
        assert collectives.counts() == {"t": {"calls": 1, "bytes": 128}}
