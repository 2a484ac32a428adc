"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: the
rank's argument bytes of five train cells on both production meshes
against the reference's shard bytes (a JAX subprocess on 512 forced host
devices, ``abstract_params``, ``opt_shardings``, ``abstract_inputs`` and
``shard_shape``, no compile); the collectives of a dry-run step on a fake
(2, 2) group against those of the same step on 4 real gloo ranks;
``benchmarks/roofline.py`` reading a port artifact unedited; serving
cells on the fake world (decode at the remap tiers, the cross-K/V remap,
long_500k, prefill) with their argument bytes and ``mirage`` extras
against the reference's shard bytes; two ``head-tp`` cells (head_dim over
"model") with their argument bytes against the reference's under its
rules; and the reference's byte rule of a reduce-scatter."""
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
# (mesh, arch, shape, remap tier) of the serving cells run on the fake
# world: llama3-8b's decode at tiers 0 and 0.25 (the layers' remap),
# whisper's cross-K/V remap, a long_500k cell (one row: the cache's
# sequence over every axis) and a prefill cell
SERVE_CELLS = (("single_pod", "llama3-8b", "decode_32k", 0.0),
               ("single_pod", "llama3-8b", "decode_32k", 0.25),
               ("multi_pod", "llama3-8b", "decode_32k", 0.25),
               ("single_pod", "whisper-medium", "decode_32k", 0.25),
               ("single_pod", "h2o-danube-3-4b", "long_500k", 0.0),
               ("multi_pod", "h2o-danube-3-4b", "long_500k", 0.0),
               ("single_pod", "llama3-8b", "prefill_32k", 0.0))

# (mesh, arch, shape) of the head-tp cells (the reference's rules of
# ``--profile head-tp``): xlstm's (head_dim over "model", the mLSTM and
# sLSTM states whole) and llama's (its 8 KV heads do not split 16 ways:
# wk/wv split head_dim)
HEAD_TP_CELLS = (("single_pod", "xlstm-1.3b", "decode_32k"),
                 ("single_pod", "llama3-8b", "decode_32k"))

JAX_BYTES = r"""
import json, sys, warnings
import numpy as np
import jax
from repro.configs import SHAPES_BY_NAME, get_arch
from repro.distributed.sharding import (
    DEFAULT_RULES, ShardingRules, mesh_context)
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

# _lower_remap_decode's plan and stacks, their bytes a device
def remap_bytes(model, mesh, tier):
    from repro.core import make_plan
    from repro.distributed.sharding import sharding_for
    from repro.models.common import is_spec
    r = model.repeats
    alpha = max(int(round(tier * r)), 1)
    plan = make_plan(r, alpha, t_c=1.0, t_t=1e-9, double_buffer=True)

    def stack(n):
        total = 0
        for sp in jax.tree.leaves(model.specs()["blocks"], is_leaf=is_spec):
            shp = (n,) + sp.shape[1:]
            sh = sharding_for(sp.logical, shp, mesh, DEFAULT_RULES)
            total += int(np.prod(sh.shard_shape(shp))) * \
                np.dtype(sp.dtype).itemsize
        return total
    return {"alpha": alpha, "m": plan.m,
            "cycle_bytes_per_device": stack(len(plan.cycle_layers)),
            "resident_bytes_per_device": stack(len(plan.resident_layers))}

out = {}
HEAD_TP = ShardingRules.make(profile="serving", head_dim=("model",),
                             heads=())
cells = [c + [DEFAULT_RULES] for c in json.loads(sys.argv[2])] + [
    c + [0.0, HEAD_TP] for c in json.loads(sys.argv[3])]
for mesh_name, arch, shape_name, tier, rules in cells:
    mesh = make_production_mesh(multi_pod=mesh_name == "multi_pod")
    model = build_model(get_arch(arch))
    shape = SHAPES_BY_NAME[shape_name]
    with mesh_context(mesh, rules):
        rec = {"params": rank_bytes(model.abstract_params(mesh, rules))}
        if shape.kind == "prefill":
            rec["inputs"] = rank_bytes(model.abstract_inputs(
                shape, mesh, rules))
        else:
            state = model.abstract_decode_state(
                shape.global_batch, shape.seq_len, mesh, rules)
            rec["state"] = rank_bytes(state)
            rec["inputs"] = rec["state"] + rank_bytes(
                model.abstract_inputs(shape, mesh, rules))
            if tier and model.cfg.is_encoder_decoder:
                cross = rank_bytes(state["blocks"][0]["mixer"]["cross"])
                rec["mirage"] = {"cross_kv_host_bytes_per_device": cross,
                                 "alpha": 0, "m": 0,
                                 "cycle_bytes_per_device": cross,
                                 "resident_bytes_per_device": 0}
            elif tier:
                rec["mirage"] = remap_bytes(model, mesh, tier)
    tag = "head-tp" if rules is HEAD_TP else f"{tier:g}"
    out[f"{mesh_name}/{arch}/{shape_name}/{tag}"] = rec
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
        [sys.executable, "-c", JAX_BYTES, ",".join(ARCH_CELLS),
         json.dumps(SERVE_CELLS), json.dumps(HEAD_TP_CELLS)], env=env,
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


@pytest.mark.parametrize("cell", SERVE_CELLS,
                         ids=["/".join(map(str, c)) for c in SERVE_CELLS])
def test_serving_cell_bytes_are_the_references(reference_bytes, cell,
                                               tmp_path, capsys):
    """A serving cell through ``main`` on the fake world prints OK; its
    argument bytes are the reference's shard bytes of the params and the
    inputs (a decode cell's: the decode state and the tokens); a remap
    cell's ``mirage`` extras are the reference's: the plan's alpha and m,
    the bytes a device of the cycle and resident stacks, or the cross
    K/V's. The port's enc-dec state also holds ``src_len`` ([B] int32,
    the rank's rows), which the reference's decode state spec lacks
    (ROADMAP queue 3); it adds the rank's rows x 4 bytes."""
    mesh_name, arch, shape_name, tier = cell
    argv = ["--arch", arch, "--shape", shape_name, "--mesh", mesh_name,
            "--out-dir", str(tmp_path)]
    if tier:
        argv += ["--remap-tier", str(tier)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert dryrun.main(argv) == 0
    assert "1 ok, 0 failed" in capsys.readouterr().out
    tag = dryrun.cell_tag(arch, shape_name, remap_tier=tier)
    rec = json.loads((tmp_path / mesh_name / (tag + ".json")).read_text())
    ref = reference_bytes[f"{mesh_name}/{arch}/{shape_name}/{tier:g}"]
    shape = SHAPES_BY_NAME[shape_name]
    extra = 0
    if ARCHS[arch].is_encoder_decoder and shape.kind == "decode":
        layout = production_layout(multi_pod=mesh_name == "multi_pod")
        extra = 4 * shape.global_batch // layout.shape["data"] // (
            layout.shape.get("pod", 1))
    assert rec["memory"]["argument_bytes"] == \
        ref["params"] + ref["inputs"] + extra
    assert rec.get("mirage") == ref.get("mirage")
    assert rec["memory"]["output_bytes"] > 0 and rec["memory"][
        "temp_bytes"] > 0 and rec["cost_analysis_raw"]["flops"] > 0
    # the decode state is updated in place: the reference's donated
    # argument (its cross-K/V cell donates nothing)
    donated = shape.kind == "decode" and not (
        tier and ARCHS[arch].is_encoder_decoder)
    assert rec["memory"]["alias_bytes"] == (ref["state"] if donated else 0)
    assert rec["collectives"]["total_bytes"] > 0


@pytest.mark.parametrize("cell", HEAD_TP_CELLS,
                         ids=["/".join(c) for c in HEAD_TP_CELLS])
def test_head_tp_cell_bytes_are_the_references(reference_bytes, cell,
                                               tmp_path, capsys):
    """A ``--profile head-tp`` cell through ``main`` prints OK and no
    WAIT; its argument bytes (the params, the decode state and the tokens)
    are the reference's shard bytes under the head-tp rules, and the
    decode state is updated in place."""
    mesh_name, arch, shape_name = cell
    argv = ["--arch", arch, "--shape", shape_name, "--mesh", mesh_name,
            "--profile", "head-tp", "--out-dir", str(tmp_path)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert dryrun.main(argv) == 0
    out = capsys.readouterr().out
    assert "OK" in out and "WAIT" not in out and "1 ok, 0 failed" in out
    tag = dryrun.cell_tag(arch, shape_name, profile="head-tp")
    rec = json.loads((tmp_path / mesh_name / (tag + ".json")).read_text())
    ref = reference_bytes[f"{mesh_name}/{arch}/{shape_name}/head-tp"]
    assert rec["profile"] == "head-tp"
    assert rec["memory"]["argument_bytes"] == ref["params"] + ref["inputs"]
    assert rec["memory"]["alias_bytes"] == ref["state"]
    assert rec["collectives"]["total_bytes"] > 0


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
