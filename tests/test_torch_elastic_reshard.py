"""Moving the port's train state between meshes on gloo ranks on the CPU
(the twin of ``tests/test_elastic_restore.py``): scaled llama3-8b and
scaled moonshot (MoE; 2 layers, f32) initialised on a (2, 2) world of 4
ranks and saved from the mesh write the files a one-rank save of the same
init writes, byte for byte; those checkpoints restore onto a 2-rank
world's ``host_layout(2)``
with diff 0; ``elastic_reshard`` moves the live params (2, 2) -> (4, 1)
-> (2, 2) with diff 0; Adafactor's factored statistics, saved after a step
on (2, 2), restore onto (4, 1) under ``opt_shardings``' specs equal to the
live state resharded; and ``launch.train --mesh host`` on the 4-rank world
checkpoints and resumes. Rank functions in ``tests/torch_mesh.py``."""
import filecmp
import json
import os
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).parent))
import torch_mesh as tm  # noqa: E402

from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import (  # noqa: E402
    OptimizerConfig, checkpoint, make_optimizer,
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    ckpt = str(tmp / "ckpt")
    out = str(tmp / "rank%d.json")
    spawn_ranks(tm.elastic_rank, 4, ckpt, out)
    four = [json.load(open(out % r)) for r in range(4)]
    out2 = str(tmp / "restore%d.json")
    spawn_ranks(tm.restore_rank, 2, ckpt, out2)
    two = [json.load(open(out2 % r)) for r in range(2)]
    # the one-rank saves of the same inits
    ones = {}
    for sub, c in (("adamw", tm.cfg()), ("moe", tm.moe_cfg())):
        model = build_model(c)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        state = make_optimizer(OptimizerConfig(name="adamw")).init(params)
        ones[sub] = str(tmp / "one" / sub)
        checkpoint.save(ones[sub], 0, {"params": params, "opt": state})
    return {"four": four, "two": two, "ckpt": ckpt, "one": ones}


def _same_files(runs, sub):
    mesh_dir = os.path.join(runs["ckpt"], sub, "step_00000000")
    one_dir = os.path.join(runs["one"][sub], "step_00000000")
    names = sorted(os.listdir(one_dir))
    assert names == sorted(os.listdir(mesh_dir)) and len(names) > 20
    match, mismatch, errors = filecmp.cmpfiles(one_dir, mesh_dir, names,
                                               shallow=False)
    assert mismatch == [] and errors == [] and len(match) == len(names)


def test_mesh_checkpoint_is_byte_identical_to_one_rank(runs):
    _same_files(runs, "adamw")


def test_moe_mesh_checkpoint_is_byte_identical_to_one_rank(runs):
    """Scaled moonshot: its expert leaves split over "model" and their d
    dim over "data" on the mesh."""
    _same_files(runs, "moe")


def test_restore_onto_a_smaller_world(runs):
    for res in runs["two"]:
        assert res["layout"] == [2, 1]
        assert res["params"] == 0.0 and res["opt"] == 0.0
    # the embed [512, 128] is split over "data" on its embed dim
    assert runs["two"][0]["blocks"][0] == [512, 64]


def test_moe_restore_onto_a_smaller_world(runs):
    for res in runs["two"]:
        assert res["moe_params"] == 0.0 and res["moe_opt"] == 0.0
    # moonshot's first expert leaf w_in [2, 8, 128, 64]: its d dim over
    # the 2 data ranks
    assert [2, 8, 64, 64] in runs["two"][0]["moe_blocks"]


@pytest.mark.parametrize("key", ["reshard_41", "reshard_back"])
def test_elastic_reshard_live(runs, key):
    for res in runs["four"]:
        assert res[key] == 0.0
    # (4, 1): the embed's embed dim over 4 data ranks, its vocab whole
    assert runs["four"][0]["shapes_41"][0] == [512, 32]


def test_adafactor_statistics_restore_onto_opt_shardings(runs):
    for res in runs["four"]:
        assert res["restore_ada_41"] == 0.0
    res = runs["four"][0]
    # vr of the embed [512, 128] drops the embed dim: [512] over nothing
    # on (4, 1); wq [2, 128, 4, 32] on (2, 2): vr [2, 128, 4] keeps
    # (data, model) on its dims 1 and 2, vc [2, 128, 32] keeps "data"
    assert res["ada_embed_vr"] == [[512], []]
    assert res["ada_wq"] == {"vr": [[2, 64, 2], [None, "data", "model"]],
                             "vc": [[2, 64, 32], [None, "data"]]}


def test_launcher_trains_and_resumes_on_the_host_mesh(runs):
    outs = [res["cli_out"] for res in runs["four"]]
    assert "resuming from step 2" in outs[0] and "'step': 3" in outs[0]
    assert all(o == "" for o in outs[1:])           # only rank 0 prints
    assert checkpoint.latest_step(os.path.join(runs["ckpt"], "cli")) == 4
