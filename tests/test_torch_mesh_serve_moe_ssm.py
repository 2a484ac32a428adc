"""The port's MoE, Mamba and xLSTM configs served over a (data, model)
``DeviceMesh`` of 4 gloo ranks on the CPU, against the JAX package's under
the same mesh and, where the MoE routes in one rank's groups, against the
port's own serving on one rank.

Scaled moonshot (2 layers, 8 experts, top-2), jamba (8 layers: Mamba with
dense and MoE FFNs, attention with an MoE FFN) and xlstm (8 layers: 7
mLSTM and an sLSTM), f32: a prefill of 4 x 16 tokens and 4 decode steps
on given tokens, on meshes (2, 2), (4, 1) and (1, 4) under
``DEFAULT_RULES`` and ``SERVING_RULES``, as ``tests/test_torch_mesh_serve.
py`` runs the dense configs; jamba also at one row on (2, 2) (its
attention cache over both axes, its MoE tokens one group). The MoE routes
the reference's groups under the mesh (``MoE.route``: one group a data
rank at the prefill's 64 tokens, one group of every rank's tokens at
decode, through the count exchange) with its experts over "model"; the
recurrent mixers run heads-parallel and hand back the state in the
reference's layout (Mamba's ``conv`` split over its channels, ``ssm`` and
mLSTM's ``c`` whole, sLSTM's state split over its heads where they split).
Logits and every state leaf agree with JAX's within 1e-5 of the leaf's
largest magnitude; with one rank's wherever the groups match (the MoE
configs at four rows on (1, 4) only, and jamba's one row: elsewhere their
data ranks' prefill groups are smaller than one rank's single group, and
JAX under the same mesh is the reference there)."""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

sys.path.insert(0, str(Path(__file__).parent))
import torch_mesh_serve as ms  # noqa: E402
from test_torch_mesh_serve import _keys, jax_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
NAMES = ("moonshot", "jamba", "xlstm")
RUNS = ms.cases(NAMES, b1=("jamba",))
IDS = [ms.run_name(*r) for r in RUNS]
ONE_RANK = [r for r in RUNS if ms.same_groups(r[0], r[1], r[3])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    z = ms.make_inputs(NAMES)
    jax_params(NAMES, z)
    return ms.run_everything(str(tmp_path_factory.mktemp("mesh_serve_moe")),
                             z, RUNS, str(ROOT))


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_logits_and_state_match_jax_under_the_same_mesh(runs, run):
    key = ms.run_name(*run)
    ref = runs["jax"]
    got, _ = runs["mesh"]
    assert _keys(got, key) == _keys(ref, key)
    assert len(_keys(ref, key)) > ms.STEPS + 2
    for k in _keys(ref, key):
        assert ms.rel_err(got[k], ref[k]) <= TOL, k


@pytest.mark.parametrize("run", ONE_RANK,
                         ids=[ms.run_name(*r) for r in ONE_RANK])
def test_logits_and_state_match_one_rank(runs, run):
    name, _, _, batch, _, _ = run
    key = ms.run_name(*run)
    got, _ = runs["mesh"]
    logits, state = runs["one"][name, batch]
    for i, lg in enumerate(logits):
        assert ms.rel_err(got[f"{key}/logits{i}"], lg) <= TOL, i
    for k, v in state.items():
        assert ms.rel_err(got[f"{key}/state/{k}"], v) <= TOL, k


def test_one_rank_runs_cover_every_model_and_the_moe_groups():
    """The one-rank comparison reaches every model; it leaves out exactly
    the MoE configs' four-row runs whose data ranks route their prefill
    in groups of their own."""
    assert {r[0] for r in ONE_RANK} == set(NAMES)
    left = {ms.run_name(*r) for r in RUNS} - {ms.run_name(*r)
                                              for r in ONE_RANK}
    assert left == {ms.run_name(n, m, p, ms.BATCH, 0.0, False)
                    for n in ("moonshot", "jamba")
                    for m in ((2, 2), (4, 1)) for p in ms.RULES}
