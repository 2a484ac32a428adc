"""The dry run's ``head-tp`` rules (head_dim over "model", the heads whole:
the reference's variant for xlstm's 4 heads) on live meshes: scaled llama
(2 layers) and xlstm (8 layers: 7 mLSTM and an sLSTM), f32, on (data,
model) meshes (2, 2) and (1, 4) of 4 gloo ranks on the CPU (one spawn,
``tests/torch_head_tp.py``), against the port on one rank and the JAX
package under the same meshes and rules (one subprocess on 4 forced host
devices). On (2, 2) llama's 2 KV heads split over "model" while its query
heads split head_dim; on (1, 4) they do not divide and wk/wv split
head_dim too, llama3-8b's case at model 16.

Each case: a prefill of 4 x 16 tokens, 4 greedy decode steps, the decode
state after them (gathered whole), and the train loss of a 4 x 16 batch
with every parameter's gradient (gathered whole); and jamba's Mamba
mixer alone (its channels split, its per-head leaves whole), its output
and gradients against one rank's. Tolerances, each over
the reference's largest magnitude of the leaf: logits, state and the
mixer's output 1e-5, loss
1e-6, gradients 1e-4 (the head_dim partial sums of ``wo``, of sLSTM's
recurrent product and of the gathered q/k gradients add in another order
than one rank's); the greedy tokens are equal."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
import torch_head_tp as ht  # noqa: E402
from torch_mesh_serve import rel_err  # noqa: E402

from repro.configs import ARCHS, scaled_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.training.checkpoint import _flatten_with_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = {"logits": 1e-5, "state": 1e-5, "loss": 1e-6, "grad": 1e-4,
       "y": 1e-5}
CASES = [(name, layout) for layout in ht.MESHES for name in ht.MODELS]
IDS = [ht.case_name(*c) for c in CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    z = ht.make_inputs()
    z.update(ht.mamba_inputs())
    for i, (name, (arch, layers)) in enumerate(ht.MODELS.items()):
        jp = jax_build(scaled_config(ARCHS[arch], num_layers=layers)).init(
            jax.random.PRNGKey(i))
        z.update({f"{name}/params/{k}": np.asarray(v)
                  for k, v in _flatten_with_paths(jp)})
    return ht.run_everything(str(tmp_path_factory.mktemp("head_tp")), z,
                             str(ROOT))


def _kind(key: str) -> str:
    for kind in ("logits", "state", "loss", "grad", "tokens", "y"):
        if key.startswith(kind):
            return kind
    raise KeyError(key)


def _check(got: dict, ref: dict, what: str) -> None:
    assert sorted(got) == sorted(ref), what
    for k in ref:
        kind = _kind(k)
        if kind == "tokens":
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            assert rel_err(got[k], ref[k]) <= TOL[kind], (what, k)


def _case(arrays: dict, key: str) -> dict:
    return {k[len(key) + 1:]: v for k, v in arrays.items()
            if k.startswith(key + "/")}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_head_tp_matches_one_rank(runs, case):
    got = _case(runs["mesh"], ht.case_name(*case))
    assert len([k for k in got if k.startswith("grad/")]) > 4
    _check(got, runs["one"][case[0]], "one rank")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_head_tp_matches_jax_under_the_same_mesh(runs, case):
    key = ht.case_name(*case)
    _check(_case(runs["mesh"], key), _case(runs["jax"], key), "jax")


@pytest.mark.parametrize("layout", ht.MESHES,
                         ids=[f"{a}x{b}" for a, b in ht.MESHES])
def test_head_tp_mamba_matches_one_rank(runs, layout):
    """Jamba's Mamba mixer under head-tp: its channels split over "model",
    its per-head leaves whole on every rank (each rank takes its heads of
    them); the output and every leaf's gradient against one rank's."""
    got = _case(runs["mesh"], ht.case_name("mamba", layout))
    assert {"grad/dt_proj", "grad/a_log", "grad/in_proj"} <= set(got)
    _check(got, runs["one"]["mamba"], "one rank")


def test_head_tp_splits_head_dim_as_the_rules_say():
    """The layouts the cases exercise: under head-tp, wq/wo split head_dim
    and the heads stay whole; llama's wk splits its KV heads on (2, 2)
    and head_dim on (1, 4); xlstm's mLSTM and sLSTM leaves split head_dim
    and their decode states stay whole."""
    from repro_torch.distributed.sharding import MeshLayout, spec_for
    from repro_torch.models.blocks import Attention, MLSTM, SLSTM
    r = ht.rules()

    def specs(block, c, layout):
        mesh = MeshLayout(ht.AXES, layout)
        return {n: spec_for(s.logical, s.shape, mesh, r)
                for n, s in block.specs(c).items()}

    llama, xlstm = ht.cfg("llama"), ht.cfg("xlstm")
    sp = specs(Attention(), llama, (2, 2))
    assert sp["wq"] == (None, None, "model") and sp["wk"] == (None, "model")
    assert sp["wo"] == (None, "model")
    assert specs(Attention(), llama, (1, 4))["wk"] == (None, None, "model")
    assert specs(MLSTM(), xlstm, (2, 2)) == {
        "wq": (None, None, "model"), "wk": (None, None, "model"),
        "wv": (None, None, "model"), "w_if": (), "b_if": (),
        "wo": (None, "model")}
    assert specs(SLSTM(), xlstm, (2, 2)) == {
        "w": (None, None, None, "model"), "r": (None, None, "model"),
        "b": (None, None, "model"), "wo": (None, "model")}
    mesh = MeshLayout(ht.AXES, (2, 2))
    for block in (MLSTM(), SLSTM()):
        for s in block.init_state(xlstm, 4, 32).values():
            assert spec_for(s.logical, s.shape, mesh, r) == ("data",)
