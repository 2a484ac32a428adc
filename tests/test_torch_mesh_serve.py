"""The port's dense configs served over a (data, model) ``DeviceMesh`` of 4
gloo ranks on the CPU, against the JAX package's under the same mesh and
against the port's own serving on one rank.

Scaled llama (6 layers), danube (2 layers, its window cut to 8 so that the
16-token prompt wraps the ring), llava (2 layers, 8 patch rows ahead of
the tokens) and whisper (2 + 2 layers, 32 frames), f32: a prefill of 4 x
16 tokens and 4 decode steps on given tokens, on meshes (2, 2), (4, 1) and
(1, 4), under ``DEFAULT_RULES`` (FSDP x TP weights) and ``SERVING_RULES``
(TP-only dense weights); each rank holds its blocks of the params, the
inputs and the decode state (``Model.decode_state_shardings``), and each
step's logits are its rows. Beside those: danube at one row on (2, 2),
whose cache splits its sequence over both axes (long_500k's layout, its
ring positions split over "model" alone), the remap tier 0.5 of llama's
layers (the rank's blocks split by ``tier_split``, fetched each step) and
whisper's cross K/V remapped (``cross_kv_to_host``) on (2, 2) under both
profiles. One spawn runs every case (``tests/torch_mesh_serve.py``); one
JAX subprocess a model runs ``Model.prefill`` and ``Model.decode_step``
under ``jax.jit`` on 4 forced host devices with the reference's
placements. Parameters come from the JAX init (``params_from_jax``'s
layout), inputs from seeded numpy. Every step's logits and every leaf of
the final decode state (gathered whole) agree with JAX's within 1e-5 of
the leaf's largest magnitude, and with one rank's; the remap tiers are
bitwise equal to no remap."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
import torch_mesh_serve as ms  # noqa: E402

from repro.configs import ARCHS, scaled_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.training.checkpoint import _flatten_with_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
NAMES = ("llama", "danube", "llava", "whisper")
RUNS = ms.cases(NAMES, b1=("danube",), remap=("llama",), cross=("whisper",))
PLAIN = [r for r in RUNS if not r[4] and not r[5]]
IDS = [ms.run_name(*r) for r in PLAIN]


def jax_params(names, z: dict) -> None:
    """Each model's JAX init (seeded by its place in ``names``), flattened
    into ``z`` as "{name}/params/{key}"."""
    for i, name in enumerate(names):
        arch, layers, over = ms.MODELS[name]
        jp = jax_build(scaled_config(ARCHS[arch], num_layers=layers,
                                     **over)).init(jax.random.PRNGKey(i))
        z.update({f"{name}/params/{k}": np.asarray(v)
                  for k, v in _flatten_with_paths(jp)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    z = ms.make_inputs(NAMES)
    jax_params(NAMES, z)
    return ms.run_everything(str(tmp_path_factory.mktemp("mesh_serve")), z,
                             RUNS, str(ROOT))


def _keys(arrays: dict, key: str):
    return sorted(k for k in arrays if k.startswith(key + "/"))


@pytest.mark.parametrize("run", PLAIN, ids=IDS)
def test_logits_and_state_match_jax_under_the_same_mesh(runs, run):
    key = ms.run_name(*run)
    ref = runs["jax"]
    got, _ = runs["mesh"]
    assert _keys(got, key) == _keys(ref, key)
    assert len(_keys(ref, key)) > ms.STEPS + 2
    for k in _keys(ref, key):
        assert ms.rel_err(got[k], ref[k]) <= TOL, k


@pytest.mark.parametrize("run", PLAIN, ids=IDS)
def test_logits_and_state_match_one_rank(runs, run):
    name, layout, _, batch, _, _ = run
    assert ms.same_groups(name, layout, batch)
    key = ms.run_name(*run)
    got, _ = runs["mesh"]
    logits, state = runs["one"][name, batch]
    for i, lg in enumerate(logits):
        assert ms.rel_err(got[f"{key}/logits{i}"], lg) <= TOL, i
    assert {f"{key}/state/{k}" for k in state} == {
        k for k in _keys(got, key) if "/state/" in k}
    for k, v in state.items():
        assert ms.rel_err(got[f"{key}/state/{k}"], v) <= TOL, k


@pytest.mark.parametrize("profile", ms.RULES)
def test_layer_remap_tier_is_bitwise_no_remap(runs, profile):
    """Llama's 6 repeats at tier 0.5: alpha 3, m 4 of them cycle (the
    reference's plan at t_t = 1e-9: beta 1); every step's logits and the
    state equal the run without remap bit for bit."""
    got, meta = runs["mesh"]
    plain = ms.run_name("llama", (2, 2), profile, ms.BATCH, 0.0, False)
    remap = ms.run_name("llama", (2, 2), profile, ms.BATCH, ms.REMAP_TIER,
                        False)
    assert meta[remap] == {"alpha": 3, "m": 4, "beta": 1,
                           "cycle_layers": [0, 1, 3, 4]}
    keys = _keys(got, plain)
    assert len(keys) == len(_keys(got, remap)) > ms.STEPS + 2
    for k in keys:
        np.testing.assert_array_equal(got[k.replace(plain, remap, 1)],
                                      got[k])


@pytest.mark.parametrize("profile", ms.RULES)
def test_cross_kv_remap_is_bitwise_no_remap(runs, profile):
    """Whisper's cross K/V moved off the state's device tensors after the
    prefill and copied back a repeat at a time: bitwise no remap; the
    moved bytes are the rank's whole cross cache (every head, the whole
    source, its rows)."""
    got, meta = runs["mesh"]
    plain = ms.run_name("whisper", (2, 2), profile, ms.BATCH, 0.0, False)
    remap = ms.run_name("whisper", (2, 2), profile, ms.BATCH, 0.0, True)
    c = ms.cfg("whisper")
    rows = ms.BATCH // 2
    assert meta[remap]["cross_kv_bytes"] == 2 * c.num_layers * rows * \
        c.max_source_len * c.num_kv_heads * c.resolved_head_dim * 4
    for k in _keys(got, plain):
        np.testing.assert_array_equal(got[k.replace(plain, remap, 1)],
                                      got[k])


def test_one_row_splits_the_cache_over_every_axis():
    """The one-row danube case's layout: its ring (8 slots) split over
    ("data", "model"), its rows whole; ``kv_pos`` over "model" alone (the
    reference's ("batch", "kv_seq")); the four-row cases' caches over
    "model", the rows over "data"."""
    from repro_torch.distributed.sharding import MeshLayout, mesh_context
    from repro_torch.models import build_model
    from repro_torch.models.blocks import decode_layout
    layout = MeshLayout(ms.AXES, (2, 2))
    model = build_model(ms.cfg("danube"))
    with mesh_context(layout):
        assert decode_layout(layout, 1, 8) == (("data", "model"), ())
        assert decode_layout(layout, ms.BATCH, 8) == (("model",), ("data",))
        sh = model.decode_state_shardings(1, ms.CONTEXT, layout)
        assert sh["kv_pos"].spec == (None, "model")
        assert sh["blocks"][0]["mixer"]["k"].spec == (
            None, None, ("data", "model"))
