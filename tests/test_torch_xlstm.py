"""The port's xLSTM LM against the JAX LM on bridged parameters (CPU):
the weight bridge of the mixed-dtype tree, prefill and greedy decode over
the dense recurrent state, ``insert_slot``, and a remapped decode through
the port's split/fetch. 16 layers: two repeats of the 8-layer pattern
(7 mLSTM + 1 sLSTM), so a remap can move one repeat. The JAX side
initialises and prefills under ``jax.jit``: op by op, each takes seconds."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, scaled_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402

import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.core import make_fetch, split_blocks  # noqa: E402
from repro_torch.core.layer_selection import RemapPlan  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402

LAYERS, MAXC, STEPS = 16, 48, 5
# f32 on both sides; the port sums products in another order than XLA
# (einsum vs dot_general, chunked recurrence), ~1e-6 relative per layer
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    cfg = scaled_config(ARCHS["xlstm-1.3b"], num_layers=LAYERS)
    jm = jax_build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jm.prefill = jax.jit(jm.prefill, static_argnums=(2,))
    tm = build_model(tcfgs.scaled_config(tcfgs.ARCHS["xlstm-1.3b"],
                                         num_layers=LAYERS))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    return jm, jp, tm, tp, prompts


def test_params_from_jax_keeps_the_mixed_dtype_tree():
    """bf16 model: mLSTM and output weights bf16, sLSTM's recurrent cell
    (w, r, b) and every gate/norm f32, the 8-tuple of pattern positions
    kept, each leaf bit for bit."""
    cfg = dataclasses.replace(scaled_config(ARCHS["xlstm-1.3b"],
                                            num_layers=8), dtype="bfloat16")
    jp = jax.jit(jax_build(cfg).init)(jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert isinstance(tp["blocks"], tuple) and len(tp["blocks"]) == 8
    slstm = tp["blocks"][7]["mixer"]
    assert sorted(slstm) == ["b", "r", "w", "wo"]
    assert {slstm[k].dtype for k in "wrb"} == {torch.float32}
    assert slstm["wo"].dtype == torch.bfloat16
    assert tp["blocks"][0]["mixer"]["wq"].dtype == torch.bfloat16
    assert tp["blocks"][0]["mixer"]["w_if"].dtype == torch.float32
    jl = jax.tree.leaves(jp)
    tl = [tp["embed"], tp["final_norm"], *tree_leaves(tp["blocks"]),
          tp["out"]]
    assert len(jl) == len(tl)
    for j, t in zip(sorted(jl, key=lambda a: (a.shape, str(a.dtype))),
                    sorted(tl, key=lambda a: (tuple(a.shape), str(a.dtype)))):
        assert tuple(t.shape) == j.shape and str(j.dtype) in str(t.dtype)
    wo = np.asarray(jp["blocks"][7]["mixer"]["wo"]).view(np.int16)
    assert np.array_equal(slstm["wo"].view(torch.int16).numpy(), wo)
    assert np.array_equal(slstm["r"].numpy(),
                          np.asarray(jp["blocks"][7]["mixer"]["r"]))


def _jax_run(jm, jp, prompts):
    logits, state = jm.prefill(jp, {"tokens": jnp.asarray(prompts)}, MAXC)
    first = np.asarray(logits)
    step = jax.jit(lambda p, s, t: jm.decode_step(p, s, t, MAXC))
    toks = [np.asarray(jnp.argmax(logits, -1))]
    for _ in range(STEPS):
        logits, state = step(jp, state, jnp.asarray(toks[-1]))
        toks.append(np.asarray(jnp.argmax(logits, -1)))
    return first, np.stack(toks, 1), np.asarray(logits)


def _torch_run(tm, tp, prompts, fetches=None):
    logits, state = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)},
                               MAXC)
    first = logits.numpy()
    toks = [logits.argmax(-1)]
    for i in range(STEPS):
        logits, state = tm.decode_step(
            tp, state, toks[-1], MAXC,
            fetch=fetches() if fetches else None)
        toks.append(logits.argmax(-1))
    return first, torch.stack(toks, 1).numpy(), logits.numpy(), state


def test_prefill_and_decode_match_jax(models):
    jm, jp, tm, tp, prompts = models
    jfirst, jtoks, jlast = _jax_run(jm, jp, prompts)
    tfirst, ttoks, tlast, state = _torch_run(tm, tp, prompts)
    assert np.abs(jfirst - tfirst).max() < TOL
    assert np.abs(jlast - tlast).max() < TOL
    assert np.array_equal(ttoks, jtoks)
    assert state["pos"].tolist() == [13 + STEPS] * 2


@pytest.mark.parametrize("cycle", [(0,), (1,), (0, 1)])
def test_remapped_decode_through_fetch_equals_plain_decode(models, cycle):
    """One repeat (8 layers: a tuple of 8 layer dicts) or both cycling."""
    _, _, tm, tp, prompts = models
    plain = _torch_run(tm, tp, prompts)
    plan = RemapPlan(2, 1, len(cycle), cycle,
                     tuple(r for r in range(2) if r not in cycle))
    res, cyc, maps = split_blocks(tp["blocks"], plan)
    assert isinstance(cyc, tuple) and len(cyc) == 8
    assert tuple(cyc[7]["mixer"]["r"].shape)[0] == len(cycle)
    remapped = _torch_run(tm, tp, prompts,
                          fetches=lambda: make_fetch(res, cyc, maps))
    for a, b in zip(plain[:3], remapped[:3]):
        assert np.array_equal(a, b)


def test_insert_slot_matches_jax(models):
    jm, jp, tm, tp, prompts = models
    _, js1 = jm.prefill(jp, {"tokens": jnp.asarray(prompts[:1])}, MAXC)
    jst = jm.insert_slot(jm.init_decode_state(3, MAXC), 1, js1)
    _, ts1 = tm.prefill(tp, {"tokens": torch.from_numpy(prompts[:1])}, MAXC)
    tst = tm.init_decode_state(3, MAXC, "cpu")
    assert tm.insert_slot(tst, 1, ts1) is tst       # in place
    # both trees flattened in JAX's order (dict keys sorted)
    jl, tl = jax.tree.leaves(jst), jax.tree.leaves(tst)
    assert len(jl) == len(tl)
    assert tst["pos"].tolist() == [0, 13, 0]
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        assert np.abs(np.asarray(j) - t.numpy()).max() < TOL
    specs = tm.decode_state_specs(3, MAXC)
    assert [s.shape for s in tree_leaves(specs)] == \
        [tuple(t.shape) for t in tree_leaves(tst)]
