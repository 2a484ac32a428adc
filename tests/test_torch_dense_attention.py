"""Dense (``paged=False``) decode of attention stacks against the JAX LM on
bridged parameters (f32, CPU): danube's sliding-window ring (window 64) with
a prompt that wraps the ring at prefill (80 tokens) and one that wraps it
during decode (60 tokens), and jamba's hybrid stack (Mamba + attention,
dense and MoE FFNs; 8 layers = 2 repeats of its 4-layer pattern). Prefill
and decode logits, the ring's ``kv_pos``, ``insert_slot``, and a remapped
decode through the port's split/fetch."""
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

MAXC, STEPS = 100, 8
# f32 on both sides; the port sums products in another order than XLA
TOL = 1e-4
# arch -> (layers, prompt lengths)
CASES = {"danube80": ("h2o-danube-3-4b", 2, 80),
         "danube60": ("h2o-danube-3-4b", 2, 60),
         "jamba": ("jamba-v0.1-52b", 8, 24)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _models(arch, layers):
    if (arch, layers) not in _MODELS:
        cfg = scaled_config(ARCHS[arch], num_layers=layers)
        jm = jax_build(cfg)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        tm = build_model(tcfgs.scaled_config(tcfgs.ARCHS[arch],
                                             num_layers=layers))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        _MODELS[arch, layers] = (jm, jp, tm, tp)
    return _MODELS[arch, layers]


def _prompts(cfg, length):
    return np.random.default_rng(length).integers(
        0, cfg.vocab_size, (2, length)).astype(np.int32)


def _jax_run(jm, jp, prompts):
    prefill = jax.jit(jm.prefill, static_argnums=(2,))
    step = jax.jit(lambda p, s, t: jm.decode_step(p, s, t, MAXC))
    logits, state = prefill(jp, {"tokens": jnp.asarray(prompts)}, MAXC)
    out, kv_pos = [np.asarray(logits)], []
    for _ in range(STEPS):
        logits, state = step(jp, state, jnp.argmax(logits, -1))
        out.append(np.asarray(logits))
        kv_pos.append(np.asarray(state.get("kv_pos", np.zeros(0))))
    return out, kv_pos, state


def _torch_run(tm, tp, prompts, fetches=None):
    logits, state = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)},
                               MAXC)
    out, kv_pos = [logits.numpy()], []
    for _ in range(STEPS):
        logits, state = tm.decode_step(
            tp, state, logits.argmax(-1).to(torch.int32), MAXC,
            fetch=fetches() if fetches else None)
        out.append(logits.numpy())
        kv_pos.append(state["kv_pos"].numpy().copy() if "kv_pos" in state
                      else np.zeros(0))
    return out, kv_pos, state


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_match_jax(case):
    arch, layers, length = CASES[case]
    jm, jp, tm, tp = _models(arch, layers)
    prompts = _prompts(jm.cfg, length)
    jout, jkv, _ = _jax_run(jm, jp, prompts)
    tout, tkv, state = _torch_run(tm, tp, prompts)
    for j, t in zip(jout, tout):
        assert np.abs(j - t).max() < TOL
    for j, t in zip(jkv, tkv):
        assert np.array_equal(j, t)
    assert state["pos"].tolist() == [length + STEPS] * 2
    if arch.startswith("h2o"):
        # the ring holds the last 64 positions, each at slot t % 64
        w = tm.cfg.sliding_window
        last = length + STEPS - 1
        want = [t for t in range(max(0, last - w + 1), last + 1)]
        kv = tkv[-1][0]
        assert sorted(kv[kv >= 0].tolist()) == want
        assert all(kv[t % w] == t for t in want)


def test_ring_layout_of_the_prefill_matches_jax():
    """80 tokens into a 64-slot ring: slot t % 64 holds token t's K/V."""
    jm, jp, tm, tp = _models("h2o-danube-3-4b", 2)
    prompts = _prompts(jm.cfg, 80)
    _, js = jax.jit(jm.prefill, static_argnums=(2,))(
        jp, {"tokens": jnp.asarray(prompts)}, MAXC)
    _, ts = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)}, MAXC)
    assert np.array_equal(np.asarray(js["kv_pos"]), ts["kv_pos"].numpy())
    assert ts["kv_pos"][0, :16].tolist() == list(range(64, 80))
    jl, tl = jax.tree.leaves(js), jax.tree.leaves(ts)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        assert np.abs(np.asarray(j) - t.numpy()).max() < TOL


@pytest.mark.parametrize("arch,layers", [("h2o-danube-3-4b", 2),
                                         ("jamba-v0.1-52b", 8)])
def test_insert_slot_matches_jax(arch, layers):
    jm, jp, tm, tp = _models(arch, layers)
    prompts = _prompts(jm.cfg, 70)
    _, js1 = jax.jit(jm.prefill, static_argnums=(2,))(
        jp, {"tokens": jnp.asarray(prompts[:1])}, MAXC)
    jst = jm.insert_slot(jm.init_decode_state(3, MAXC), 1, js1)
    _, ts1 = tm.prefill(tp, {"tokens": torch.from_numpy(prompts[:1])}, MAXC)
    tst = tm.init_decode_state(3, MAXC, "cpu")
    assert tm.insert_slot(tst, 1, ts1) is tst       # in place
    assert tst["pos"].tolist() == [0, 70, 0]
    jl, tl = jax.tree.leaves(jst), jax.tree.leaves(tst)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        assert np.abs(np.asarray(j) - t.numpy()).max() < TOL
    if tm.cfg.sliding_window:
        assert tst["kv_pos"][0].tolist() == [-1] * 64      # batch-major leaf
        assert tst["kv_pos"][1, :6].tolist() == list(range(64, 70))
    specs = tm.decode_state_specs(3, MAXC)
    assert [s.shape for s in tree_leaves(specs)] == \
        [tuple(t.shape) for t in tree_leaves(tst)]


@pytest.mark.parametrize("arch,layers,cycle", [
    ("h2o-danube-3-4b", 2, (1,)), ("jamba-v0.1-52b", 8, (0,)),
    ("jamba-v0.1-52b", 8, (0, 1))])
def test_remapped_decode_through_fetch_equals_plain_decode(arch, layers,
                                                           cycle):
    """One repeat (jamba: a tuple of 4 layer dicts) or both cycling."""
    _, _, tm, tp = _models(arch, layers)
    prompts = _prompts(tm.cfg, 66)
    plain = _torch_run(tm, tp, prompts)
    r = tm.repeats
    plan = RemapPlan(r, 1, len(cycle), cycle,
                     tuple(i for i in range(r) if i not in cycle))
    res, cyc, maps = split_blocks(tp["blocks"], plan)
    assert len(cyc) == len(tm.impl.pattern)
    remapped = _torch_run(tm, tp, prompts,
                          fetches=lambda: make_fetch(res, cyc, maps))
    for a, b in zip(plain[0], remapped[0]):
        assert np.array_equal(a, b)
    for a, b in zip(plain[1], remapped[1]):
        assert np.array_equal(a, b)


def test_decode_writes_the_cache_in_place():
    """A dense decode step writes one K/V row per sequence and layer where
    the cache lies: the state's tensors are the ones it was given."""
    _, _, tm, tp = _models("jamba-v0.1-52b", 8)
    _, st = tm.prefill(tp, {"tokens": torch.from_numpy(
        _prompts(tm.cfg, 30))}, MAXC)
    attn = [i for i, ld in enumerate(tm.impl.pattern) if ld.mixer == "attn"]
    before = {i: (st["blocks"][i]["mixer"]["k"].data_ptr(),
                  st["blocks"][i]["mixer"]["k"].clone()) for i in attn}
    _, st2 = tm.decode_step(tp, st, torch.zeros(2, dtype=torch.int32), MAXC)
    for i in attn:
        k = st2["blocks"][i]["mixer"]["k"]
        assert k.data_ptr() == before[i][0]
        changed = (k != before[i][1]).any(dim=(-1, -2))       # [R, B, S]
        assert changed.sum(-1).tolist() == [[1, 1]] * tm.repeats
        assert changed[..., 30].all()
