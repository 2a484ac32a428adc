"""The port's EncDec (whisper) against the JAX EncDec on bridged parameters
(f32, CPU; 2 encoder + 2 decoder layers at the scaled width, 64 source
rows): the encoder, the decoder over a prompt, prefill with frames below
and above ``max_source_len`` (the cross cache padded or cut), 4 decode
steps (plain, through a remapped fetch, with an identity
``cross_transform``) and ``insert_slot``. Logits within 1e-4 of the
largest |logit|, greedy tokens identical.

The JAX side keeps ``src_len`` in its state here, as its model does. The
JAX *engine* loses it at slot insertion (its insert_slot copies only the
keys of the engine's state), so decode attends over the zero-padded cross
rows; the port keeps it as a state leaf. The last tests pin both."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, scaled_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.blocks import _einsum as jax_einsum  # noqa: E402
from repro.models.blocks import rms_norm as jax_rms_norm  # noqa: E402

import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.core import make_fetch, split_blocks  # noqa: E402
from repro_torch.core.layer_selection import RemapPlan  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402

ARCH, MAXC, PROMPT, STEPS = "whisper-medium", 48, 8, 4
# f32 on both sides: logits within RTOL of the largest |logit|
RTOL = 1e-4


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
    cfg = scaled_config(ARCHS[ARCH], num_layers=2)
    jm = jax_build(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = build_model(tcfgs.scaled_config(tcfgs.ARCHS[ARCH], num_layers=2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jit = {
        "encode": jax.jit(jm.impl.encode),
        "dec_seq": jax.jit(jm.impl.dec_seq, static_argnums=(3, 4)),
        "prefill": jax.jit(jm.impl.prefill, static_argnums=(3,)),
        "decode": jax.jit(lambda p, s, t: jm.impl.decode_step(p, s, t, MAXC)),
        "embed": jax.jit(jm.impl.embed),
    }
    return jm, jp, tm, tp, jit


def _inputs(cfg, frames: int, batch: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal((batch, frames, cfg.d_model)) * 0.02
         ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (batch, PROMPT)).astype(np.int32)
    return f, toks


def _close(j, t, rtol=RTOL):
    j, t = np.asarray(j, np.float32), np.asarray(t, np.float32)
    assert j.shape == t.shape
    assert np.abs(j - t).max() <= rtol * max(np.abs(j).max(), 1e-30)


def _close_trees(jtree, ttree):
    """Leaf by leaf, matched by key (the JAX tree's dicts are sorted)."""
    n = []
    tree_map(lambda t, j: n.append(_close(j, t)), ttree,
             jax.tree.map(np.asarray, jtree))
    assert len(n) == len(jax.tree.leaves(jtree))


def test_params_bridge_carries_the_encoder(models):
    jm, jp, tm, tp, _ = models
    assert set(tp) == {"embed", "out", "enc_norm", "final_norm", "encoder",
                       "blocks"}
    same = tree_leaves(tree_map(lambda s, t: s.shape == tuple(t.shape),
                                tm.specs(), tp))
    assert len(same) == len(tree_leaves(tp)) and all(same)
    assert tp["encoder"]["attn"]["wq"].shape[0] == 2
    tree_map(lambda t, j: np.testing.assert_array_equal(np.asarray(j), t),
             tp["encoder"], jax.tree.map(np.asarray, jp["encoder"]))


@pytest.mark.parametrize("frames", [32, 80])
def test_encode_and_dec_seq_match_jax(models, frames):
    jm, jp, tm, tp, jit = models
    f, toks = _inputs(jm.cfg, frames)
    je = jit["encode"](jp, jnp.asarray(f))
    te = tm.impl.encode(tp, torch.from_numpy(f))
    _close(je, te)
    jx, jc = jit["dec_seq"](jp, jit["embed"](jp, jnp.asarray(toks)), je,
                            None, True)
    tx, tc = tm.impl.dec_seq(tp, tm.impl.embed(tp, torch.from_numpy(toks)),
                             te, collect_cache=True)
    _close(jx, tx)
    for part in ("self", "cross"):
        for kv in ("k", "v"):
            _close(jc[part][kv], tc[part][kv])
    assert tuple(tc["cross"]["k"].shape) == (2, 2, frames, 4, 32)


@pytest.mark.parametrize("frames", [32, 80])
def test_prefill_fits_the_cross_cache_like_jax(models, frames):
    """32 frames: the cross cache is padded to 64 rows; 80: cut to 64."""
    jm, jp, tm, tp, jit = models
    f, toks = _inputs(jm.cfg, frames)
    jl, js = jit["prefill"](jp, jnp.asarray(f), jnp.asarray(toks), MAXC)
    tl, ts = tm.prefill(tp, {"frames": torch.from_numpy(f),
                             "tokens": torch.from_numpy(toks)}, MAXC)
    _close(jl, tl)
    assert np.array_equal(np.asarray(jl).argmax(-1), tl.numpy().argmax(-1))
    assert sorted(js) == sorted(ts) == ["blocks", "pos", "src_len"]
    assert ts["src_len"].tolist() == [min(frames, 64)] * 2
    assert ts["pos"].tolist() == [PROMPT] * 2
    assert len(tree_leaves(ts["blocks"])) == 4
    _close_trees(js["blocks"], ts["blocks"])
    cross = ts["blocks"][0]["mixer"]["cross"]["k"]
    assert tuple(cross.shape) == (2, 2, 64, 4, 32)
    if frames < 64:
        assert not cross[:, :, frames:].any()


def _jax_greedy(jit, jp, f, toks):
    logits, state = jit["prefill"](jp, jnp.asarray(f), jnp.asarray(toks),
                                   MAXC)
    out = [np.asarray(logits)]
    for _ in range(STEPS):
        logits, state = jit["decode"](jp, state, jnp.argmax(logits, -1))
        out.append(np.asarray(logits))
    return out


def _torch_greedy(tm, tp, f, toks, fetches=None, cross_transform=None):
    logits, state = tm.prefill(tp, {"frames": torch.from_numpy(f),
                                    "tokens": torch.from_numpy(toks)}, MAXC)
    out = [logits.numpy()]
    for _ in range(STEPS):
        logits, state = tm.impl.decode_step(
            tp, state, logits.argmax(-1).to(torch.int32), MAXC,
            fetch=fetches() if fetches else None,
            cross_transform=cross_transform)
        out.append(logits.numpy())
    assert state["pos"].tolist() == [PROMPT + STEPS] * 2
    return out


def _remapped_fetch(tm, tp):
    plan = RemapPlan(2, 1, 1, (1,), (0,))
    res, cyc, maps = split_blocks(tp["blocks"], plan)
    return lambda: make_fetch(res, cyc, maps)


@pytest.mark.parametrize("how", ["plain", "fetch", "cross_transform"])
def test_decode_matches_jax(models, how):
    jm, jp, tm, tp, jit = models
    f, toks = _inputs(jm.cfg, 32)
    ref = _jax_greedy(jit, jp, f, toks)
    out = _torch_greedy(
        tm, tp, f, toks,
        fetches=_remapped_fetch(tm, tp) if how == "fetch" else None,
        cross_transform=(lambda c: dict(c)) if how == "cross_transform"
        else None)
    for j, t in zip(ref, out):
        _close(j, t)
        assert np.array_equal(j.argmax(-1), t.argmax(-1))
    if how != "plain":      # the remapped and hooked runs are the plain one
        plain = _torch_greedy(tm, tp, f, toks)
        for a, b in zip(plain, out):
            assert np.array_equal(a, b)


def _slot_states(models):
    """One request's prefill inserted into slot 1 of a 3-slot state, on
    both sides, as each engine inserts it."""
    jm, jp, tm, tp, jit = models
    f, toks = _inputs(jm.cfg, 32, batch=1, seed=1)
    jl, js1 = jit["prefill"](jp, jnp.asarray(f), jnp.asarray(toks), MAXC)
    jst = jm.insert_slot(jm.init_decode_state(3, MAXC), 1, js1)
    tl, ts1 = tm.prefill(tp, {"frames": torch.from_numpy(f),
                              "tokens": torch.from_numpy(toks)}, MAXC)
    tst = tm.init_decode_state(3, MAXC, "cpu")
    assert tm.insert_slot(tst, 1, ts1) is tst
    return f, toks, (jl, jst), (tl, tst)


def test_insert_slot_matches_jax_and_keeps_src_len(models):
    _, _, (_, jst), (_, tst) = _slot_states(models)
    assert "src_len" not in jst                 # the reference's state
    assert tst["src_len"].tolist() == [0, 32, 0]
    assert tst["pos"].tolist() == [0, PROMPT, 0]
    _close_trees(jst["blocks"], tst["blocks"])
    specs = models[2].decode_state_specs(3, MAXC)
    assert [s.shape for s in tree_leaves(specs)] == \
        [tuple(t.shape) for t in tree_leaves(tst)]


def _no_cache_logits(models, f, seq):
    """The JAX model without a decode cache: encode, then the decoder over
    the whole sequence; the last row's logits."""
    jm, jp, _, _, jit = models
    enc = jit["encode"](jp, jnp.asarray(f))
    x, _ = jit["dec_seq"](jp, jit["embed"](jp, jnp.asarray(seq)), enc,
                          None, False)
    h = jax_rms_norm(x[:, -1], jp["final_norm"], jm.cfg.norm_eps)
    return np.asarray(jax_einsum("bd,dv->bv", h, jp["out"]))


def test_slot_decode_keeps_src_len_and_matches_no_cache(models):
    """The repair: decoding from the port's slot state matches a no-cache
    encode + dec_seq of the JAX model; decoding from the JAX engine's slot
    state (src_len lost) does not."""
    jm, jp, tm, tp, jit = models
    f, toks, (jl, jst), (tl, tst) = _slot_states(models)
    seq = toks[0].tolist()
    tok = int(tl[0].argmax())
    assert tok == int(np.asarray(jl)[0].argmax())
    tokens = torch.tensor([0, tok, 0], dtype=torch.int32)
    for _ in range(STEPS):
        seq.append(tok)
        ref = _no_cache_logits(models, f, np.asarray([seq], np.int32))[0]
        logits, tst = tm.decode_step(tp, tst, tokens, MAXC)
        _close(ref, logits[1].numpy())
        tok = int(logits[1].argmax())
        assert tok == int(ref.argmax())
        tokens = torch.tensor([0, tok, 0], dtype=torch.int32)
    # the reference engine's slot state: every one of the 64 cross rows is
    # read, 32 of them zero padding
    seq = toks[0].tolist() + [int(np.asarray(jl)[0].argmax())]
    ref = _no_cache_logits(models, f, np.asarray([seq], np.int32))[0]
    lost, _ = jit["decode"](jp, jst, jnp.asarray([0, seq[-1], 0], jnp.int32))
    gap = np.abs(np.asarray(lost)[1] - ref).max() / np.abs(ref).max()
    assert gap > 100 * RTOL
