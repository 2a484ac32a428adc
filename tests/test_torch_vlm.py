"""The port's LM with a VLM prefix (llava: patch embeddings ahead of the
prompt) against the JAX LM on bridged parameters (f32, CPU; 2 layers at
the scaled width, 16 patch rows): ``embed`` with a prefix, ``prefill``
with ``prefix_embeds`` and ``lengths`` then greedy decode, and
``prefill_chunk_paged`` with ``prefix_embeds`` (held at the model level
only: the engine serves a VLM dense). Logits within 1e-4 of the largest
|logit|, greedy tokens identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, scaled_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402

import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402

ARCH, MAXC, PROMPT, STEPS = "llava-next-34b", 64, 10, 4
PAGE, NPAGES = 4, 12
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
    assert tm.cfg.num_image_patches == cfg.num_image_patches == 16
    return jm, jp, tm, tp


def _inputs(cfg, batch: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed)
    patches = (rng.standard_normal((batch, cfg.num_image_patches,
                                    cfg.d_model)) * 0.02).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (batch, PROMPT)).astype(np.int32)
    return patches, toks


def _close(j, t, rtol=RTOL):
    j, t = np.asarray(j, np.float32), np.asarray(t, np.float32)
    assert j.shape == t.shape
    assert np.abs(j - t).max() <= rtol * max(np.abs(j).max(), 1e-30)


def test_embed_puts_the_prefix_first(models):
    jm, jp, tm, tp = models
    patches, toks = _inputs(jm.cfg)
    jx = jm.impl.embed(jp, jnp.asarray(toks), jnp.asarray(patches))
    tx = tm.impl.embed(tp, torch.from_numpy(toks), torch.from_numpy(patches))
    assert tuple(tx.shape) == (2, 16 + PROMPT, jm.cfg.d_model)
    assert np.array_equal(np.asarray(jx), tx.numpy())
    assert np.array_equal(tx[:, :16].numpy(), patches)


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_with_prefix_and_lengths_then_decode(models, ragged):
    """``lengths``: the rows' real lengths of the 16 + 10 rows (the second
    row 3 shorter when ragged): logits of row lengths - 1, decode from
    there."""
    jm, jp, tm, tp = models
    patches, toks = _inputs(jm.cfg)
    s = 16 + PROMPT
    lengths = np.array([s, s - 3 if ragged else s], np.int32)
    prefill = jax.jit(jm.prefill, static_argnums=(2,))
    step = jax.jit(lambda p, st, t: jm.decode_step(p, st, t, MAXC))
    jl, js = prefill(jp, {"tokens": jnp.asarray(toks),
                          "patch_embeds": jnp.asarray(patches),
                          "lengths": jnp.asarray(lengths)}, MAXC)
    tl, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "patch_embeds": torch.from_numpy(patches),
                             "lengths": torch.from_numpy(lengths)}, MAXC)
    assert ts["pos"].tolist() == lengths.tolist()
    tree_map(lambda t, j: _close(j, t), ts,
             jax.tree.map(np.asarray, js))
    for _ in range(STEPS + 1):
        _close(jl, tl)
        assert np.array_equal(np.asarray(jl).argmax(-1),
                              tl.numpy().argmax(-1))
        jl, js = step(jp, js, jnp.argmax(jl, -1))
        tl, ts = tm.decode_step(tp, ts, tl.argmax(-1).to(torch.int32), MAXC)
    assert ts["pos"].tolist() == (lengths + STEPS + 1).tolist()


def test_prefill_of_prefix_equals_its_rows_without_lengths(models):
    """Without ``lengths`` the last row is S - 1; the same as lengths = S."""
    _, _, tm, tp = models
    patches, toks = _inputs(tm.cfg)
    batch = {"tokens": torch.from_numpy(toks),
             "patch_embeds": torch.from_numpy(patches)}
    a, _ = tm.prefill(tp, batch, MAXC)
    b, _ = tm.prefill(tp, dict(batch, lengths=torch.full((2,), 16 + PROMPT,
                                                         dtype=torch.int32)),
                      MAXC)
    assert torch.equal(a, b)


def _paged_state(cfg, repeats, zeros):
    pt = np.full((1, 8), NPAGES, np.int32)
    pt[0, :7] = [3, 5, 7, 9, 0, 2, 11]          # 28 slots for 26 rows
    shape = (repeats, NPAGES + 1, PAGE, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"pool_k": zeros(shape), "pool_v": zeros(shape),
            "page_table": pt, "ctx": np.zeros((1,), np.int32)}


def test_prefill_chunk_paged_with_prefix_matches_jax(models):
    """The prefix and the prompt as one chunk at start 0 (26 rows into 7
    pages), then paged decode steps."""
    jm, jp, tm, tp = models
    patches, toks = _inputs(jm.cfg, batch=1)
    js = _paged_state(jm.cfg, jm.repeats, jnp.zeros)
    js = dict(js, page_table=jnp.asarray(js["page_table"]),
              ctx=jnp.asarray(js["ctx"]))
    ts = _paged_state(tm.cfg, tm.repeats, torch.zeros)
    ts = dict(ts, page_table=torch.from_numpy(ts["page_table"]),
              ctx=torch.from_numpy(ts["ctx"]))
    jchunk = jax.jit(jm.impl.prefill_chunk_paged, static_argnums=(2, 4))
    jdec = jax.jit(jm.impl.decode_step_paged)
    jl, js = jchunk(jp, js, 0, jnp.asarray(toks[0]), 0, None,
                    jnp.asarray(patches))
    tl, ts = tm.impl.prefill_chunk_paged(
        tp, ts, 0, torch.from_numpy(toks[0]), 0,
        prefix_embeds=torch.from_numpy(patches))
    assert int(ts["ctx"][0]) == int(js["ctx"][0]) == 16 + PROMPT
    _close(jl, tl)
    _close(js["pool_k"], ts["pool_k"])
    _close(js["pool_v"], ts["pool_v"])
    jtok, ttok = [int(jnp.argmax(jl))], [int(torch.argmax(tl))]
    for _ in range(STEPS):
        jl, js = jdec(jp, js, jnp.asarray([jtok[-1]]))
        tl, ts = tm.impl.decode_step_paged(
            tp, ts, torch.tensor([ttok[-1]], dtype=torch.int32))
        _close(jl, tl)
        jtok.append(int(jnp.argmax(jl[0])))
        ttok.append(int(torch.argmax(tl[0])))
    assert ttok == jtok


def test_decode_past_the_cache_clamps_like_jax(models):
    """A dense cache of 36 rows for 16 patch rows and 18 prompt tokens: the
    engine's finish guard counts prompt and generated tokens, not patches,
    so decode runs past the cache; the reference then writes every new row
    into the last slot (slot = min(pos, max_context - 1)), and the port
    copies that (ROADMAP queue 3). Both agree; from the third step on both
    differ from a cache with room."""
    jm, jp, tm, tp = models
    patches, toks = _inputs(jm.cfg, batch=1)
    toks = np.concatenate([toks, toks[:, :8]], axis=1)          # 18 tokens
    out = {}
    for maxc in (36, 64):
        prefill = jax.jit(jm.prefill, static_argnums=(2,))
        step = jax.jit(lambda p, st, t, m=maxc: jm.decode_step(p, st, t, m))
        jl, js = prefill(jp, {"tokens": jnp.asarray(toks),
                              "patch_embeds": jnp.asarray(patches)}, maxc)
        tl, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                 "patch_embeds": torch.from_numpy(patches)},
                            maxc)
        seq = []
        for _ in range(6):
            _close(jl, tl)
            seq.append(tl.numpy()[0])
            tok = jnp.argmax(jl, -1)
            jl, js = step(jp, js, tok)
            tl, ts = tm.decode_step(tp, ts, torch.tensor(
                np.asarray(tok), dtype=torch.int32), maxc)
        out[maxc] = seq
    gaps = [np.abs(a - b).max() / np.abs(b).max()
            for a, b in zip(out[36], out[64])]
    assert max(gaps[:3]) < 1e-5 and min(gaps[3:]) > 100 * RTOL
