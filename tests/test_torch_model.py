"""The port's LM against the JAX LM on bridged parameters (f32, CPU):
sequence forward and logits, chunked paged prefill followed by paged decode,
and remapped decode through the port's split/fetch."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, scaled_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402

import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.core import (  # noqa: E402
    make_fetch, make_plan, merge_blocks, split_blocks,
)
from repro_torch.models import build_model, params_from_jax  # noqa: E402

LAYERS, PAGE, NPAGES = 3, 4, 24


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
    cfg = scaled_config(ARCHS["llama3-8b"], num_layers=LAYERS)
    jm = jax_build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfgs.scaled_config(tcfgs.ARCHS["llama3-8b"],
                                         num_layers=LAYERS))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 13)).astype(np.int32)
    return jm, jp, tm, tp, prompt


def test_params_from_jax_keeps_tree_and_layout(models):
    jm, jp, tm, tp, _ = models
    jl = jax.tree.leaves(jp)
    tl = [tp["embed"], tp["final_norm"], *_leaves(tp["blocks"]), tp["out"]]
    assert sorted(tuple(a.shape) for a in jl) == \
        sorted(tuple(t.shape) for t in tl)
    assert tp["blocks"][0]["mixer"]["wq"].shape == \
        jp["blocks"][0]["mixer"]["wq"].shape
    assert np.array_equal(tp["blocks"][0]["ffn"]["w_out"].numpy(),
                          np.asarray(jp["blocks"][0]["ffn"]["w_out"]))


def _leaves(t):
    if isinstance(t, dict):
        return [x for v in t.values() for x in _leaves(v)]
    if isinstance(t, (tuple, list)):
        return [x for v in t for x in _leaves(v)]
    return [t]


def test_fwd_seq_logits_match_jax(models):
    jm, jp, tm, tp, _ = models
    tokens = np.random.default_rng(2).integers(0, 512, (2, 11)).astype(np.int32)
    b, s = tokens.shape
    jx = jm.impl.embed(jp, jnp.asarray(tokens))
    jpos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    jxo, _, jc = jm.impl.fwd_seq(jp, jx, {"positions": jpos},
                                 collect_cache=True)
    jlog = np.asarray(jm.impl.logits_last(jp, jxo[:, -1]))
    tx = tm.impl.embed(tp, torch.from_numpy(tokens))
    tpos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    txo, _, tc = tm.impl.fwd_seq(tp, tx, {"positions": tpos},
                                 collect_cache=True)
    tlog = tm.impl.logits_last(tp, txo[:, -1]).numpy()
    assert np.abs(jlog - tlog).max() < 1e-4
    assert np.abs(np.asarray(jc[0]["k"]) - tc[0]["k"].numpy()).max() < 1e-4


def _jax_tokens(jm, jp, prompt, steps=5):
    """Chunked paged prefill (5, 4, 4) then paged decode, in JAX."""
    lm = jm.impl
    cfg = jm.cfg
    pt = np.full((1, 8), NPAGES, np.int32)
    pt[0, :4] = [3, 5, 7, 9]
    shape = (jm.repeats, NPAGES + 1, PAGE, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    state = {"pool_k": jnp.zeros(shape), "pool_v": jnp.zeros(shape),
             "page_table": jnp.asarray(pt), "ctx": jnp.zeros((1,), jnp.int32)}
    pos = 0
    for chunk in (5, 4, 4):
        logits, state = lm.prefill_chunk_paged(
            jp, state, 0, jnp.asarray(prompt[0, pos:pos + chunk]), pos)
        pos += chunk
    out = [int(jnp.argmax(logits))]
    for _ in range(steps):
        lg, state = lm.decode_step_paged(jp, state, jnp.asarray([out[-1]]))
        out.append(int(jnp.argmax(lg[0])))
    return out, np.asarray(logits)


def _torch_state(tm):
    cfg = tm.cfg
    pt = np.full((1, 8), NPAGES, np.int32)
    pt[0, :4] = [3, 5, 7, 9]
    shape = (tm.repeats, NPAGES + 1, PAGE, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"pool_k": torch.zeros(shape), "pool_v": torch.zeros(shape),
            "page_table": torch.from_numpy(pt),
            "ctx": torch.zeros((1,), dtype=torch.int32)}


def _torch_tokens(tm, tp, prompt, steps=5, fetch=None):
    lm = tm.impl
    state = _torch_state(tm)
    pos = 0
    for chunk in (5, 4, 4):
        logits, state = lm.prefill_chunk_paged(
            tp, state, 0, torch.from_numpy(prompt[0, pos:pos + chunk]), pos)
        pos += chunk
    out = [int(torch.argmax(logits))]
    first_logits = logits.numpy()
    for _ in range(steps):
        lg, state = lm.decode_step_paged(
            tp, state, torch.tensor([out[-1]], dtype=torch.int32),
            fetch=fetch)
        out.append(int(torch.argmax(lg[0])))
    return out, first_logits


def test_chunked_prefill_then_decode_matches_jax(models):
    jm, jp, tm, tp, prompt = models
    jtok, jlog = _jax_tokens(jm, jp, prompt)
    ttok, tlog = _torch_tokens(tm, tp, prompt)
    assert np.abs(jlog - tlog).max() < 1e-4
    assert ttok == jtok


def test_remapped_decode_through_fetch_equals_plain_decode(models):
    jm, jp, tm, tp, prompt = models
    plain, _ = _torch_tokens(tm, tp, prompt)
    plan = make_plan(LAYERS, alpha=1, t_c=1.0, t_t=0.5)
    assert plan.cycle_layers and plan.resident_layers
    res, cyc, maps = split_blocks(tp["blocks"], plan)
    remapped, _ = _torch_tokens(tm, tp, prompt,
                                fetch=make_fetch(res, cyc, maps))
    assert remapped == plain == _jax_tokens(jm, jp, prompt)[0]


def test_split_then_merge_restores_the_stack(models):
    _, _, _, tp, _ = models
    plan = make_plan(LAYERS, alpha=1, t_c=1.0, t_t=0.5)
    res, cyc, maps = split_blocks(tp["blocks"], plan)
    assert list(maps["is_resident"]) == [i in plan.resident_layers
                                         for i in range(LAYERS)]
    merged = merge_blocks(res, cyc, plan)
    for name, leaf in merged[0]["mixer"].items():
        assert torch.equal(leaf, tp["blocks"][0]["mixer"][name])
    assert torch.equal(merged[0]["norm1"], tp["blocks"][0]["norm1"])
