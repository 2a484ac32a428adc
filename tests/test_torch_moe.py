"""The port's MoE FFN against the JAX block on bridged parameters (f32,
CPU): output, aux loss and the ``return_stats`` counts at decode size and at
prefill size, the capacity, a drop pattern forced by skewed routing, and the
MoE LMs (moonshot: MHA; kimi: GQA; MoE on every layer) through chunked
paged prefill and paged decode."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, scaled_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.blocks import MoE as JaxMoE  # noqa: E402
from repro.models.common import tree_init  # noqa: E402

import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models.blocks import MoE  # noqa: E402

ARCH = "moonshot-v1-16b-a3b"
# f32 on both sides; the port sums the expert products in another order
# than XLA (bmm vs dot_general), ~1e-6 relative
TOL = 1e-4
PAGE, NPAGES = 4, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch=ARCH, **moe):
    jc = scaled_config(ARCHS[arch], num_layers=2)
    tc = tcfgs.scaled_config(tcfgs.ARCHS[arch], num_layers=2)
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    return jc, tc


def _layer(jc, seed):
    jp = tree_init(JaxMoE().specs(jc), jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _both(jc, tc, jp, tp, x):
    jy, jaux, jcounts = jax.jit(
        lambda p, x: JaxMoE()(p, x, jc, return_stats=True))(jp, jnp.asarray(x))
    ty, taux, tcounts = MoE()(tp, torch.from_numpy(x), tc, return_stats=True)
    return (np.asarray(jy), float(jaux), np.asarray(jcounts),
            ty.numpy(), float(taux), tcounts.numpy())


@pytest.mark.parametrize("shape", [(8, 128), (2, 40, 128)],
                         ids=["decode", "prefill"])
def test_moe_matches_jax(shape):
    jc, tc = _cfgs()
    jp, tp = _layer(jc, 0)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jy, jaux, jcounts, ty, taux, tcounts = _both(jc, tc, jp, tp, x)
    assert ty.shape == shape
    assert np.abs(jy - ty).max() < TOL
    assert abs(jaux - taux) < TOL
    assert np.array_equal(jcounts, tcounts)
    assert tcounts.sum() == np.prod(shape[:-1]) * tc.moe.top_k


@pytest.mark.parametrize("tokens", [1, 8, 80, 512, 4096])
def test_capacity_is_the_jax_capacity(tokens):
    jc, tc = _cfgs()
    for jm, tm in ((jc.moe, tc.moe),
                   (ARCHS[ARCH].moe, tcfgs.ARCHS[ARCH].moe)):
        assert MoE._capacity(tokens, tm) == JaxMoE._capacity(tokens, jm)


def test_forced_drops_match_jax():
    """Every token near one direction, so all pick the same two experts and
    a capacity of 8 slots drops the later tokens' assignments: the dropped
    tokens' outputs are exactly zero on both sides, and everything else
    agrees."""
    jc, tc = _cfgs(capacity_factor=0.25, min_capacity=1)
    jp, tp = _layer(jc, 2)
    rng = np.random.default_rng(3)
    base = rng.standard_normal(128).astype(np.float32) * 3
    x = (base + 0.05 * rng.standard_normal((24, 128))).astype(np.float32)
    jy, jaux, jcounts, ty, taux, tcounts = _both(jc, tc, jp, tp, x)
    moe = MoE()
    probs, top_e, disp, wcomb, slot, cap = moe.route(
        tp, torch.from_numpy(x), tc)
    e = tc.moe.num_experts
    assert cap == JaxMoE._capacity(24, jc.moe) < 24
    dropped = (slot == e * cap).all(dim=-1).numpy()
    assert dropped.sum() > 0 and (~dropped).sum() > 0
    # the kept slots hold tokens in arrival order, expert by expert
    kept = disp[disp < 24].numpy()
    assert len(kept) == int((slot < e * cap).sum())
    assert np.array_equal(np.abs(jy).max(-1) == 0, dropped)
    assert np.array_equal(np.abs(ty).max(-1) == 0, dropped)
    assert np.abs(jy - ty).max() < TOL
    assert abs(jaux - taux) < TOL
    assert np.array_equal(jcounts, tcounts)


@pytest.fixture(scope="module",
                params=["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b"])
def moe_lm(request):
    jc, tc = _cfgs(request.param)
    jm = jax_build(jc)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(4))
    tm = build_model(tc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    prompt = np.random.default_rng(5).integers(
        0, jc.vocab_size, 13).astype(np.int32)
    return jm, jp, tm, tp, prompt


def _paged_state(repeats, cfg, zeros):
    pt = np.full((1, 8), NPAGES, np.int32)
    pt[0, :4] = [3, 5, 7, 9]
    shape = (repeats, NPAGES + 1, PAGE, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"pool_k": zeros(shape), "pool_v": zeros(shape),
            "page_table": pt, "ctx": np.zeros((1,), np.int32)}


def test_paged_prefill_and_decode_match_jax(moe_lm):
    """Chunked paged prefill (5, 4, 4 tokens) then 4 paged decode steps:
    each chunk's and each step's logits, and the greedy tokens."""
    jm, jp, tm, tp, prompt = moe_lm
    assert [ld.ffn for ld in tm.impl.pattern] == ["moe"]
    js = _paged_state(jm.repeats, jm.cfg, jnp.zeros)
    js = dict(js, page_table=jnp.asarray(js["page_table"]),
              ctx=jnp.asarray(js["ctx"]))
    ts = _paged_state(tm.repeats, tm.cfg, torch.zeros)
    ts = dict(ts, page_table=torch.from_numpy(ts["page_table"]),
              ctx=torch.from_numpy(ts["ctx"]))
    jchunk = jax.jit(jm.impl.prefill_chunk_paged, static_argnums=(2, 4))
    jdec = jax.jit(jm.impl.decode_step_paged)
    pos = 0
    for chunk in (5, 4, 4):
        jl, js = jchunk(jp, js, 0, jnp.asarray(prompt[pos:pos + chunk]), pos)
        tl, ts = tm.impl.prefill_chunk_paged(
            tp, ts, 0, torch.from_numpy(prompt[pos:pos + chunk]), pos)
        assert np.abs(np.asarray(jl) - tl.numpy()).max() < TOL
        pos += chunk
    jtok = [int(jnp.argmax(jl))]
    ttok = [int(torch.argmax(tl))]
    for _ in range(4):
        jl, js = jdec(jp, js, jnp.asarray([jtok[-1]]))
        tl, ts = tm.impl.decode_step_paged(
            tp, ts, torch.tensor([ttok[-1]], dtype=torch.int32))
        assert np.abs(np.asarray(jl) - tl.numpy()).max() < TOL
        jtok.append(int(jnp.argmax(jl[0])))
        ttok.append(int(torch.argmax(tl[0])))
    assert ttok == jtok
    assert int(ts["ctx"][0]) == 17


def test_fwd_seq_aux_matches_jax(moe_lm):
    """The sequence forward sums every MoE layer's aux loss."""
    jm, jp, tm, tp, prompt = moe_lm
    tokens = np.stack([prompt, prompt[::-1]])
    b, s = tokens.shape
    jx = jm.impl.embed(jp, jnp.asarray(tokens))
    jpos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    jxo, jaux, _ = jax.jit(lambda p, x, c: jm.impl.fwd_seq(p, x, c))(
        jp, jx, {"positions": jpos})
    tx = tm.impl.embed(tp, torch.from_numpy(tokens))
    tpos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    txo, taux, _ = tm.impl.fwd_seq(tp, tx, {"positions": tpos})
    assert float(taux) > 0
    assert abs(float(jaux) - float(taux)) < TOL
    assert np.abs(np.asarray(jxo) - txo.numpy()).max() < TOL
