"""The compiled prefill on the CPU. The graphs themselves need a card
(``test_torch_prefill_graph_gpu.py``); here:

* the routing rule (``kernels.graphs.replayable``): a graph is never taken
  on the CPU, under autograd, under a mesh or during a capture, and
  ``SLSTM.fwd_seq`` then runs its eager loop;
* the sLSTM chunk cache's driver (``SLSTMGraphs.run``: the carry written
  back into the buffers, the chunks copied in and out, ck = 1 at a T with
  no divisor up to 64) with each "replay" run eagerly on the CPU, bitwise
  against the eager loop;
* a captured chunk's body (``serving.prefill_graph.chunk_logits``: every
  position from a device tensor) bitwise against ``prefill_chunk_paged``
  over tail chunks of unequal length, llama and moonshot (MoE);
* which changes make a chunk key miss (chunk length, page-table width, the
  pools' storage after ``grow_pool``) and the engine's ``prefill_graphs``
  switch;
* the eager sLSTM loop and ``prefill_chunk_paged`` still held to the JAX
  reference on the same parameters (``params_from_jax``)."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import scaled_config as jax_scaled  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402

from repro_torch.configs import ARCHS, scaled_config  # noqa: E402
from repro_torch.kernels import graphs  # noqa: E402
from repro_torch.models import blocks, build_model, params_from_jax  # noqa: E402
from repro_torch.models import slstm_graph  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.serving import ServingEngine, TenantConfig  # noqa: E402
from repro_torch.serving import traces  # noqa: E402
from repro_torch.serving.prefill_graph import (  # noqa: E402
    chunk_logits, prefill_key,
)

# f32 on both sides; the port sums in another order than XLA
JAX_TOL = 1e-4
NPAGES, PAGE = 16, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- routing
CUDA_LIKE = types.SimpleNamespace(is_cuda=True)


@pytest.mark.parametrize("case, expected", [
    ("cpu", False), ("autograd", False), ("mesh", False),
    ("capturing", False), ("cuda, no grad, no mesh, no capture", True)])
def test_replayable_routes_only_cuda_work_without_grad_mesh_or_capture(
        monkeypatch, case, expected):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: case == "capturing")
    x = torch.zeros(2) if case == "cpu" else CUDA_LIKE
    mesh = object() if case == "mesh" else None
    with torch.set_grad_enabled(case == "autograd"):
        assert graphs.replayable(x, mesh) is expected


class Refusing(slstm_graph.SLSTMGraphs):
    def run(self, *args):
        raise AssertionError("the sLSTM graph was taken")


class Rehearsal(slstm_graph.SLSTMGraphs):
    """``SLSTMGraphs`` whose chunk "graphs" run their body eagerly on the
    CPU: the warm-up once, then each replay."""

    def _graph(self, wx, w, ck):
        g = slstm_graph._ChunkGraph(wx, w, ck, None, None)

        def warm_and_capture(cell, key):
            g.cell = cell
            g._body(cell)
        g.warm_and_capture = warm_and_capture
        g.replay = lambda key: g._body(g.cell)
        return g


def _xlstm(layers: int = 16, seed: int = 0):
    cfg = scaled_config(ARCHS["xlstm-1.3b"], num_layers=layers)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(seed), "cpu")


def _prompt(vocab: int, t: int, b: int = 1, seed: int = 1) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (b, t)).astype(np.int64))


def _as_if_on_cuda(monkeypatch):
    """``SLSTM.fwd_seq`` routes CPU work as if it lay on a card (every
    other condition of ``replayable`` unchanged)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(blocks, "replayable", lambda x, mesh=None:
                        graphs.replayable(CUDA_LIKE, mesh))


def test_slstm_never_replays_on_the_cpu():
    cfg, model, params = _xlstm(8)
    tokens = _prompt(cfg.vocab_size, 12)
    model.slstm_graphs = Refusing()
    logits, state = model.prefill(params, {"tokens": tokens}, 16)
    ref_logits, ref_state = model.prefill(params, {"tokens": tokens}, 16,
                                          graphs=False)
    assert torch.equal(logits, ref_logits)
    for a, b in zip(tree_leaves(state), tree_leaves(ref_state)):
        assert torch.equal(a, b)


def test_slstm_takes_the_graph_only_without_grad_or_capture(monkeypatch):
    """With CPU work routed as if on a card: ``Model.prefill`` (no grad)
    replays; the training loss (autograd) and a prefill during a capture
    run the eager loop."""
    _as_if_on_cuda(monkeypatch)
    cfg, model, params = _xlstm(8)
    tokens = _prompt(cfg.vocab_size, 12)
    model.slstm_graphs = Rehearsal()
    model.prefill(params, {"tokens": tokens}, 16)
    assert model.slstm_graphs.stats.captures == 1
    model.slstm_graphs = Refusing()
    batch = {"tokens": tokens, "targets": tokens,
             "mask": torch.ones(tokens.shape)}
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    model.train_loss(params, batch, remat_policy="none").backward()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    model.prefill(params, {"tokens": tokens}, 16)


@pytest.mark.parametrize("t, ck", [(128, 64), (67, 1), (24, 24)])
def test_slstm_chunk_driver_is_the_eager_loop_bitwise(monkeypatch, t, ck):
    """Two sLSTM layers (16 layers): one capture, then every other chunk of
    both layers a replay of the same graph (the second layer copies its own
    r and b in); logits and every state leaf bitwise the eager loop's."""
    _as_if_on_cuda(monkeypatch)
    cfg, model, params = _xlstm(16)
    tokens = _prompt(cfg.vocab_size, t, b=2)
    model.slstm_graphs = Rehearsal()
    logits, state = model.prefill(params, {"tokens": tokens}, t + 4)
    ref_logits, ref_state = model.prefill(params, {"tokens": tokens}, t + 4,
                                          graphs=False)
    assert torch.equal(logits, ref_logits)
    for a, b in zip(tree_leaves(state), tree_leaves(ref_state)):
        assert torch.equal(a, b)
    st = model.slstm_graphs.stats
    assert (st.captures, st.replays) == (1, 2 * t // ck - 1)
    assert list(model.slstm_graphs.graphs) == [
        (2, ck, cfg.num_heads, cfg.resolved_head_dim, torch.float32,
         torch.float32, torch.device("cpu"))]


def test_slstm_graphs_of_one_cache_share_the_weight_buffers(monkeypatch):
    """Two chunk lengths (T 24, then 20): two graphs reading one pair of r
    and b buffers; the second prefill still bitwise the eager loop's."""
    _as_if_on_cuda(monkeypatch)
    cfg, model, params = _xlstm(16)
    model.slstm_graphs = Rehearsal()
    for t in (24, 20):
        batch = {"tokens": _prompt(cfg.vocab_size, t)}
        logits, _ = model.prefill(params, batch, 32)
        assert torch.equal(logits, model.prefill(params, batch, 32,
                                                 graphs=False)[0])
    graphs = model.slstm_graphs.graphs.values()
    assert len(graphs) == 2 and len({id(g.w) for g in graphs}) == 1


# ------------------------------------------------- the chunked prefill
def _paged(arch: str, seed: int):
    cfg = scaled_config(ARCHS[arch], num_layers=2)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(seed), "cpu")


def _pools(model, cfg):
    shape = (model.repeats, NPAGES + 1, PAGE, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    pt = np.full((2, 8), NPAGES, np.int32)
    pt[1, :4] = [3, 5, 7, 9]
    return {"pool_k": torch.zeros(shape), "pool_v": torch.zeros(shape),
            "page_table": torch.from_numpy(pt),
            "ctx": torch.zeros((2,), dtype=torch.int32)}


@pytest.mark.parametrize("arch", ["llama3-8b", "moonshot-v1-16b-a3b"])
def test_chunk_body_is_prefill_chunk_paged_bitwise(arch):
    """Chunks of 6, 5 and 3 tokens for row 1: the graph's body on fixed
    buffers (start, row and tokens as device tensors) against the eager
    step, logits, argmax and both pools bitwise."""
    cfg, model, params = _paged(arch, 3)
    lm = model.impl
    eager, fixed = _pools(model, cfg), _pools(model, cfg)
    prompt = _prompt(cfg.vocab_size, 14)[0]
    pos = 0
    for s in (6, 5, 3):
        tokens = prompt[pos:pos + s]
        ref, eager = lm.prefill_chunk_paged(params, eager, 1, tokens, pos)
        logits, choice = chunk_logits(
            lm, params, fixed["pool_k"], fixed["pool_v"],
            fixed["page_table"][1].clone(), tokens.clone(),
            torch.tensor([pos], dtype=torch.int32))
        assert torch.equal(logits, ref)
        assert int(choice) == int(torch.argmax(ref))
        for name in ("pool_k", "pool_v"):
            assert torch.equal(fixed[name], eager[name])
        pos += s
    assert int(eager["ctx"][1]) == 14


def _engine(tenants, **kw):
    kw = {"mode": "mirage", "base_kv_pages": 64, "page_size": 4,
          "prefill_chunk_tokens": 8, **kw}
    return ServingEngine(tenants, device="cpu", **kw)


@pytest.fixture(scope="module")
def llama():
    return _paged("llama3-8b", 0)


@pytest.mark.parametrize("change", ["chunk length", "page-table width",
                                    "grow_pool"])
def test_chunk_key_misses_on(llama, change):
    cfg, _, params = llama
    eng = _engine({"A": TenantConfig(cfg, params, max_batch=2,
                                     max_context=32, paged=True)})
    t = eng.tenants["A"]
    key = prefill_key(t, 8)
    assert prefill_key(t, 8) == key and key.live_with(key)
    if change == "chunk length":
        new = prefill_key(t, 5)
        assert new != key and key.live_with(new)
    elif change == "page-table width":
        other = _engine({"A": TenantConfig(cfg, params, max_batch=2,
                                           max_context=64, paged=True)})
        new = prefill_key(other.tenants["A"], 8)
        assert new.shape == (8, 16) and key.shape == (8, 8)
    else:
        t.grow_pool(t.state["pool_k"].shape[1] + 8)
        new = prefill_key(t, 8)
        assert new.shape == key.shape and not key.live_with(new)


def test_engine_prefill_graphs_switch_runs_eagerly_on_the_cpu(llama):
    """``prefill_graphs`` (on by default) has no effect on the CPU: no
    chunk graphs, the model's sLSTM cache untouched, no prefill counters,
    the same run as with the switch off."""
    cfg, _, params = llama
    runs = []
    for on in (True, False):
        eng = _engine({"A": TenantConfig(cfg, params, max_batch=2,
                                         max_context=48, paged=True)},
                      prefill_graphs=on, keep_prefill_logits=True)
        t = eng.tenants["A"]
        assert t.prefill_graphs is None and not t.compiled_prefill
        eng.submit(traces.tiny_trace(["A"], n_per_model=3, prompt_len=19,
                                     max_new=4, vocab=cfg.vocab_size, seed=2))
        eng.run(max_steps=200)
        assert eng.graph_stats("prefill") == {} == eng.graph_stats()
        assert not t.model.slstm_graphs.graphs
        runs.append(({r.rid: r.generated for r in eng.finished}, eng.events,
                      eng.prefill_logits))
    assert runs[0][:2] == runs[1][:2]
    for rid, a in runs[0][2].items():
        assert torch.equal(a, runs[1][2][rid])
    with pytest.raises(ValueError, match="graph kind"):
        eng.graph_stats("train")


# ------------------------------------------- against the JAX reference
def test_eager_slstm_prefill_still_matches_jax():
    """xlstm at 8 layers (7 mLSTM, 1 sLSTM), T = 67 (ck = 1): the eager
    loop against the JAX prefill."""
    cfg = jax_scaled(JAX_ARCHS["xlstm-1.3b"], num_layers=8)
    jm = jax_build(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(4))
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 67)).astype(np.int32)
    jlog, _ = jax.jit(jm.prefill, static_argnums=(2,))(
        jp, {"tokens": jnp.asarray(tokens)}, 72)
    model = build_model(scaled_config(ARCHS["xlstm-1.3b"], num_layers=8))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int64))}
    eager, _ = model.prefill(tp, batch, 72, graphs=False)
    assert np.abs(eager.numpy() - np.asarray(jlog)).max() < JAX_TOL


def test_prefill_chunk_paged_and_chunk_body_still_match_jax():
    """llama 2 layers: chunks of 5, 4 and 4 tokens through the JAX
    reference's ``prefill_chunk_paged``, the port's eager step and the
    graph's body; last logits."""
    cfg = jax_scaled(JAX_ARCHS["llama3-8b"], num_layers=2)
    jm = jax_build(cfg)
    jp = jm.init(jax.random.PRNGKey(6))
    tmodel = build_model(scaled_config(ARCHS["llama3-8b"], num_layers=2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, 13).astype(np.int32)
    st = _pools(tmodel, tmodel.cfg)
    jst = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
    eager, fixed = _pools(tmodel, tmodel.cfg), _pools(tmodel, tmodel.cfg)
    jchunk = jax.jit(jm.impl.prefill_chunk_paged, static_argnums=(2, 4))
    pos = 0
    for s in (5, 4, 4):
        jlog, jst = jchunk(jp, jst, 1, jnp.asarray(prompt[pos:pos + s]), pos)
        chunk = torch.from_numpy(prompt[pos:pos + s].astype(np.int64))
        tlog, eager = tmodel.impl.prefill_chunk_paged(tp, eager, 1, chunk, pos)
        glog, _ = chunk_logits(tmodel.impl, tp, fixed["pool_k"],
                               fixed["pool_v"], fixed["page_table"][1], chunk,
                               torch.tensor([pos], dtype=torch.int32))
        pos += s
    assert np.abs(tlog.numpy() - np.asarray(jlog)).max() < JAX_TOL
    assert torch.equal(glog, tlog)
