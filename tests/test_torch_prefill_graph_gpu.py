"""The compiled prefill on a CUDA device (skipped elsewhere), held bitwise to
the eager prefill on the same weights:

* the sLSTM time chunk (``models.slstm_graph``): ``Model.prefill`` of a
  16-layer xlstm (two sLSTM layers, one graph) at T = 512 (ck = 64) and at
  T = 509, which has no divisor up to 64 (ck = 1), logits and every state
  leaf; then a dense xlstm tenant through the engine;
* the engine's chunked paged prefill (``serving.prefill_graph``): a 2-layer
  llama and a 2-layer moonshot (MoE) with a step budget that cuts chunks
  of unequal length, and a ``grow_pool`` between two traces (the next
  chunk misses and drops the graphs of the old pools): tokens, pages,
  events, metrics, launches and every request's prefill logits;
* a chunk whose capture fails raises, and nothing prefills eagerly in its
  place; an engine that prefilled through graphs goes without the garbage
  collector.

Imports neither JAX nor ``repro``:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_prefill_graph_gpu.py
"""
import dataclasses
import gc
import sys
import weakref
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import graph_summary, run_record, watch_pages  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import ARCHS, scaled_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serving import ServingEngine, TenantConfig  # noqa: E402
from repro_torch.serving import prefill_graph  # noqa: E402
from repro_torch.serving.traces import tiny_trace  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (prefill graphs are CUDA graphs)")
    return torch.device("cuda")


def _model(arch: str, layers: int, seed: int):
    cfg = dataclasses.replace(scaled_config(ARCHS[arch], num_layers=layers),
                              dtype="bfloat16")
    model = build_model(cfg)
    return cfg, model, model.init(
        torch.Generator(device="cuda").manual_seed(seed), "cuda")


def _equal_trees(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.gpu
@pytest.mark.parametrize("t, ck", [(512, 64), (509, 1)])
def test_slstm_chunk_graph_is_the_eager_loop_bitwise(cuda, t, ck):
    cfg, model, params = _model("xlstm-1.3b", 16, 0)
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, t), generator=g,
                                     device="cuda")}
    ref = model.prefill(params, batch, t + 8, graphs=False)
    assert not model.slstm_graphs.graphs
    for call in range(2):
        out = model.prefill(params, batch, t + 8)
        torch.cuda.synchronize()
        assert torch.equal(out[0], ref[0]) and _equal_trees(out[1], ref[1])
        st = model.slstm_graphs.stats
        # two sLSTM layers share the one graph: its first chunk captures
        assert (st.captures, st.replays) == (1, (call + 1) * 2 * t // ck - 1)
    assert list(model.slstm_graphs.graphs)[0][:2] == (2, ck)


def _run(tenants, graphs: bool, prompt: int = 37, grow: bool = False, **kw):
    """Two traces of 3 requests a tenant through a fresh engine with the
    prefill graphs on or off (decode graphs on in both), with ``grow``
    each paged pool grown by 8 pages between them. Returns (run_record,
    launches, the kept prefill logits, prefill graph counters)."""
    kw = {"mode": "mirage", "base_kv_pages": 256, "page_size": 8,
          "keep_prefill_logits": True, **kw}
    eng = ServingEngine(tenants, device="cuda", prefill_graphs=graphs, **kw)
    freed = watch_pages(eng)
    vocab = min(tc.cfg.vocab_size for tc in tenants.values())
    kernels.reset_launch_counts()
    for seed in (3, 4):
        trace = tiny_trace(list(tenants), n_per_model=3, prompt_len=prompt,
                           max_new=6, vocab=vocab, seed=seed)
        for r in trace:
            r.rid = f"{r.rid}-{seed}"
        eng.submit(trace)
        eng.run(max_steps=1000)
        if grow:
            for t in eng.tenants.values():
                t.grow_pool(t.state["pool_k"].shape[1] - 1 + 8)
    torch.cuda.synchronize()
    assert not eng.busy()
    return (run_record(eng, freed), kernels.launch_counts(),
            eng.prefill_logits, graph_summary(eng, "prefill"))


def _same(graph, eager):
    rec, counts, logits, stats = graph
    e_rec, e_counts, e_logits, e_stats = eager
    assert rec == e_rec and counts == e_counts
    assert sorted(logits) == sorted(e_logits) and len(logits) > 0
    for rid, a in logits.items():
        assert torch.equal(a, e_logits[rid]), rid
    assert not e_stats and stats["replays"] > 0
    return rec, stats


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3-8b", "moonshot-v1-16b-a3b"])
def test_chunked_prefill_graphs_match_eager(cuda, arch):
    """Chunks of at most 16 tokens under a step budget of 40: prompts of
    37 tokens come in chunks of 16, 8, 5 and others, each length captured
    once; the pool grows between the traces, and the next chunk misses."""
    cfg, _, params = _model(arch, 2, 2)

    def run(graphs):
        return _run({"A": TenantConfig(cfg, params, max_batch=4,
                                       max_context=64, paged=True)},
                    graphs, grow=True, prefill_chunk_tokens=16,
                    step_tokens=40)
    rec, stats = _same(run(True), run(False))
    assert stats["captures"] >= 4 and stats["dropped"] > 0
    assert rec["tokens"] and all(len(g) == 6 for g in rec["tokens"].values())


@pytest.mark.gpu
def test_dense_xlstm_tenant_prefill_graphs_match_eager(cuda):
    """A dense xlstm tenant (16 layers): each prompt's two sLSTM layers
    replay the model's chunk graph."""
    cfg, _, params = _model("xlstm-1.3b", 16, 5)
    rec, stats = _same(*(
        _run({"X": TenantConfig(cfg, params, max_batch=4, max_context=96,
                                paged=False)}, graphs, prompt=64)
        for graphs in (True, False)))
    assert stats["captures"] == 1


@pytest.mark.gpu
def test_a_failed_prefill_capture_raises(cuda, monkeypatch):
    """A chunk that waits for the device (``.item()``) cannot be captured:
    the engine raises, and prefills nothing eagerly in its place."""
    cfg, _, params = _model("llama3-8b", 2, 6)
    body = prefill_graph.chunk_logits

    def syncing(*args):
        logits, choice = body(*args)
        logits.sum().item()
        return logits, choice
    monkeypatch.setattr(prefill_graph, "chunk_logits", syncing)
    eager = []
    real = LM.prefill_chunk_paged
    monkeypatch.setattr(LM, "prefill_chunk_paged",
                        lambda *a, **k: eager.append(a) or real(*a, **k))
    eng = ServingEngine({"A": TenantConfig(cfg, params, max_batch=2,
                                           max_context=48, paged=True)},
                        base_kv_pages=64, page_size=8, device="cuda",
                        prefill_chunk_tokens=8)
    eng.submit(tiny_trace(["A"], n_per_model=2, prompt_len=12, max_new=4,
                          vocab=cfg.vocab_size, seed=3))
    with pytest.raises(RuntimeError, match="prefill graph capture failed"):
        eng.run(max_steps=50)
    assert not eager
    assert eng.graph_stats("prefill")["A"]["captures"] == 0


@pytest.mark.gpu
def test_an_engine_with_prefill_graphs_goes_without_the_collector(cuda):
    """No chunk graph holds its tenant: the engine is freed as soon as it
    is dropped, its pools and graphs with it."""
    cfg, _, params = _model("llama3-8b", 2, 7)
    eng = ServingEngine({"A": TenantConfig(cfg, params, max_batch=4,
                                           max_context=64, paged=True)},
                        base_kv_pages=64, page_size=8, device="cuda",
                        prefill_chunk_tokens=8)
    eng.submit(tiny_trace(["A"], n_per_model=3, prompt_len=20, max_new=4,
                          vocab=cfg.vocab_size, seed=3))
    eng.run()
    assert eng.graph_stats("prefill")["A"]["replays"] > 0
    torch.cuda.synchronize()
    gc.collect()
    held = torch.cuda.memory_allocated()
    gc.disable()
    try:
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
        assert torch.cuda.memory_allocated() < held
    finally:
        gc.enable()
