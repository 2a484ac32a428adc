"""The engine's compiled decode step on a CUDA device (skipped elsewhere):
one trace through an engine that decodes through captured CUDA graphs
(``decode_graphs=True``, the default) and through one that decodes eagerly
(``decode_graphs=False``) must give identical tokens, allocator pages, event
logs, ``ServingMetrics``, host-to-device bytes and kernel launches, and
bitwise equal logits at every step. Covered: a remapped paged tenant
streaming at β = 1 and 2, two paged tenants under KV pressure (a remap,
pool growths: the cache misses and drops stale graphs), and every
other stack the engine serves at a scaled width in bf16: MoE (moonshot,
paged), xLSTM (dense, also remapped), jamba, danube's ring, whisper and
llava (dense). Last, a capture that fails raises. Imports neither JAX nor
``repro``:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_decode_graph_gpu.py
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
from repro_torch.core.layer_selection import make_plan  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ServingEngine, TenantConfig  # noqa: E402
from repro_torch.serving import decode_graph  # noqa: E402
from repro_torch.serving.traces import tiny_trace  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (decode graphs are CUDA graphs)")
    return torch.device("cuda")


def _model(arch: str, layers: int, seed: int):
    cfg = dataclasses.replace(scaled_config(ARCHS[arch], num_layers=layers),
                              dtype="bfloat16")
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(seed), "cuda")
    return cfg, params


def _run(tenants, graphs: bool, plan=None, prompt=20, new=12, **kw):
    """One trace (3 requests a tenant) through a fresh engine. ``plan``:
    (tenant, RemapPlan) applied before the run, so the tenant streams its
    cycling repeats from the start. Returns (run_record, launches, each
    step's logits on the host, graph counters)."""
    kw = {"mode": "mirage", "base_kv_pages": 256, "page_size": 8, **kw}
    eng = ServingEngine(tenants, device="cuda", decode_graphs=graphs, **kw)
    if plan is not None:
        eng.xfer.apply_plan(*plan)
    freed = watch_pages(eng)
    logits, decode = [], eng._decode_tokens

    def recorded(t, tokens, p):
        out, choices = decode(t, tokens, p)
        logits.append((t.name, out.float().cpu()))
        return out, choices
    eng._decode_tokens = recorded
    vocab = min(tc.cfg.vocab_size for tc in tenants.values())
    eng.submit(tiny_trace(list(tenants), n_per_model=3, prompt_len=prompt,
                          max_new=new, vocab=vocab, seed=3))
    kernels.reset_launch_counts()
    eng.run(max_steps=1000)
    torch.cuda.synchronize()
    assert not eng.busy()
    eng.allocator.check_invariants()
    return (run_record(eng, freed), kernels.launch_counts(), logits,
            graph_summary(eng))


def _same(graph, eager):
    rec, counts, logits, stats = graph
    e_rec, e_counts, e_logits, e_stats = eager
    assert rec == e_rec
    assert counts == e_counts
    assert len(logits) == len(e_logits) > 0
    for (n, a), (m, b) in zip(logits, e_logits):
        assert n == m and torch.equal(a, b)
    assert not e_stats and stats["replays"] > 0
    return rec, counts, stats


@pytest.mark.gpu
@pytest.mark.parametrize("beta", [1, 2])
def test_remapped_paged_tenant_graphs_match_eager(cuda, beta):
    """A paged llama streaming 2 of its 8 repeats (m = 2 + β cycling through
    β slot buffers) from pinned host memory inside the graph."""
    cfg, params = _model("llama3-8b", 8, 0)
    plan = make_plan(8, 2, t_c=1.0, t_t=1e-9,
                     mode="single" if beta == 1 else "double")
    assert plan.beta == beta

    def run(graphs):
        return _run({"A": TenantConfig(cfg, params, max_batch=4,
                                       max_context=64, paged=True)},
                    graphs, plan=("A", plan))
    rec, counts, stats = _same(run(True), run(False))
    assert rec["host_fetch_bytes"] > 0 and counts["paged_decode_attention"]
    assert stats["captures"] == 1


@pytest.mark.gpu
def test_kv_pressure_recaptures_and_drops(cuda):
    """Two paged tenants on 16 pages with chunked prefill: the controller
    remaps (the pools grow, a tenant streams its cycling repeats); every
    growth and tier switch misses the cache and drops the stale graphs."""
    tenants = {}
    for name, seed in (("A", 1), ("B", 2)):
        cfg, params = _model("llama3-8b", 4, seed)
        tenants[name] = TenantConfig(cfg, params, max_batch=4,
                                     max_context=96, paged=True)
    kw = dict(base_kv_pages=16, page_size=4, prefill_chunk_tokens=16,
              prompt=40, new=16)
    rec, counts, stats = _same(_run(tenants, True, **kw),
                               _run(tenants, False, **kw))
    kinds = [k for _, k, _ in rec["events"]]
    assert "remap" in kinds and rec["host_fetch_bytes"] > 0
    assert stats["captures"] > 2 and stats["dropped"] > 0


STACKS = {
    "moonshot_paged": ("moonshot-v1-16b-a3b", 2, True, None),
    "xlstm": ("xlstm-1.3b", 16, False, None),
    "xlstm_remapped": ("xlstm-1.3b", 32, False, 1),
    "jamba": ("jamba-v0.1-52b", 8, False, None),
    "danube_ring": ("h2o-danube-3-4b", 2, False, None),
    "whisper": ("whisper-medium", 2, False, None),
    "llava": ("llava-next-34b", 2, False, None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("stack", STACKS)
def test_every_stack_graphs_match_eager(cuda, stack):
    """One tenant of each other stack: MoE routing (moonshot) and the dense
    decode states (recurrent, Mamba, ring, cross-attention, a VLM prefix)
    under capture; xlstm also with 1 of its 4 repeats donated."""
    arch, layers, paged, alpha = STACKS[stack]
    cfg, params = _model(arch, layers, 4)
    repeats = build_model(cfg).repeats
    plan = None if alpha is None else (
        cfg.name, make_plan(repeats, alpha, t_c=1.0, t_t=1e-9,
                            mode="single"))
    max_context = cfg.num_image_patches + 64
    # danube's window is 64 slots: prompts of 60 tokens wrap its ring
    prompt = 60 if cfg.sliding_window else 20

    def run(graphs):
        return _run({cfg.name: TenantConfig(
            cfg, params, max_batch=4, max_context=max_context + prompt,
            paged=paged)}, graphs, plan=plan, prompt=prompt)
    rec, _, stats = _same(run(True), run(False))
    assert stats["captures"] == 1
    assert (rec["host_fetch_bytes"] > 0) == (plan is not None)


@pytest.mark.gpu
def test_an_engine_with_graphs_goes_without_the_collector(cuda):
    """No graph holds its tenant: an engine that decoded through graphs
    (and remapped, so its graph streams) is freed as soon as it is
    dropped, its pools, graphs and pinned stacks with it, without waiting
    for the garbage collector."""
    cfg, params = _model("llama3-8b", 8, 6)
    eng = ServingEngine({"A": TenantConfig(cfg, params, max_batch=4,
                                           max_context=64, paged=True)},
                        base_kv_pages=64, page_size=8, device="cuda")
    eng.xfer.apply_plan("A", make_plan(8, 2, t_c=1.0, t_t=1e-9,
                                       mode="single"))
    eng.submit(tiny_trace(["A"], n_per_model=3, prompt_len=20, max_new=8,
                          vocab=cfg.vocab_size, seed=3))
    eng.run()
    assert eng.graph_stats()["A"]["replays"] > 0
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


@pytest.mark.gpu
def test_a_failed_capture_raises(cuda, monkeypatch):
    """A step that waits for the device (``.item()``) cannot be captured:
    the engine raises, and decodes nothing eagerly in its place."""
    cfg, params = _model("llama3-8b", 2, 5)
    step = decode_graph.decode_fn

    def syncing(t, state, tokens, fetch=None):
        logits, out = step(t, state, tokens, fetch)
        logits.sum().item()
        return logits, out
    monkeypatch.setattr(decode_graph, "decode_fn", syncing)
    eng = ServingEngine({"A": TenantConfig(cfg, params, max_batch=2,
                                           max_context=48, paged=True)},
                        base_kv_pages=64, page_size=8, device="cuda")
    eager = []
    monkeypatch.setattr(eng, "_decode_fn", lambda *a: eager.append(a))
    eng.submit(tiny_trace(["A"], n_per_model=2, prompt_len=12, max_new=4,
                          vocab=cfg.vocab_size, seed=3))
    with pytest.raises(RuntimeError, match="decode graph capture failed"):
        eng.run(max_steps=50)
    assert not eager
    assert eng.graph_stats()["A"]["captures"] == 0
