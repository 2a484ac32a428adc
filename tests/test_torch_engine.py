"""The port's ServingEngine against the JAX engine: the same trace and the
same bridged parameters (f32, CPU) must give identical generated tokens,
event logs (prefill, remap, revert, ...), allocator segments and page-id
bound, and TransferStats, with the allocator's invariants intact."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs import ARCHS, scaled_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import TenantConfig as JaxTenant  # noqa: E402
from repro.serving import traces as jax_traces  # noqa: E402

import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.serving import ServingEngine, TenantConfig  # noqa: E402
from repro_torch.serving import traces as torch_traces  # noqa: E402

ARCH_OF = {"A": ("llama3-8b", 0), "B": ("h2o-danube-3-4b", 1)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    out = {}
    for name, (arch, seed) in ARCH_OF.items():
        cfg = scaled_config(ARCHS[arch], num_layers=2)
        jp = jax_build(cfg).init(jax.random.PRNGKey(seed))
        tcfg = tcfgs.scaled_config(tcfgs.ARCHS[arch], num_layers=2)
        out[name] = (cfg, jp, tcfg,
                     params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    return out


def _trace(traces, case):
    if case["trace"] == "conversation":
        return traces.multi_turn_trace([traces.ConversationSpec(
            "A", num_sessions=3, turns=2, system_prompt_len=8, user_len=4,
            assistant_len=4, max_new_tokens=4, think_time=8.0,
            session_rate=0.05, vocab=256, sigma=0.0)], seed=5)
    return traces.tiny_trace(case["tenants"], n_per_model=3, prompt_len=18,
                             max_new=6, vocab=256)


def _run(side, weights, case):
    jax_side = side == "jax"
    eng_cls, tenant_cls, traces = (
        (JaxEngine, JaxTenant, jax_traces) if jax_side else
        (ServingEngine, TenantConfig, torch_traces))
    tenants = {}
    for name in case["tenants"]:
        cfg, jp, tcfg, tp = weights[name]
        tenants[name] = tenant_cls(cfg if jax_side else tcfg,
                                   jp if jax_side else tp, max_batch=4,
                                   max_context=64, paged=True)
    kw = {} if jax_side else {"device": "cpu"}
    eng = eng_cls(tenants, mode="mirage", scheduler="temporal",
                  base_kv_pages=case["pages"], page_size=4, quantum_steps=4,
                  prefix_sharing=case["sharing"],
                  prefill_chunk_tokens=case["chunk"], watermark_tokens=4,
                  **kw)
    eng.submit(_trace(traces, case))
    eng.run(max_steps=2000)
    eng.allocator.check_invariants()
    for idx in eng.prefix.values():
        idx.check_invariants()
    return {
        "generated": {r.rid: list(r.generated) for r in eng.finished},
        "events": list(eng.events),
        "segments": [(s.source, s.num_pages) for s in eng.allocator.segments],
        "page_id_bound": eng.allocator.page_id_bound,
        "stats": dataclasses.asdict(eng.xfer.stats),
    }


CASES = {
    "monolithic": dict(tenants=["A"], trace="conversation", chunk=0,
                       sharing=False, pages=64),
    "monolithic_shared": dict(tenants=["A"], trace="conversation", chunk=0,
                              sharing=True, pages=64),
    "chunked7": dict(tenants=["A"], trace="conversation", chunk=7,
                     sharing=False, pages=64),
    "chunked7_shared": dict(tenants=["A"], trace="conversation", chunk=7,
                            sharing=True, pages=64),
    # the two-tenant case of test_chunked_prefill_under_memory_pressure
    "pressure": dict(tenants=["A", "B"], trace="tiny", chunk=7,
                     sharing=False, pages=8),
}


@pytest.mark.parametrize("case", CASES)
def test_engine_matches_jax_engine(weights, case):
    ref = _run("jax", weights, CASES[case])
    out = _run("torch", weights, CASES[case])
    assert out == ref
    assert len(out["generated"]) == 6
    kinds = {k for _, k, _ in out["events"]}
    assert "prefill" in kinds
    if case == "pressure":
        assert "remap" in kinds


def test_unported_paths_raise(weights):
    """A tenant striped over shards (``TenantSpec(shards=2)``) raises
    ``NotImplementedError`` naming the ROADMAP on both backends, as
    ``PerfModel(shards=2)`` does, until ``distributed/`` is ported; every
    config builds as a dense (paged=False) tenant, enc-dec (whisper) and
    VLM (llava) too (tests/test_torch_engine_encdec.py serves them), while
    paged=True is refused with a ValueError for whisper and llava (the
    reference has no correct paged answer for either: ROADMAP queue 3) and
    for a stack with Mamba layers (the JAX engine asserts the same)."""
    from repro_torch.serving import (
        GH200, PerfModel, RuntimeConfig, TenantSpec,
    )
    cfg, jp, tcfg, tp = weights["A"]
    conf = RuntimeConfig(tenants={"A": TenantSpec(tcfg, params=tp,
                                                  paged=True, shards=2)})
    for backend, kw in (("sim", {}), ("engine", {"device": "cpu"})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            conf.build(backend, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PerfModel(tcfg, GH200, shards=2)
    for arch, what in (("whisper-medium", "an encoder-decoder"),
                       ("llava-next-34b", "a VLM prefix")):
        mcfg = tcfgs.scaled_config(tcfgs.ARCHS[arch], num_layers=2)
        params = build_model(mcfg).init(torch.Generator().manual_seed(0),
                                        "cpu")
        with pytest.raises(ValueError, match=f"does not serve {what}"):
            ServingEngine({"W": TenantConfig(mcfg, params, paged=True)},
                          device="cpu")
        dense = ServingEngine({"W": TenantConfig(mcfg, params, paged=False)},
                              device="cpu")
        assert dense.tenants["W"].state["pos"].shape == (8,)
    jamba = tcfgs.scaled_config(tcfgs.ARCHS["jamba-v0.1-52b"], num_layers=4)
    with pytest.raises(ValueError, match="needs an attention stack"):
        ServingEngine({"J": TenantConfig(jamba, tp, paged=True)},
                      device="cpu")


def test_prefill_logits_kept_per_request_agree_across_prefill_paths(weights):
    """``keep_prefill_logits`` records each request's first-token logits;
    monolithic and chunked prefill give the same ones (f32, CPU)."""
    _, _, tcfg, tp = weights["A"]
    kept = []
    for chunk in (0, 7):
        eng = ServingEngine({"A": TenantConfig(tcfg, tp, max_batch=4,
                                               max_context=64, paged=True)},
                            page_size=4, prefill_chunk_tokens=chunk,
                            device="cpu", keep_prefill_logits=True)
        eng.submit(torch_traces.tiny_trace(["A"], n_per_model=3,
                                           prompt_len=18, max_new=2,
                                           vocab=256))
        eng.run()
        assert sorted(eng.prefill_logits) == sorted(r.rid for r in eng.finished)
        for r in eng.finished:
            assert eng.prefill_logits[r.rid].shape == (tcfg.vocab_size,)
            assert int(eng.prefill_logits[r.rid].argmax()) == r.generated[0]
        kept.append(eng.prefill_logits)
    for rid, logits in kept[0].items():
        assert (logits - kept[1][rid]).abs().max().item() < 1e-4
