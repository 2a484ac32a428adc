"""The engine's compiled decode step on the CPU: the cache key of a tenant's
decode graph (``serving.decode_graph.decode_key``) and the host mirrors of
the page table and write cursors that feed a graph's fixed buffers. The
graphs themselves need a card (``test_torch_decode_graph_gpu.py``); here the
engine decodes eagerly and reads its page table from the mirror."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, scaled_config  # noqa: E402
from repro_torch.core.layer_selection import RemapPlan  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ServingEngine, TenantConfig  # noqa: E402
from repro_torch.serving import traces  # noqa: E402
from repro_torch.serving.decode_graph import decode_key  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(arch: str, layers: int, seed: int):
    cfg = scaled_config(ARCHS[arch], num_layers=layers)
    return cfg, build_model(cfg).init(
        torch.Generator().manual_seed(seed), "cpu")


@pytest.fixture(scope="module")
def llama():
    return _params("llama3-8b", 4, 0)


@pytest.fixture(scope="module")
def danube():
    return _params("h2o-danube-3-4b", 2, 1)


def _engine(tenants, **kw):
    kw = {"mode": "mirage", "base_kv_pages": 64, "page_size": 4,
          "watermark_tokens": 4, "quantum_steps": 4, **kw}
    return ServingEngine(tenants, device="cpu", **kw)


def _key(eng, name):
    t = eng.tenants[name]
    return decode_key(t, eng.xfer.plans[name], eng.xfer.split[name])


def _plan(n: int, cycle) -> RemapPlan:
    """A plan with one donated repeat whose cycle set is ``cycle``."""
    return RemapPlan(n, 1, len(cycle), tuple(cycle),
                     tuple(i for i in range(n) if i not in cycle))


def test_key_is_stable_across_steps_that_change_only_inputs(llama):
    """Tokens, page-table rows and cursors change every step; the key does
    not: one graph serves the whole run."""
    cfg, p = llama
    eng = _engine({"A": TenantConfig(cfg, p, max_batch=4, max_context=64,
                                     paged=True)})
    eng.submit(traces.tiny_trace(["A"], n_per_model=4, prompt_len=10,
                                 max_new=6, vocab=cfg.vocab_size))
    keys, tables = set(), []
    while eng.busy():
        eng.step()
        keys.add(_key(eng, "A"))
        t = eng.tenants["A"]
        tables.append((t.pt_host.copy(), t.ctx_host.copy()))
    assert len(keys) == 1
    assert len({a.tobytes() + b.tobytes() for a, b in tables}) > 3
    (k,) = keys
    assert k.shape == (4, 0, True, 4, 16) and k.stacks is None


def test_key_misses_after_a_pool_growth_a_tier_switch_and_a_batch(llama):
    cfg, p = llama
    tc = TenantConfig(cfg, p, max_batch=4, max_context=64, paged=True)
    eng = _engine({"A": tc})
    t = eng.tenants["A"]
    k0 = _key(eng, "A")
    # a pool growth concatenates new pools: new storage
    t.grow_pool(eng.allocator.total_pages + 8)
    k1 = _key(eng, "A")
    assert k1 != k0 and k1.shape == k0.shape and not k0.live_with(k1)
    # a tier switch to a plan, then to one of the same sizes, other maps
    eng.xfer.apply_plan("A", _plan(4, (0, 2)))
    k2 = _key(eng, "A")
    eng.xfer.apply_plan("A", _plan(4, (1, 3)))
    k3 = _key(eng, "A")
    assert k2.shape == k3.shape == (2, 2, True, 4, 16)
    assert k3 != k2 and k2.stacks != k3.stacks and not k2.live_with(k3)
    # the same sizes and maps again: a re-split, other stacks
    eng.xfer.apply_plan("A", _plan(4, (0, 2)))
    k4 = _key(eng, "A")
    assert k4 != k3 and k4.stacks[2:] == k2.stacks[2:]
    # back to no cycling repeat: the plain graph of these pools is live
    eng.xfer.apply_plan("A", _plan(4, ()))
    assert _key(eng, "A") == k1 and k1.live_with(k1)
    assert not k4.live_with(_key(eng, "A"))
    # another batch: another key
    other = _engine({"A": dataclasses.replace(tc, max_batch=2)})
    kb = _key(other, "A")
    assert kb.shape[3] == 2 and kb.shape[:3] == k0.shape[:3]


def test_dense_key_holds_every_state_leaf(danube):
    """A dense tenant's admissions write its state in place
    (``insert_slot``), so its key stays (a graph also writes ``pos`` back
    in place); a remap of it changes only the stacks, and its plain graph
    stays live for a revert."""
    cfg, p = danube
    eng = _engine({"D": TenantConfig(cfg, p, max_batch=2, max_context=48,
                                     paged=False)})
    t = eng.tenants["D"]
    k0 = _key(eng, "D")
    tokens = torch.arange(1, 11, dtype=torch.int64)[None]
    _, st = t.model.prefill(p, {"tokens": tokens}, t.max_context)
    t.write_slot_state(1, st)
    assert int(t.state["pos"][1]) == 10
    k1 = _key(eng, "D")
    assert k1 == k0 and k0.shape == (2, 0, False, 2, 0)
    leaves = [x for x in t.state.values() if isinstance(x, torch.Tensor)]
    assert len(k0.storage) > len(leaves) >= 2     # pos, the ring's kv_pos
    eng.xfer.apply_plan("D", _plan(2, (0, 1)))
    k2 = _key(eng, "D")
    assert k2.storage == k0.storage and k2.stacks is not None
    assert k0.live_with(k2)


def _mirror_checked(eng):
    """Check after every step that each paged tenant's host mirrors equal
    its device page table and cursors."""
    step, checked = eng.step, []

    def checked_step():
        step()
        checked.append(eng.step_idx)
        for t in eng.tenants.values():
            if t.paged and t.state is not None:
                np.testing.assert_array_equal(
                    t.pt_host, t.state["page_table"].numpy())
                np.testing.assert_array_equal(t.ctx_host,
                                              t.state["ctx"].numpy())
    eng.step = checked_step
    return checked


RUNS = {
    # two tenants under KV pressure: the controller remaps, the pools grow
    "mirage_growth": dict(mode="mirage", pages=8, chunk=7, sharing=False,
                          trace="tiny", expect="remap"),
    # two requests admitted on 8 pages outgrow them while decoding
    "vllm_preemption": dict(mode="vllm", pages=8, chunk=0, sharing=False,
                            trace="long", expect="preempt"),
    "prefix_cow": dict(mode="mirage", pages=64, chunk=0, sharing=True,
                       trace="conversation", expect="prefill"),
    "chunked": dict(mode="mirage", pages=64, chunk=5, sharing=False,
                    trace="conversation", expect="prefill"),
    "swap_growth": dict(mode="swap", pages=8, chunk=0, sharing=False,
                        trace="tiny", expect="swap-grow"),
}


@pytest.mark.parametrize("run", RUNS)
def test_host_mirror_follows_the_device_table(llama, danube, run):
    case = RUNS[run]
    cfg, p = llama
    tenants = {"A": TenantConfig(cfg, p, max_batch=4, max_context=64,
                                 paged=True)}
    if case["trace"] == "long":
        trace = traces.tiny_trace(["A"], n_per_model=3, prompt_len=10,
                                  max_new=12, vocab=cfg.vocab_size)
    elif case["trace"] == "tiny":
        dcfg, dp = danube
        tenants["B"] = TenantConfig(dcfg, dp, max_batch=4, max_context=64,
                                    paged=True)
        trace = traces.tiny_trace(list(tenants), n_per_model=3,
                                  prompt_len=18, max_new=6,
                                  vocab=min(cfg.vocab_size, dcfg.vocab_size))
    else:
        trace = traces.multi_turn_trace([traces.ConversationSpec(
            "A", num_sessions=3, turns=2, system_prompt_len=8, user_len=4,
            assistant_len=4, max_new_tokens=4, think_time=8.0,
            session_rate=0.05, vocab=256, sigma=0.0)], seed=5)
    eng = _engine(tenants, mode=case["mode"], base_kv_pages=case["pages"],
                  prefill_chunk_tokens=case["chunk"],
                  prefix_sharing=case["sharing"])
    checked = _mirror_checked(eng)
    eng.submit(trace)
    eng.run(max_steps=2000)
    assert not eng.busy() and len(checked) > 10
    kinds = [k for _, k, _ in eng.events]
    assert case["expect"] in kinds, kinds
    if case["sharing"]:
        assert eng.prefix_stats()["A"]["hits"] > 0
    eng.allocator.check_invariants()


def test_host_mirror_follows_an_imported_prefix(llama):
    """``import_prefix`` writes pools and allocates pages but no row; the
    importing engine's next requests fork the imported pages through their
    rows, and the mirror follows."""
    cfg, p = llama
    conv = traces.multi_turn_trace([traces.ConversationSpec(
        "A", num_sessions=2, turns=2, system_prompt_len=8, user_len=4,
        assistant_len=4, max_new_tokens=4, think_time=8.0,
        session_rate=0.05, vocab=256, sigma=0.0)], seed=7)

    def engine():
        return _engine({"A": TenantConfig(cfg, p, max_batch=4,
                                          max_context=64, paged=True)},
                       prefix_sharing=True)
    donor = engine()
    donor.submit([dataclasses.replace(r) for r in conv])
    donor.run()
    ((model, tokens),) = donor.prefix_snapshot()[:1]
    kv = donor.export_prefix(model, tokens, len(tokens))
    eng = engine()
    assert eng.import_prefix(model, tokens, len(tokens), kv) > 0
    checked = _mirror_checked(eng)
    eng.submit(traces.multi_turn_trace([traces.ConversationSpec(
        "A", num_sessions=2, turns=2, system_prompt_len=8, user_len=4,
        assistant_len=4, max_new_tokens=4, think_time=8.0,
        session_rate=0.05, vocab=256, sigma=0.0)], seed=7))
    eng.run()
    assert len(checked) > 10 and eng.prefix_stats()["A"]["hits"] > 0
