"""The port's fleet hooks against the JAX engine's (``export_prefix``,
``import_prefix``, ``prefix_snapshot``, ``withdraw_pending``,
``drain_for_removal``): the same calls on the same bridged weights (f32,
CPU) must leave identical page ids, prefix indices, events and tokens,
and an import must put the donor's pages into the pool exactly."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

sys.path.insert(0, str(Path(__file__).parent))
import torch_fleet as tf  # noqa: E402

from repro.configs.base import RuntimeConfig as JaxKnobs  # noqa: E402
from repro.serving import RuntimeConfig as JaxConfig  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import TenantConfig as JaxTenant  # noqa: E402
from repro.serving import TenantSpec as JaxSpec  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.traces import tiny_trace as jax_tiny  # noqa: E402

from repro_torch.configs.base import RuntimeConfig as Knobs  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    RuntimeConfig, ServingEngine, TenantConfig, TenantSpec,
)
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.traces import tiny_trace  # noqa: E402

PROMPT = np.arange(1, 25, dtype=np.int32)       # 6 full pages of 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def llama():
    return tf.bridged(tf.A, 2, 0)


def _mk(side, llama):
    """The reference test's tiny prefix-sharing engine, on either side."""
    cfg, jp, tcfg, tp = llama
    if side == "jax":
        return JaxEngine({"m": JaxTenant(cfg, jp, max_batch=4,
                                         max_context=64, paged=True)},
                         base_kv_pages=64, page_size=4, prefix_sharing=True)
    return ServingEngine({"m": TenantConfig(tcfg, tp, max_batch=4,
                                            max_context=64, paged=True)},
                         base_kv_pages=64, page_size=4, prefix_sharing=True,
                         device="cpu")


def _req(side, rid, prompt, new):
    return (JaxRequest if side == "jax" else Request)(
        rid, "m", prompt.copy(), max_new_tokens=new)


def _warm(side, llama):
    eng = _mk(side, llama)
    eng.submit([_req(side, "seed", PROMPT, 4)])
    eng.run(max_steps=500)
    return eng


def _roundtrip(side, llama):
    """tests/test_fleet_prefix.py::test_engine_export_import_roundtrip on
    one side: export from a warm engine, import into a cold one, decode
    downstream of the import and from scratch."""
    warm, cold, fresh = _warm(side, llama), _mk(side, llama), \
        _mk(side, llama)
    span = warm.prefix_probe("m", PROMPT)
    kv = warm.export_prefix("m", PROMPT, span)
    got = cold.import_prefix("m", PROMPT, span, kv=kv)
    after_import = tf.engine(cold)
    back = cold.export_prefix("m", PROMPT, span)
    cold.allocator.check_invariants()
    cold.prefix["m"].check_invariants()
    outs = []
    for eng in (fresh, cold):
        rq = _req(side, "probe", PROMPT, 8)
        eng.submit([rq])
        eng.run(max_steps=500)
        outs.append(list(rq.generated))
    return dict(span=span, got=got, kv=kv, back=back, outs=outs,
                after_import=after_import, cold=tf.engine(cold),
                warm=tf.engine(warm))


def test_export_import_roundtrip_matches_jax(llama):
    ref, out = _roundtrip("jax", llama), _roundtrip("torch", llama)
    assert out["span"] == ref["span"] == len(PROMPT)
    assert out["got"] == ref["got"] == len(PROMPT)
    k, v = out["kv"]
    assert k.device.type == "cpu" and k.dtype == torch.float32
    assert tuple(k.shape) == (2, 6, 4, llama[2].num_kv_heads,
                              llama[2].resolved_head_dim)
    # the importer's pages hold exactly the donor's bytes
    assert torch.equal(out["back"][0], k) and torch.equal(out["back"][1], v)
    # and the donor's pages are the JAX engine's, to f32 rounding
    for mine, theirs in zip(out["kv"], ref["kv"]):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=0, atol=1e-4 * np.abs(theirs).max())
    # page ids, prefix index and events, right after the import and at the
    # end, and greedy decode downstream of the import = from scratch
    for key in ("after_import", "cold", "warm"):
        assert out[key] == ref[key], key
    assert out["outs"][0] == out["outs"][1] == ref["outs"][1]
    assert ("prefix-import" in {k for _, k, _ in out["cold"]["events"]})


def _incremental(side, llama):
    """Import 2 blocks, grow the pool as a remap does (the pools are
    reallocated), then import the span of 6 blocks."""
    warm, cold = _warm(side, llama), _mk(side, llama)
    first = cold.import_prefix("m", PROMPT, 8,
                               kv=warm.export_prefix("m", PROMPT, 8))
    before = len(cold.prefix["m"])
    cold.allocator.grow(8, "m")
    cold.tenants["m"].grow_pool(cold.allocator.page_id_bound)
    pools = None
    if side == "torch":
        pools = [cold.tenants["m"].state[p].clone()
                 for p in ("pool_k", "pool_v")]
    second = cold.import_prefix("m", PROMPT, 24,
                                kv=warm.export_prefix("m", PROMPT, 24))
    return dict(first=first, second=second, before=before,
                after=len(cold.prefix["m"]),
                probe=cold.prefix_probe("m", PROMPT), state=tf.engine(cold),
                pools=pools, cold=cold, warm=warm)


def test_incremental_import_writes_only_the_missing_blocks(llama):
    """The second import, after a pool growth, writes the four missing
    pages and nothing else, and the pages imported before the growth
    survive it: the whole span is the donor's."""
    ref, out = _incremental("jax", llama), _incremental("torch", llama)
    assert (out["first"], out["second"]) == (ref["first"], ref["second"]) \
        == (8, 16)
    assert out["after"] == out["before"] + 4 == ref["after"]
    assert out["probe"] == ref["probe"] == 24
    assert out["state"] == ref["state"]
    # the second import wrote the four new pages and nothing else
    cold = out["cold"]
    new = set(cold.prefix["m"].match(PROMPT, record=False).pages[2:])
    assert len(new) == 4
    for name, old in zip(("pool_k", "pool_v"), out["pools"]):
        now = cold.tenants["m"].state[name]
        changed = {p for p in range(now.shape[1])
                   if not torch.equal(now[:, p], old[:, p])}
        assert changed == new, name
    for mine, theirs in zip(cold.export_prefix("m", PROMPT, 24),
                            out["warm"].export_prefix("m", PROMPT, 24)):
        assert torch.equal(mine, theirs)


def _snapshot(side, llama):
    eng = _mk(side, llama)
    for i, tail in enumerate((PROMPT[:12], PROMPT, PROMPT[:8] + 50)):
        eng.submit([_req(side, f"s{i}", tail, 3)])
        eng.run(max_steps=500)
    return [(m, list(map(int, p))) for m, p in eng.prefix_snapshot()], \
        [(m, list(map(int, p))) for m, p in eng.prefix_snapshot(5)], \
        tf.engine(eng)


def test_prefix_snapshot_matches_jax(llama):
    ref, out = _snapshot("jax", llama), _snapshot("torch", llama)
    assert out == ref
    assert len(out[0]) == 2 and len(out[1]) < len(out[0])


def _withdraw(side, llama):
    eng = _mk(side, llama)
    trace = (jax_tiny if side == "jax" else tiny_trace)(
        ["m"], n_per_model=4, prompt_len=10, max_new=4, vocab=256)
    for i, r in enumerate(trace):
        r.arrival = 1.0 + 20.0 * i
    eng.submit(trace)
    while eng.step_idx < 22:        # m-0 and m-1 admitted, m-2/m-3 not
        eng.step()
    pulled = [r.rid for r in eng.withdraw_pending()]
    again = eng.withdraw_pending()
    eng.run(max_steps=500)
    return pulled, again, tf.engine(eng)


def test_withdraw_pending_matches_jax(llama):
    ref, out = _withdraw("jax", llama), _withdraw("torch", llama)
    assert out == ref
    pulled, again, state = out
    assert len(pulled) == 2 and again == []
    assert sorted(state["generated"]) == ["m-0", "m-1"]


def _drain(side, paged):
    """tests/test_autoscaler.py::test_engine_drain_for_removal_reverts on
    one side at 2 layers, with each step of the drain recorded."""
    sides = {"jax": (JaxEngine, JaxTenant, JaxKnobs, jax_tiny),
             "torch": (ServingEngine, TenantConfig, Knobs, tiny_trace)}
    eng_cls, ten_cls, knobs, trace = sides[side]
    tenants = {}
    for name, arch, seed in (("A", tf.A, 0), ("B", "h2o-danube-3-4b", 1)):
        cfg, jp, tcfg, tp = tf.bridged(arch, 2, seed)
        tenants[name] = ten_cls(cfg if side == "jax" else tcfg,
                                jp if side == "jax" else tp,
                                max_batch=4, max_context=32,
                                paged=paged)
    kw = {} if side == "jax" else {"device": "cpu"}
    eng = eng_cls(tenants, mode="mirage", scheduler="temporal",
                  base_kv_pages=6, page_size=4, quantum_steps=4,
                  runtime=knobs(dynamic_reversion=False), **kw)
    eng.submit(trace(["A", "B"], n_per_model=4, prompt_len=10, max_new=8,
                     vocab=256))
    eng.run(max_steps=2_000)
    log = [eng.store.total_remapped_bytes()]
    eng.drain_for_removal()
    log.append(eng.store.total_remapped_bytes())
    while eng.draining() and len(log) < 10_000:
        eng.step()
        log.append({n: eng.xfer.pending_bytes(n) for n in tenants})
    eng.drain_for_removal()
    eng.allocator.check_invariants()
    log += [eng.store.total_remapped_bytes(),
            {n: m.remapped_alpha for n, m in eng.store.models.items()},
            {n: p.alpha for n, p in eng.xfer.plans.items()}]
    return log, tf.engine(eng), eng


@pytest.mark.parametrize("paged", [False, True])
def test_drain_for_removal_reverts_every_segment_like_jax(paged):
    """Dense and paged tenants alike: every donated segment comes back,
    the split is whole again (no pinned cycle stack left), and a second
    call does nothing."""
    (ref, ref_state, _), (out, state, eng) = (_drain("jax", paged),
                                               _drain("torch", paged))
    assert out == ref
    assert state == ref_state
    assert out[0] > 0 and out[1] == 0 and out[-3] == 0
    assert set(out[-2].values()) == {0} and set(out[-1].values()) == {0}
    kinds = [k for _, k, _ in state["events"]]
    assert "remap" in kinds and "revert-teardown" in kinds
    # idempotent: the second call added no event
    assert kinds.count("revert-teardown") == len(
        [n for n in ("A", "B") if any(
            k == "remap" and d.startswith(n) for _, k, d in state["events"])])
    # the split is whole again: no cycle layer is left to stream
    for name, (resident, cycle, maps) in eng.xfer.split.items():
        assert maps["is_resident"].all(), name
        assert all(x.shape[0] == 0 for x in tree_leaves(cycle))


def _shared_config(side, llama):
    cfg, jp, tcfg, tp = llama
    spec, conf = (JaxSpec, JaxConfig) if side == "jax" else \
        (TenantSpec, RuntimeConfig)
    return conf(tenants={
        n: spec(cfg if side == "jax" else tcfg,
                params=jp if side == "jax" else tp, max_batch=4,
                max_context=64, paged=True) for n in ("A", "B")},
        quantum_steps=4)


def test_remap_on_one_replica_leaves_the_other_alone(llama):
    """Two engines lowered from one RuntimeConfig share its params
    tensors. The first remaps under a tight pool while the second decodes
    with an ample one, step for step: the second's tokens equal a lone
    engine's, the shared tensors are unchanged, and the JAX package gives
    the same tokens and events on both engines."""
    tp = llama[3]
    before = [x.clone() for x in tree_leaves(tp)]

    def run(side, pair):
        conf = _shared_config(side, llama)
        kw = {} if side == "jax" else {"device": "cpu"}
        trace = jax_tiny if side == "jax" else tiny_trace
        tight = conf.build("engine", base_kv_pages=8, page_size=4, **kw)
        ample = conf.build("engine", base_kv_pages=256, page_size=4, **kw)
        engines = (tight, ample) if pair else (ample,)
        for eng in engines:
            eng.submit(trace(["A", "B"], n_per_model=3, prompt_len=18,
                             max_new=6, vocab=256))
        while any(e.busy() for e in engines):
            for e in engines:
                if e.busy():
                    e.step()
        return [tf.engine(e) for e in engines]

    tight, ample = run("torch", True)
    (lone,) = run("torch", False)
    assert "remap" in {k for _, k, _ in tight["events"]}
    assert "remap" not in {k for _, k, _ in ample["events"]}
    assert ample == lone
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(tp)))
    assert [tight, ample] == run("jax", True)
