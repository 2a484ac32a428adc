"""The port's cluster layer over its engine against ``repro.cluster`` over
the JAX engine: the same fleet, trace and bridged weights (f32, CPU) must
give identical tokens, per-replica events and allocator pages, fleet-cache
counters, membership events and ``ServingMetrics``; a 1-replica group and
a 1-shard ``ShardSet`` must also be invisible against a bare engine."""
import dataclasses
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

sys.path.insert(0, str(Path(__file__).parent))
import torch_fleet as tf  # noqa: E402

PKG = {"jax": "repro", "torch": "repro_torch"}
DEVICE = {"jax": {}, "torch": {"device": "cpu"}}


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
    return {"A": tf.bridged(tf.A, 2, 0),
            "B": tf.bridged("h2o-danube-3-4b", 2, 1)}


def _mods(side):
    pkg = PKG[side]
    return (importlib.import_module(f"{pkg}.cluster"),
            importlib.import_module(f"{pkg}.serving"),
            importlib.import_module(f"{pkg}.serving.traces"))


def _spec(side, w, **kw):
    cfg, jp, tcfg, tp = w
    serving = _mods(side)[1]
    return serving.TenantSpec(cfg if side == "jax" else tcfg,
                              params=jp if side == "jax" else tp, **kw)


def _two_tenants(side, weights):
    """tests/test_cluster.py's engine_config at 2 layers."""
    serving = _mods(side)[1]
    return serving.RuntimeConfig(tenants={
        "A": _spec(side, weights["A"], max_batch=4, max_context=32,
                   slo=serving.SLOSpec(50.0, 4.0, serving.LATENCY)),
        "B": _spec(side, weights["B"], max_batch=4, max_context=32),
    }, quantum_steps=4)


def _prefix_fleet(side, weights):
    """tests/test_autoscaler.py's engine_fleet_config."""
    serving = _mods(side)[1]
    return serving.RuntimeConfig(
        tenants={"m": _spec(side, weights["A"], max_batch=4, max_context=64,
                            paged=True)},
        prefix_sharing=True, quantum_steps=4)


def _engine_trace(side, n=10, shared=24, arrival_gap=40.0):
    """tests/test_autoscaler.py's shared-system-prompt trace."""
    Request = importlib.import_module(f"{PKG[side]}.serving.request").Request
    sys_p = np.arange(1, shared + 1, dtype=np.int32)
    return [Request(f"r{i}", "m",
                    np.concatenate([sys_p, np.full(4, 100 + i, np.int32)]),
                    max_new_tokens=4, arrival=i * arrival_gap)
            for i in range(n)]


def _unwrap(rt):
    """The engine inside a ``ShardSet`` (the engine's own ``runtime`` is
    its knobs, not a wrapped runtime)."""
    return rt.runtime if type(rt).__name__ == "ShardSet" else rt


def _fleet(group, fc=None):
    """Everything a fleet run leaves behind, retired units included."""
    units = [_unwrap(rt) for rt in [*group.replicas, *group._retired]]
    return {"units": [tf.engine(rt) for rt in units],
            "membership": list(group.events), "uids": group.uids,
            "assignments": dict(group.router.assignments),
            "ticks": group.ticks, "finished": group.finished_count,
            "fleet": tf.plain(fc.stats) if fc is not None else None,
            "metrics": tf.plain(group.metrics()),
            "tiers": tf.plain(group.tier_metrics())}


def _per_request(finished):
    return {r.rid: (r.ttft(), tuple(r.token_times), tuple(r.generated))
            for r in finished}


def _transparent(side, weights):
    """A bare engine, a 1-replica group and a group of one 1-shard
    ``ShardSet`` over the same trace."""
    cluster, _, traces = _mods(side)
    conf = _two_tenants(side, weights)

    def trace():
        return traces.tiny_trace(["A", "B"], n_per_model=3, prompt_len=10,
                                 max_new=6, vocab=256)

    build = dict(base_kv_pages=64, page_size=4, **DEVICE[side])
    eng = conf.build("engine", **build)
    eng.submit(trace())
    eng.run(max_steps=2_000)
    groups = []
    for wrap in (lambda rt: rt, cluster.ShardSet):
        group = cluster.ReplicaGroup([wrap(conf.build("engine", **build))],
                                     router=cluster.Router(
                                         cluster.LEAST_LOADED))
        group.run(trace())
        groups.append(group)
    return eng, groups


def test_single_unit_groups_are_transparent_and_match_jax(weights):
    out = {}
    for side in ("jax", "torch"):
        eng, groups = _transparent(side, weights)
        for group in groups:
            g0 = _unwrap(group.replicas[0])
            assert _per_request(eng.finished) == _per_request(g0.finished)
            assert eng.metrics() == group.metrics()
            assert tf.engine(eng) == tf.engine(g0)
        out[side] = [_fleet(g) for g in groups]
    assert out["torch"] == out["jax"]
    assert len(out["torch"][0]["units"][0]["generated"]) == 6


def _two_replicas(side, weights, link):
    cluster, serving, _ = _mods(side)
    hw = serving.GH200
    if link == "import":
        # a card this slow makes recomputing the 2-layer model's 24-token
        # span cost more than moving its KV, so the group imports it
        hw = dataclasses.replace(hw, name="gh200-slow", flops_bf16=1e9)
    fc = cluster.FleetPrefixCache(page_size=4)
    group = cluster.ReplicaGroup.from_config(
        _prefix_fleet(side, weights), 2, backend="engine",
        router=cluster.Router("least_loaded"), fleet_cache=fc,
        base_kv_pages=64, page_size=4, hw=hw, **DEVICE[side])
    trace = _engine_trace(side, arrival_gap=3.0)
    group.run(trace)
    for rt in group.replicas:
        rt.allocator.check_invariants()
        rt.prefix["m"].check_invariants()
    return _fleet(group, fc)


@pytest.mark.parametrize("link", ["import", "recompute"])
def test_two_replica_fleet_cache_matches_jax(weights, link):
    """Arrivals 3 steps apart across two replicas: later requests find the
    shared system prompt on the other replica, and the group imports its
    KV or recomputes it, as the transfer-vs-recompute costs decide."""
    ref = _two_replicas("jax", weights, link)
    out = _two_replicas("torch", weights, link)
    assert out == ref
    assert out["finished"] == 10
    assert out["fleet"]["hits"] > 0
    imports = [k for u in out["units"] for _, k, _ in u["events"]
               if k == "prefix-import"]
    if link == "import":
        assert out["fleet"]["transferred_tokens"] > 0 and imports
    else:
        assert out["fleet"]["transfers"] == 0 and not imports
        assert out["fleet"]["recomputed_tokens"] > 0


def _membership(side, weights):
    """tests/test_autoscaler.py::test_engine_fleet_membership_run."""
    cluster, _, _ = _mods(side)
    conf = _prefix_fleet(side, weights)

    def mk():
        return conf.build("engine", base_kv_pages=64, page_size=4,
                          **DEVICE[side])

    fc = cluster.FleetPrefixCache(page_size=4)
    g = cluster.ReplicaGroup([mk(), mk()],
                             router=cluster.Router("least_loaded"),
                             fleet_cache=fc)
    trace = _engine_trace(side)
    g.submit(trace)
    added = removed = False
    while g.busy() and g.ticks < 50_000:
        g.tick()
        if not added and g.finished_count >= 2:
            g.add_replica(mk(), prewarm=True)
            added = True
        if added and not removed and g.n_active == 3:
            g.remove_replica(0)
            removed = True
    assert added and removed
    return _fleet(g, fc), g, fc


def test_membership_run_matches_jax(weights):
    ref, _, _ = _membership("jax", weights)
    out, g, fc = _membership("torch", weights)
    assert out == ref
    met = g.metrics()
    assert g.finished_count == 10 and met.unfinished == 0
    assert g.uids == [1, 2]
    assert fc.stats.lookups >= 10
    assert met.fleet_hit_rate > 0 and fc.stats.transferred_tokens > 0
    holders = set().union(*(e.holders for e in fc._entries.values())) \
        if fc._entries else set()
    assert 0 not in holders
    assert [k for _, k, _ in g.events] == ["join", "active", "leave",
                                           "gone"]
