"""The port's simulator, lowered through its ``RuntimeConfig``, and its
``ReplicaGroup`` over the simulator, against the JAX package's: every
scenario of ``tests/test_sim_equivalence.py`` runs on both packages, each
on the reference and on the fast path, and all four ``ServingMetrics``
(aggregate, per tier, with the per-request samples behind the tails),
clocks, fleet-cache counters and membership logs must be identical."""
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

sys.path.insert(0, str(Path(__file__).parent))
import torch_fleet as tf  # noqa: E402

A, B = "llama3-8b", "h2o-danube-3-4b"
MOE = "moonshot-v1-16b-a3b"
PKGS = ("repro", "repro_torch")


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def frac(pkg, name, kv_gb, hw):
    pm = _m(pkg, "serving.perf_model").PerfModel(
        _m(pkg, "configs").ARCHS[name], hw)
    return (pm.param_bytes + kv_gb * 2**30) / hw.hbm_bytes


def _hw(pkg, link=None):
    gh200 = _m(pkg, "serving.hw").GH200
    return gh200 if link in (None, "gh200") else gh200.with_host_link(link)


def _sim_result(sim):
    return {"metrics": tf.plain(sim.metrics()),
            "tiers": tf.plain(sim.tier_metrics()), "now": sim.now,
            "finished": len(sim.finished),
            "link_busy_s": sim.host_link_busy_s,
            "fetch_misses": sim.fetch_miss_events,
            "swap_peak": sim.swap_overflow_peak,
            "partial_drain_ticks": sim.shard_partial_drain_ticks}


def _group_result(group, fc=None):
    return {"metrics": tf.plain(group.metrics()),
            "tiers": tf.plain(group.tier_metrics()),
            "fleet": tf.plain(fc.stats) if fc is not None else None,
            "membership": list(group.events), "ticks": group.ticks,
            "finished": group.finished_count}


def _all_four(run):
    """``run(pkg, fast)`` on both packages and both paths; all equal."""
    out = {(pkg, fast): run(pkg, fast) for pkg in PKGS
           for fast in (False, True)}
    ref = out[("repro", False)]
    for key, got in out.items():
        assert got == ref, key
    return ref


# ------------------------------------------------------------ mode matrix
def _two_tenants(pkg, kv_a=6.0, kv_b=4.0, slo=False, max_batch=48):
    serving = _m(pkg, "serving")
    hw = _hw(pkg)
    ka = dict(slo=serving.SLOSpec(ttft_target=6.0, tbt_target=0.08,
                                  tier=serving.LATENCY)) if slo else {}
    kb = dict(slo=serving.SLOSpec(ttft_target=30.0, tbt_target=0.5,
                                  tier=serving.BEST_EFFORT)) if slo else {}
    archs = _m(pkg, "configs").ARCHS
    return {A: serving.TenantSpec(archs[A], max_batch=max_batch,
                                  mem_fraction=frac(pkg, A, kv_a, hw), **ka),
            B: serving.TenantSpec(archs[B], max_batch=max_batch,
                                  mem_fraction=frac(pkg, B, kv_b, hw), **kb)}


def _two_trace(pkg, rate_a=6.0, rate_b=4.0, dur=12.0, seed=3):
    traces = _m(pkg, "serving.traces")
    return traces.make_trace(
        [traces.TraceSpec(A, "sharegpt", rate_a, duration=dur),
         traces.TraceSpec(B, "sharegpt", rate_b, duration=dur)], seed=seed)


# RuntimeConfig fields, tenant knobs, trace knobs, simulator-only extras
MATRIX = {
    "mirage-temporal": (dict(mode="mirage"), {}, {}, {}),
    "mirage-slo": (dict(mode="mirage", scheduler="slo"), dict(slo=True),
                   {}, {}),
    "mirage-sync-spatial": (dict(mode="mirage", scheduler="spatial"), {},
                            {}, dict(incremental_apply=False)),
    "vllm-chunked": (dict(mode="vllm", prefill_chunk_tokens=256), {}, {},
                     {}),
    "swap-prefix": (dict(mode="swap", prefix_sharing=True), {}, {}, {}),
    "vllm-pressure": (dict(mode="vllm"), dict(kv_a=0.45, kv_b=0.45),
                      dict(rate_a=10.0, rate_b=8.0), {}),
    "mirage-slo-pressure": (dict(mode="mirage", scheduler="slo"),
                            dict(kv_a=0.45, kv_b=0.45, slo=True),
                            dict(rate_a=10.0, rate_b=8.0), {}),
    "shard-set-lockstep": (dict(mode="mirage"), {}, {},
                           dict(shard_devices=4, shard_lockstep=True)),
    "shard-set-naive": (dict(mode="mirage"), {}, {},
                        dict(shard_devices=4, shard_lockstep=False)),
}


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_matrix_identical(name):
    conf_kw, ten_kw, tr_kw, sim_kw = MATRIX[name]

    def run(pkg, fast):
        conf = _m(pkg, "serving").RuntimeConfig(
            tenants=_two_tenants(pkg, **ten_kw), **conf_kw)
        sim = conf.build("sim", fast=fast, **sim_kw)
        sim.run(_two_trace(pkg, **tr_kw), max_time=1e6)
        res = _sim_result(sim)
        res["preemptions"] = sum(r.preemptions for r in sim.finished)
        return res

    ref = _all_four(run)
    assert ref["finished"] > 0
    if name == "vllm-pressure":
        assert ref["preemptions"] > 0


def test_expert_granular_identical():
    """The reference scenario over 5 s of trace instead of 6 (a seventh
    of the time): cold experts are donated, streamed and missed there."""
    def run(pkg, fast):
        serving = _m(pkg, "serving")
        traces = _m(pkg, "serving.traces")
        cfg = _m(pkg, "configs").ARCHS[MOE]
        conf = serving.RuntimeConfig(tenants={MOE: serving.TenantSpec(
            cfg, max_batch=64, mem_fraction=frac(pkg, MOE, 0.5, _hw(pkg)),
            slo=serving.SLOSpec(ttft_target=30.0, tbt_target=0.2,
                                tier=serving.LATENCY))}, mode="mirage")
        sim = conf.build(
            "sim", fast=fast, pipeline_cap=False, max_remap_fraction=0.3,
            expert_granular=True, expert_routing={MOE: traces.ZipfRouting(
                cfg.moe.num_experts, cfg.moe.top_k, zipf_s=1.2)})
        sim.run(traces.make_trace(
            [traces.TraceSpec(MOE, "sharegpt", 8.0, duration=5.0)], seed=1),
            max_time=1e6)
        return _sim_result(sim)

    ref = _all_four(run)
    assert ref["finished"] > 0 and ref["fetch_misses"] > 0


# ------------------------------------------------------- cluster / host links
@pytest.mark.parametrize("link", ["gh200", "pcie5"])
@pytest.mark.parametrize("n_replicas", [1, 2])
def test_replica_group_identical(link, n_replicas):
    def run(pkg, fast):
        serving = _m(pkg, "serving")
        cluster = _m(pkg, "cluster")
        archs = _m(pkg, "configs").ARCHS
        hw = _hw(pkg, link)
        conf = serving.RuntimeConfig(tenants={
            A: serving.TenantSpec(
                archs[A], max_batch=32, mem_fraction=frac(pkg, A, 4.0, hw),
                slo=serving.SLOSpec(ttft_target=10.0, tbt_target=0.2,
                                    tier=serving.LATENCY)),
            B: serving.TenantSpec(
                archs[B], max_batch=32, mem_fraction=frac(pkg, B, 3.0, hw),
                slo=serving.SLOSpec(ttft_target=30.0, tbt_target=0.6,
                                    tier=serving.BEST_EFFORT)),
        }, mode="mirage", scheduler="slo")
        group = cluster.ReplicaGroup.from_config(conf, n_replicas,
                                                 fast=fast, hw=hw)
        group.submit(_two_trace(pkg, dur=8.0))
        while group.busy() and group.ticks < 1_000_000:
            group.tick()
        return _group_result(group)

    assert _all_four(run)["finished"] > 0


def _conversations(pkg):
    traces = _m(pkg, "serving.traces")
    return traces.multi_turn_trace([traces.ConversationSpec(
        A, num_sessions=8, turns=3, system_prompt_len=256, user_len=32,
        assistant_len=64, max_new_tokens=32, think_time=1.0,
        session_rate=2.0)], seed=3)


def _prefix_config(pkg, hw, kv_gb):
    serving = _m(pkg, "serving")
    return serving.RuntimeConfig(
        tenants={A: serving.TenantSpec(
            _m(pkg, "configs").ARCHS[A], max_batch=8,
            mem_fraction=frac(pkg, A, kv_gb, hw))},
        mode="mirage", scheduler="temporal", prefix_sharing=True)


@pytest.mark.parametrize("link", ["nvlink_c2c", "pcie4"])
def test_fleet_prefix_cache_identical(link):
    def run(pkg, fast):
        cluster = _m(pkg, "cluster")
        hw = _hw(pkg, link)
        fc = cluster.FleetPrefixCache(page_size=32)
        group = cluster.ReplicaGroup.from_config(
            _prefix_config(pkg, hw, 4.0), 4, backend="sim",
            router=cluster.Router("prefix_affinity"), fleet_cache=fc,
            fast=fast, hw=hw)
        group.run(_conversations(pkg))
        return _group_result(group, fc)

    ref = _all_four(run)
    assert ref["metrics"]["_fleet_lookup_tokens"] > 0


def test_autoscaling_membership_identical():
    """A scripted pre-warmed scale-out and a later scale-in."""
    def run(pkg, fast):
        cluster = _m(pkg, "cluster")
        hw = _hw(pkg, "pcie5")
        fc = cluster.FleetPrefixCache(page_size=32)
        group = cluster.ReplicaGroup.from_config(
            _prefix_config(pkg, hw, 2.0), 2, backend="sim",
            router=cluster.Router("least_loaded"), fleet_cache=fc,
            fast=fast, hw=hw)
        n = len(_conversations(pkg))
        group.submit(_conversations(pkg))
        added = removed = False
        while group.busy() and group.ticks < 1_000_000:
            group.tick()
            if not added and group._wall > 2.0:
                group.add_replica(prewarm=True)
                added = True
            if added and not removed and group._wall > 5.0 \
                    and group.n_active == 3:
                group.remove_replica(0)
                removed = True
        assert added and removed and group.finished_count == n
        return _group_result(group, fc)

    ref = _all_four(run)
    assert [k for _, k, _ in ref["membership"]] == ["join", "active",
                                                     "leave", "gone"]


# --------------------------------------------------------- random traces
def _random_requests(pkg, seed, n, max_gap_ms, max_prompt, max_new):
    """The reference's hypothesis shapes, drawn from a seed: per request a
    gap, a prompt length and an output length, tenants round-robin."""
    Request = _m(pkg, "serving.request").Request
    shape_rng = np.random.default_rng(seed)
    rng = np.random.default_rng(0)
    reqs, t = [], 0.0
    for i in range(n):
        t += int(shape_rng.integers(0, max_gap_ms + 1)) / 1000.0
        plen = int(shape_rng.integers(1, max_prompt + 1))
        reqs.append(Request(
            rid=f"h{i}", model=(A, B)[i % 2],
            prompt=rng.integers(0, 32000, plen).astype(np.int32),
            max_new_tokens=int(shape_rng.integers(1, max_new + 1)),
            arrival=t))
    return reqs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pressure", [False, True])
def test_random_traces_identical(seed, pressure):
    def run(pkg, fast):
        serving = _m(pkg, "serving")
        archs = _m(pkg, "configs").ARCHS
        hw = _hw(pkg)
        kv = 0.15 if pressure else 1.0
        conf = serving.RuntimeConfig(tenants={
            n: serving.TenantSpec(archs[n], max_batch=8,
                                  mem_fraction=frac(pkg, n, kv, hw))
            for n in (A, B)}, mode="vllm" if pressure else "mirage")
        sim = conf.build("sim", fast=fast)
        sim.run(_random_requests(pkg, seed, 32, 300 if pressure else 2000,
                                 512 if pressure else 256,
                                 16 if pressure else 24), max_time=1e6)
        return _sim_result(sim)

    assert _all_four(run)["finished"] > 0
