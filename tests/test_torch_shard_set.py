"""Shard-set serving on the port against the JAX package: every scenario of
``tests/test_shard_set.py`` (lock-step and independent cross-shard drains,
the simulator's drain plumbing, the shared logical KV page space,
shard-aware ``PerfModel`` accounting, fail-fast fit validation, the
engine's refusal) runs once against ``repro`` and once against
``repro_torch`` and must give identical results; ``PerfModel`` is equal
for every architecture at 1, 2, 4 and 8 shards; and the ``fig24``
shard-set configuration (a kimi-k2-class 72B tenant on a 4-shard set
beside a llama3-8b replica per device) runs through ``ReplicaGroup`` over
the simulator with every number of its sweep row identical."""
import dataclasses
import importlib
import math
import re
import sys
import warnings
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

sys.path.insert(0, str(Path(__file__).parent))
import torch_fleet as tf  # noqa: E402

PKGS = ("repro", "repro_torch")


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _both(scenario, *args):
    """``scenario(pkg, *args)`` on both packages; the results are equal."""
    ref, got = (scenario(pkg, *args) for pkg in PKGS)
    assert got == ref
    return got


def _error(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:      # noqa: BLE001 - the error IS the result
        return f"{type(e).__name__}: {e}"
    return None


# ------------------------------------------------------ ShardedPlanDrain
def _reversion(core, n=8, alpha=2, m=4):
    return core.uniform_plan(n, alpha, m), core.identity_plan(n)


def drain_scenarios(pkg):
    core = _m(pkg, "core")
    cur, tgt = _reversion(core)
    # lock-step drain steps exactly as the plain PlanDrain
    plain = core.PlanDrain(cur, tgt, 100)
    d = core.ShardedPlanDrain(cur, tgt, 100, shards=4, lockstep=True)
    lockstep = [d.transition_bytes == plain.transition_bytes]
    while not plain.done:
        lockstep.append((plain.advance(100), d.advance(100), d.done,
                         d.current_plan == plain.current_plan, d.partial))
    # independent drains stagger and report the partial state
    d = core.ShardedPlanDrain(cur, tgt, 100, shards=4, lockstep=False,
                              skew=1)
    steps, flips, partial = [], 0, 0
    while not d.done and len(steps) < 100:
        d.advance(100)
        flips += d.last_advance_completions
        partial += d.partial
        steps.append((d.current_plan == tgt, d.remaining_bytes))
    # one shard is the plain drain
    one = core.ShardedPlanDrain(cur, tgt, 100, shards=1, lockstep=False)
    plain = core.PlanDrain(cur, tgt, 100)
    degenerate = []
    while not plain.done:
        degenerate.append((one.advance(100)[0], plain.advance(100)[0],
                           one.partial))
    return tf.plain({
        "lockstep": lockstep, "steps": steps, "flips": flips,
        "partial": partial, "degenerate": degenerate,
        "n_layers": len(core.PlanDrain(cur, tgt, 100).to_load)})


def test_drains_match_jax():
    out = _both(drain_scenarios)
    assert out["lockstep"][0] is True
    assert not any(partial for *_, partial in out["lockstep"][1:])
    assert len(out["steps"]) == out["n_layers"] + 3
    assert out["flips"] == 4 and out["partial"] > 0
    assert all(a == b and not p for a, b, p in out["degenerate"])


# ------------------------------------------------ simulator drain plumbing
def sim_drain(pkg, lockstep):
    core, sim_mod = _m(pkg, "core"), _m(pkg, "serving.simulator")
    sim = sim_mod.Simulator(
        {"m": sim_mod.SimTenantConfig(_m(pkg, "configs").ARCHS["llama3-8b"],
                                      max_batch=8, mem_fraction=0.3)},
        mode="mirage", shard_devices=4, shard_lockstep=lockstep)
    cur = sim._current_plan("m")
    tgt = core.uniform_plan(cur.n, 2, 4)
    sim._live_plan["m"] = tgt
    sim._drains["m"] = core.ShardedPlanDrain(
        tgt, core.identity_plan(cur.n), sim._unit_bytes("m"), shards=4,
        lockstep=lockstep)
    guard = 0
    while sim._drains and guard < 100:
        sim._advance_drains()
        guard += 1
    default = sim_mod.Simulator(
        {"m": sim_mod.SimTenantConfig(_m(pkg, "configs").ARCHS["llama3-8b"],
                                      max_batch=8, mem_fraction=0.3)},
        mode="mirage")
    return (sim.shard_partial_drain_ticks, bool(sim._cold.get("m")), guard,
            sim._unit_bytes("m"), default.shard_devices,
            default.shard_partial_drain_ticks)


@pytest.mark.parametrize("lockstep", [True, False])
def test_simulator_drain_plumbing_matches_jax(lockstep):
    partial, cold, _, _, devices, default_partial = _both(sim_drain, lockstep)
    assert (partial > 0) == (not lockstep) and cold
    assert devices == 1 and default_partial == 0


# --------------------------------------------- shared logical page space
def allocators(pkg):
    core = _m(pkg, "core")
    a = core.ShardedPagedKVAllocator(16, 4, shards=4, logical_page_bytes=4096)
    out = [a.shard_page_bytes, a.allocate("a", 10), a.allocate("b", 6)]
    out.append(a.shard_page_tables(["a", "b"], 4).tolist())
    a.check_invariants()
    a.free("a")
    out += [a.used_pages, a.pages_needed(6)]
    a.check_invariants()
    plain = core.PagedKVAllocator(8, 4)
    one = core.ShardedPagedKVAllocator(8, 4, shards=1)
    for x in (plain, one):
        x.allocate("x", 9)
        x.allocate("y", 3)
        x.free("x")
    out += [plain.page_table(["y"], 3).tolist(),
            one.page_table(["y"], 3).tolist(),
            plain.free_pages, one.free_pages]
    return tf.plain(out)


def test_sharded_allocators_match_jax():
    out = _both(allocators)
    tables = out[3]
    assert all(t == tables[0] for t in tables)
    assert out[-4] == out[-3] and out[-2] == out[-1]


# ------------------------------------------------- shard-aware PerfModel
def perf_model(pkg, arch, shards):
    serving = _m(pkg, "serving")
    cfg = _m(pkg, "configs").ARCHS[arch]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        pm = serving.PerfModel(cfg, serving.GH200, shards=shards)
    out = {"param_bytes": pm.param_bytes,
           "active_param_bytes": pm.active_param_bytes,
           "total_param_bytes": pm.total_param_bytes,
           "shard_kv_token_bytes": pm.shard_kv_token_bytes,
           "unit_bytes": pm.unit_bytes, "t_transfer_unit": pm.t_transfer_unit,
           "degrees": tf.plain(pm.degrees),
           "collective_time": [pm.collective_time(t)
                               for t in (0, 1, 8, 512, 4096)],
           "decode": [pm.decode_step_time(b, c)
                      for b, c in ((1, 512), (8, 2048), (64, 8192))],
           "prefill": [pm.prefill_time(p, b)
                       for p, b in ((128, 1), (2048, 4))],
           "t_compute_layer_decode": pm.t_compute_layer_decode,
           "reload": pm.reload_time(3)}
    return out


ARCH_NAMES = sorted(_m("repro", "configs").ARCHS)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_perf_model_matches_jax(arch):
    full = None
    for shards in (1, 2, 4, 8):
        got = _both(perf_model, arch, shards)
        if shards == 1:
            full = got
            assert got["degrees"] is None
            assert got["collective_time"] == [0.0] * 5
            continue
        assert got["total_param_bytes"] == full["param_bytes"]
        assert got["param_bytes"] == full["param_bytes"] // shards
        assert got["degrees"]["shards"] == shards
        assert got["collective_time"][0] == 0.0
        assert 0.0 < got["collective_time"][1] < got["collective_time"][4]


def test_perf_model_1_shard_is_bit_identical():
    serving = _m("repro_torch", "serving")
    cfg = _m("repro_torch", "configs").ARCHS["granite-3-8b"]
    a = serving.PerfModel(cfg, serving.GH200)
    b = serving.PerfModel(cfg, serving.GH200, shards=1)
    assert (a.param_bytes, a.unit_bytes) == (b.param_bytes, b.unit_bytes)
    for batch, ctx in ((1, 512), (8, 2048)):
        assert a.decode_step_time(batch, ctx) == b.decode_step_time(batch, ctx)
        assert a.prefill_time(ctx) == b.prefill_time(ctx)


# ------------------------------------------------------ fail-fast sizing
def fail_fast(pkg):
    serving = _m(pkg, "serving")
    big = _m(pkg, "configs").ARCHS["kimi-k2-1t-a32b"]
    rc = serving.RuntimeConfig(tenants={"big": serving.TenantSpec(big)})
    msg = _error(rc.build_simulator)
    need = int(re.search(r"shards>=(\d+)", msg).group(1))
    ok = serving.RuntimeConfig(
        tenants={"big": serving.TenantSpec(big, shards=need)})
    sim = ok.build("sim")
    small = serving.RuntimeConfig(tenants={"m": serving.TenantSpec(
        _m(pkg, "configs").ARCHS["llama3-8b"])})
    engine = _error(serving.TenantSpec(
        _m(pkg, "configs").ARCHS["llama3-8b"], params={"w": 0},
        shards=4).to_engine)
    return (msg, need, _error(ok.validate_fit, serving.GH200),
            _error(small.validate_fit, serving.GH200), type(sim).__name__,
            sim.shard_devices, engine)


def test_fail_fast_and_engine_refusal_match_jax():
    msg, need, ok, small, sim, devices, engine = _both(fail_fast)
    assert msg.startswith("ValueError") and need > 1
    assert ok is None and small is None
    assert sim == "Simulator" and devices == need
    assert engine.startswith("NotImplementedError") and "one device" in engine
    assert "backend='sim'" in engine


def test_const_state_not_sharded():
    pm = _m("repro_torch", "serving.perf_model")
    cfg = _m("repro_torch", "configs").ARCHS["llama3-8b"]
    assert pm.const_state_bytes(cfg) == 0


# ------------------------------------------------------------------ fig24
# ``benchmarks/figures.py`` fig24_shard_sets at one host link and 4 shards,
# its full 16 s trace
DURATION = 16.0


def fig24_row(pkg, link, shards, lockstep):
    archs = _m(pkg, "configs").ARCHS
    serving = _m(pkg, "serving")
    cluster = _m(pkg, "cluster")
    hw = serving.GH200.with_host_link(link)
    base = archs["kimi-k2-1t-a32b"]
    big = dataclasses.replace(base, name="kimi-k2-class-72b", num_layers=16,
                              moe=dataclasses.replace(base.moe,
                                                      num_experts=96))
    donor = "llama3-8b"
    slo = serving.SLOSpec(ttft_target=8.0, tbt_target=0.2,
                          tier=serving.LATENCY)
    big_frac = (serving.PerfModel(big, hw, shards=shards).param_bytes
                + (512 << 20)) / hw.hbm_bytes
    donor_frac = (serving.PerfModel(archs[donor], hw).param_bytes
                  + (256 << 20)) / hw.hbm_bytes
    cfg = serving.RuntimeConfig(
        tenants={
            big.name: serving.TenantSpec(
                big, slo=slo, max_batch=8, shards=shards,
                mem_fraction=big_frac,
                trace=serving.DiurnalSpec(
                    big.name, "sharegpt", 6.0, duration=DURATION,
                    period=8.0, duty=0.5, burstiness=3.0, off_scale=0.25)),
            donor: serving.TenantSpec(
                archs[donor], max_batch=16, mem_fraction=donor_frac,
                trace=serving.DiurnalSpec(
                    donor, "alpaca", 8.0, duration=DURATION, period=8.0,
                    duty=0.5, phase=4.0)),
        },
        mode="mirage", scheduler="slo", quantum_steps=4, slack_margin=0.1,
        prefill_chunk_tokens=256, step_tokens=512, shard_lockstep=lockstep)
    group = cluster.ReplicaGroup.from_config(
        cfg, 1, backend="sim", router=cluster.Router("slack_aware"), hw=hw,
        pipeline_cap=False, max_remap_fraction=0.3, reversion_hysteresis=0.4)
    group.run(cfg.trace(seed=7))
    tm = group.tier_metrics()
    lat, be = tm["latency"], tm["best_effort"]
    row = {
        "latency_p99_tbt_s": lat.p99_tbt,
        "latency_p99_ttft_s": lat.p99_ttft,
        "latency_slo_attainment": lat.slo_attainment(slo),
        "best_effort_throughput_tok_s": be.throughput_tok_s,
        "drain_ticks": group.drain_ticks,
        "partial_drain_ticks": group.partial_drain_ticks,
        "reverts": sum(1 for r in group.replicas
                       for d in r.controller.decisions_log if d.reverted),
    }
    return {"row": row, "tiers": tf.plain(tm),
            "finished": group.finished_count,
            "units": [(type(u).__name__, u.shards) for u in group.replicas]}


@pytest.mark.parametrize("lockstep", [True, False],
                         ids=["lockstep", "independent"])
def test_fig24_sweep_row_matches_jax(lockstep):
    got = _both(fig24_row, "pcie4", 4, lockstep)
    row = got["row"]
    assert got["finished"] > 0 and got["units"] == [("ShardSet", 4)]
    assert all(math.isfinite(v) for v in row.values())
    assert row["drain_ticks"] > 0
    if lockstep:
        assert row["partial_drain_ticks"] == 0
