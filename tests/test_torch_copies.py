"""The port's copies of the pure-Python control plane give results identical
to their JAX-package originals on the same inputs: each scripted scenario
runs once against ``repro`` and once against ``repro_torch``."""
import dataclasses
import importlib
import math
import tempfile
import warnings
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

PKGS = ("repro", "repro_torch")
TRACES = Path(__file__).resolve().parents[1] / "benchmarks" / "traces"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _plain(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def _try(fn, *args, **kw):
    """fn's result, or the error it raised (both packages must agree)."""
    try:
        return fn(*args, **kw)
    except Exception as e:       # noqa: BLE001 - the error IS the result
        return f"{type(e).__name__}: {e}"


# ------------------------------------------------------------- scenarios
def plan_sweep(pkg):
    ls = _mod(pkg, "core.layer_selection")
    tp = _mod(pkg, "core.transfer_pipeline")
    out = []
    for n in (2, 4, 8, 32):
        for alpha in range(0, n):
            for t_t in (0.25, 1.0, 3.0):
                out.append(_try(ls.make_plan, n, alpha, t_c=1.0, t_t=t_t))
                out.append(ls.max_alpha(n, 1.0, t_t))
                out.append(_try(tp.make_plan_pipeline, n, alpha, 1.0, t_t))
    return out


def plan_drain(pkg):
    ls = _mod(pkg, "core.layer_selection")
    tp = _mod(pkg, "core.transfer_pipeline")
    out = []
    for n, a0, a1 in ((8, 0, 3), (8, 3, 1), (32, 4, 12), (32, 12, 0)):
        cur = ls.make_plan(n, a0, t_c=1.0, t_t=0.5)
        tgt = ls.make_plan(n, a1, t_c=1.0, t_t=0.5)
        d = tp.PlanDrain(cur, tgt, 1000)
        steps = []
        for budget in (0, 999, 1000, 2500, float("inf")):
            steps.append((d.advance(budget), d.done, d.remaining_bytes,
                          d.current_plan))
        out.append(steps)
        out.append(tp.simulate_decode_step(tgt, 1.0, 0.7, cold=True))
    return out


def allocator_script(pkg):
    kv = _mod(pkg, "core.kv_allocator")
    a = kv.PagedKVAllocator(10, 4)
    log = [a.allocate("r1", 9), a.allocate("r2", 5), a.allocate("r3", 30)]
    a.cache_hold(a.seq_pages["r1"][:2])
    a.fork("r4", a.seq_pages["r1"][:2], 8)
    log.append(a.allocate("r4", 3))
    seg = a.grow(6, "B")
    log += [seg, a.page_id_bound, a.free_pages, a.releasable_pages("B")]
    log.append(a.allocate("r5", 20))
    log.append(a.free("r1"))
    log.append(a.cache_drop(a.seq_pages["r4"][:1]))
    log += [a.free("r5"), a.shrink("B"), a.page_id_bound, a.grow(3, "C"),
            a.allocate("r6", 12), dict(a.seq_pages), a.used_pages]
    a.check_invariants()
    return log


def controller_script(pkg):
    core = _mod(pkg, "core")
    store = core.MetadataStore(core.MemoryInfo(
        hbm_bytes=16 << 30, page_bytes=4096, base_kv_pages=64))
    for name, layers, prio in (("A", 8, 0), ("B", 8, 1), ("C", 16, 2)):
        store.register(core.ModelInfo(name=name, num_layers=layers,
                                      layer_bytes=4096 * 8, priority=prio))
    ctl = core.RemappingController(
        store, core.ControllerConfig(revert_patience=2),
        {"A": 0.2, "B": 0.5, "C": 0.1})
    out = []
    pressure = [True, True, False, True, True, True, False, False, False,
                False, False, False, True, False, False, False]
    for i, p in enumerate(pressure):
        store.mark_active(["A"] if i % 3 else ["B"])
        store.note_kv_usage(60 if p else 4)
        ds = ctl.step(kv_pressure=p, t_compute={"A": 1.0, "B": 1.0, "C": 0.5})
        for d in ds:
            pages = d.new_alpha * (store.models[d.model].layer_bytes
                                   // store.memory.page_bytes)
            store.memory.elastic_kv_pages += pages
        out.append((ds, {n: m.remapped_alpha
                         for n, m in store.models.items()}))
    return out


def prefix_script(pkg):
    pi = _mod(pkg, "core.prefix_index")
    idx = pi.PrefixIndex(4)
    toks = list(range(100, 117))
    out = [idx.insert(toks, [1, 2, 3, 4])[0]]
    out.append(idx.insert(toks[:8] + [7] * 8, [1, 2, 9, 10])[0])
    m = idx.match(toks, max_tokens=15)
    out += [m.pages, m.tokens, idx.peek(toks[:10]), idx.num_blocks]
    idx.acquire(m.nodes)
    out.append(idx.evict(3, evictable=lambda p: True))
    idx.release(m.nodes)
    out.append(idx.evict_pages([3, 4, 10], evictable=lambda p: p != 4))
    out += [idx.paths(), _plain(idx.stats), idx.num_blocks]
    idx.check_invariants()
    return out


def serving_script(pkg):
    traces = _mod(pkg, "serving.traces")
    cfgs = _mod(pkg, "configs")
    pm = _mod(pkg, "serving.perf_model")
    hw = _mod(pkg, "serving.hw")
    sched = _mod(pkg, "serving.scheduler")
    slo = _mod(pkg, "serving.slo")
    tr = traces.tiny_trace(["A", "B"], n_per_model=3, prompt_len=9,
                           max_new=4, vocab=256)
    conv = traces.multi_turn_trace([traces.ConversationSpec(
        "A", num_sessions=2, turns=2, system_prompt_len=8, user_len=4,
        assistant_len=4, max_new_tokens=4, think_time=8.0,
        session_rate=0.05, vocab=256, sigma=0.0)], seed=5)
    out = [[(r.rid, r.model, r.arrival, r.prompt.tolist(), r.max_new_tokens)
            for r in tr + conv]]
    for arch in ("llama3-8b", "granite-3-8b", "h2o-danube-3-4b"):
        p = pm.PerfModel(cfgs.ARCHS[arch], hw.TPU_V5E)
        out += [p.unit_bytes, p.t_transfer_unit, p.decode_step_time(8, 600),
                p.prefill_time(512), p.pipeline_inputs(
                    8, 600, _mod(pkg, "core").make_plan(32, 4, 1.0, 0.5))]
    s = sched.make_scheduler("slo", ["A", "B"], quantum_steps=2,
                             step_tokens=16,
                             specs={"A": slo.SLOSpec(4.0, 1.0, "latency"),
                                    "B": slo.SLOSpec()}, slack_margin=1.0)
    for step in range(6):
        s.observe_slack({"A": 2.0 - step, "B": float("inf")})
        out.append((s.schedule({"A": 1, "B": 2}, {"A": step % 2, "B": 1},
                               float(step)), s.prefill_budget(step)))
    return out


def trace_replay_script(pkg):
    """Synthetic records, both committed sample traces (read only), their
    CSV formats, the lowering to requests and its warnings, and the
    sample writer into a temporary directory."""
    tr = _mod(pkg, "serving.trace_replay")
    recs = tr.synth_records(120, seed=5, models=("ChatGPT", "GPT-4"),
                            model_weights=(0.5, 0.5))
    out = [recs, tr.format_azure_csv(recs[:20]),
           tr.format_burstgpt_csv(recs[:20])]
    for name in ("azure_llm_sample.csv", "burstgpt_sample.csv"):
        records, fmt = tr.load_trace(TRACES / name)
        out += [fmt, len(records), records[::25]]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for model_map in ("solo", {"ChatGPT": "a", "*": "b"},
                          {"GPT-4": "x"}, ["p", "q"]):
            reqs = tr.replay_trace(recs, model_map, time_scale=0.5,
                                   max_requests=40, seed=2,
                                   max_prompt_tokens=512)
            out.append([(r.rid, r.model, r.arrival, r.prompt.tolist(),
                         r.max_new_tokens) for r in reqs])
        out.append(_try(tr.replay_trace, recs, {"none": "x"}))
    out.append(sorted(str(w.message) for w in caught))
    out.append(tr.records_from_requests(reqs))
    spec = tr.ReplaySpec(model="t", path=str(TRACES / "azure_llm_sample.csv"),
                         max_requests=30)
    out.append([(r.rid, r.arrival, r.prompt_len) for r in spec.requests(3)])
    with tempfile.TemporaryDirectory() as d:
        out.append([Path(p).read_text() == (TRACES / Path(p).name).read_text()
                    for p in tr.write_sample_traces(d)])
    return out


class _Unit:
    """A replica as the router and the autoscaler see it."""

    def __init__(self, load, pressure=0.0, draining=False, slack=None,
                 shards=1):
        self.load, self.p, self.d, self.slack = load, pressure, draining, slack
        self.shards = shards

    def inflight(self):
        return self.load

    def pressure(self):
        return self.p

    def draining(self):
        return self.d

    def tenant_slacks(self):
        return {} if self.slack is None else {"m": self.slack}


def router_script(pkg):
    cluster = _mod(pkg, "cluster")
    Request = _mod(pkg, "serving.request").Request
    units = [_Unit(3, 0.2, slack=1.0), _Unit(1, 0.5, slack=math.inf),
             _Unit(1, 0.1, draining=True, slack=4.0),
             _Unit(2, 0.0, slack=2.0, shards=2), _Unit(0, 0.9)]
    out = []
    for policy in (cluster.LEAST_LOADED, cluster.SLACK_AWARE,
                   cluster.PREFIX_AFFINITY):
        r = cluster.Router(policy, seed=7)
        for i in range(12):
            req = Request(f"r{i}", "m",
                          np.arange(i % 5, i % 5 + 40, dtype=np.int32),
                          max_new_tokens=4,
                          session=f"s{i % 3}" if i % 2 else "")
            pick = r.route(req, units,
                           prefer={1, 3} if i % 4 == 0 else None,
                           routable=[0, 2, 3] if i % 3 == 0 else None)
            units[pick].load += 1
            out.append(pick)
        r.forget_replica(1)
        out.append(dict(r.assignments))
    out.append(_try(cluster.Router, "nope"))
    return out


def autoscaler_script(pkg):
    """The three scaling policies over windows of signals, the victim
    choice, and an autoscaler driving a simulator-backed fleet."""
    cl = _mod(pkg, "cluster")
    serving = _mod(pkg, "serving")
    traces = _mod(pkg, "serving.traces")
    sig = cl.FleetSignal
    out = []
    windows = [[], [sig(t, 24, 0.3, math.inf, 0, 2) for t in range(4)],
               [sig(t, 2, 0.1, 9.0, 0, 2) for t in range(4)],
               [sig(0, 2, 0.1, 9.0, 3, 2), sig(1, 16, 0.9, 0.2, 0, 2)],
               [sig(t, 16, 0.5, 5.0, 0, 2) for t in range(6, 9)]]
    for pol in (cl.TargetUtilizationPolicy(target_inflight=8.0),
                cl.SLOSlackPolicy(slack_out=0.5, slack_in=4.0),
                cl.SchedulePolicy(steps=[(1.0, 3), (7.0, 1)])):
        out.append([pol.desired(w, 2) for w in windows])

    class G:
        replicas = [_Unit(3), _Unit(1), _Unit(1)]
        states = [cl.ACTIVE, cl.ACTIVE, cl.ACTIVE]

    for states in ([cl.ACTIVE] * 3, [cl.ACTIVE, cl.ACTIVE, cl.LEAVING],
                   [cl.ACTIVE, cl.LEAVING, cl.LEAVING]):
        G.states = states
        out.append(cl.Autoscaler._victim(G))
    arch = _mod(pkg, "configs").ARCHS["llama3-8b"]
    hw = _mod(pkg, "serving.hw").GH200
    pm = _mod(pkg, "serving.perf_model").PerfModel(arch, hw)
    conf = serving.RuntimeConfig(
        tenants={"m": serving.TenantSpec(
            arch, max_batch=8, mem_fraction=(pm.param_bytes + 2**30)
            / hw.hbm_bytes, slo=serving.SLOSpec(1.0, 0.05, serving.LATENCY))},
        mode="mirage", scheduler="slo", prefix_sharing=True)
    sc = cl.Autoscaler(policy=cl.SLOSlackPolicy(slack_out=0.4, slack_in=6.0),
                       min_replicas=1, max_replicas=3, window=2.0,
                       cooldown=1.0, prewarm=True)
    fc = cl.FleetPrefixCache(page_size=32)
    g = cl.ReplicaGroup.from_config(conf, 1, backend="sim", fleet_cache=fc,
                                    autoscaler=sc)
    met = g.run(traces.make_trace(
        [traces.TraceSpec("m", "sharegpt", 20.0, duration=2.0,
                          burstiness=1.0)], seed=1))
    out += [sc.decisions, g.events, g.finished_count, _plain(fc.stats),
            _plain(met), g.replica_seconds]
    return out


SCENARIOS = [plan_sweep, plan_drain, allocator_script, controller_script,
             prefix_script, serving_script, trace_replay_script,
             router_script, autoscaler_script]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_copy_matches_original(scenario):
    ref, port = (_plain(scenario(pkg)) for pkg in PKGS)
    assert port == ref
