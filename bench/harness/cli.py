"""One run of one cell: set up (weights, engine, warm-up), serve the cell's
traffic for ``--seconds`` by the wall clock, check what was served against
the plain reference, and print one JSON line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (a profiled slice of the window gives the device's).
Options for measuring the benchmark itself, never given by a check:
``--control 1`` also reads the float8 control's numbers and judges them by
the cell's limits, as the program's are judged, and exits with 4 and prints
no result if the control passes them; ``--rate R`` overrides an open loop's
rate (the knee sweep).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from typing import Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """This process's start on the ``time.time()`` clock (Linux), else
    now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules(allowed=frozenset()) -> List[str]:
    """Top-level names of loaded modules that the run must not load, less
    ``allowed``."""
    return sorted(({m.split(".")[0] for m in list(sys.modules)}
                   & set(FORBIDDEN)) - set(allowed))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None)
    return ap.parse_args(argv)


CLOCKS = "clocks.sm,clocks.mem,power.draw,temperature.gpu"


def card(query: str = "name,power.limit") -> str:
    """nvidia-smi's reading of the card (its name and power limit by
    default)."""
    try:
        smi = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def setup(args, bench, device="cuda"):
    """Everything before the window: weights, engine, warm-up."""
    from harness import registry, serve, weights
    w = registry.workload(args.workload, bench)
    cell = registry.cell(args.workload)
    if (cell["config"], cell["traffic"]) != (w["config"], w["traffic"]):
        raise ValueError(f"{args.workload}: the cell file names "
                         f"{cell['config']}/{cell['traffic']}, "
                         f"BENCHMARK.json {w['config']}/{w['traffic']}")
    conf = registry.config(cell["config"])
    mix = registry.mix(cell["traffic"])
    port = conf["port"]
    t0 = time.perf_counter()
    params = [weights.make(port, args.seed, i, device)
              for i in range(cell["tenants"])]
    serve.sync(device)
    t1 = time.perf_counter()
    engine = serve.build_engine(cell, port, params, device)
    serve.sync(device)
    t2 = time.perf_counter()
    serve.warm_up(engine, cell, port["vocab_size"], device)
    log(f"[setup] weights {t1 - t0:.3f} s, engine {t2 - t1:.3f} s, warm-up "
        f"{time.perf_counter() - t2:.3f} s")
    return cell, conf, mix, port, params, engine


def plans(args, cell, mix, port):
    from harness import traffic
    if mix["loop"] == "open":
        rate = args.rate if args.rate is not None else cell["rate_per_s"]
        return traffic.open_loop(mix, rate, args.seconds, args.seed,
                                 port["vocab_size"])
    return traffic.closed_loop(mix, args.seed, port["vocab_size"])


def report_metrics(entries, run) -> Dict:
    from harness import registry
    out = {}
    for m in entries:
        v = registry.metric(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None, device: str = "cuda", bench=None, hooks=None,
         allowed=frozenset(), clock=None) -> int:
    """The run; ``device``, ``bench``, ``hooks`` (called with the engine
    after set-up), ``allowed`` (forbidden modules the calling process had
    loaded before the run) and ``clock`` (``serve.drive``'s) are for the
    tests, which drive a run on the CPU inside a test process."""
    t_proc = process_start()
    args = parse(argv)
    import torch
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < 1):
        log("bench: no CUDA device (torch.cuda.is_available() is false)")
        return 2
    from harness import check, registry, serve, trace
    from harness.observed import Run, percentile
    bench = bench or registry.benchmark()
    chips = registry.workload(args.workload, bench)["chips"]
    if device == "cuda" and torch.cuda.device_count() < chips:
        log(f"bench: {args.workload} needs {chips} devices, "
            f"{torch.cuda.device_count()} present")
        return 2
    log(f"[device] torch {torch.__version__}; "
        f"{time.time() - t_proc:.3f} s from the process's start")
    with torch.no_grad():
        cell, conf, mix, port, params, engine = setup(args, bench, device)
        if hooks:
            hooks(engine)
        sl = None
        if args.trace:
            trace.Slice.warm()
            sl = trace.Slice(cell["profile"], args.seconds)
        todo = plans(args, cell, mix, port)
        serve.sync(device)
        setup_s = time.time() - t_proc
        log(f"[setup] {setup_s:.3f} s")
        rec = serve.drive(engine, cell, mix, todo, args.seconds, device,
                          profiler=sl, clock=clock or serve.WallClock)
        if sl is not None:
            sl.finish()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        run = Run(rec, cell, mix, port, args.seconds, setup_s,
                  trace=sl.data if sl else None)
        entries = registry.metrics_of(args.workload, bool(args.trace), bench)
        metrics = report_metrics(entries, run)
        events = {k: sum(1 for e in rec.events if e[1] == k)
                  for k in ("remap", "revert", "preempt")}
        late = sorted(rec.lateness)
        log(f"[window] {rec.closed_at:.3f} s, drain {rec.drain_s:.3f} s, "
            f"{len(rec.steps)} steps, {len(run.attempted())} requests sent "
            f"in it, {len(run.failed())} without a first token; generator "
            f"lateness p50 {late[len(late) // 2] if late else 0:.4f} s max "
            f"{late[-1] if late else 0:.4f} s; decode graph captures in the "
            f"window {rec.captures_in_window}; events {events}")
        q = rec.queue_samples
        if q:
            third = max(len(q) // 3, 1)
            log(f"[queue] waiting requests, mean over the first and the last "
                f"third of the steps: {sum(x for _, x in q[:third]) / third:.2f}"
                f" / {sum(x for _, x in q[-third:]) / third:.2f}")
        device_info = {"platform": "gpu" if device == "cuda" else device,
                       "kind": torch.cuda.get_device_name(0)
                       if device == "cuda" else device,
                       "count": chips, "memory_peak_bytes": int(peak)}
        breakdown = None
        if sl is not None and sl.data is not None:
            device_info["busy_s"] = sl.data.busy_s
            device_info["window_s"] = sl.data.window_s
            breakdown = {"device_ops": sl.data.top_ops(),
                         "idle_gaps": sl.data.idle_by_host()}
            log(f"[trace] slice {sl.data.window_s:.3f} s, busy "
                f"{sl.data.busy_s:.3f} s, "
                f"{sum(s.profiled for s in rec.steps)} steps, "
                f"{len(sl.data.device_ops)} device ops; profiler start "
                f"{sl.start_s:.3f} s (in the window), stop and read "
                f"{sl.read_s:.3f} s (after the drain)")
        for m, v in metrics.items():
            log(f"[metric] {m} {v['value']!r} {v['unit']}")
        pc = lambda v, p: percentile(v, p) * 1e3 if v else float("nan")
        tt, tb = run.ttfts(), run.tbts()
        log(f"[latency] ttft ms p50 {pc(tt, 50):.2f} p90 {pc(tt, 90):.2f} "
            f"p99 {pc(tt, 99):.2f} mean {sum(tt) / max(len(tt), 1) * 1e3:.2f}"
            f" ({len(tt)}); tbt ms p50 {pc(tb, 50):.2f} p95 {pc(tb, 95):.2f}"
            f" p99 {pc(tb, 99):.2f} ({len(tb)}); "
            f"{run.tokens_in_window()} tokens")
        if device == "cuda":
            log(f"[card] {card()}; after the window: {card(CLOCKS)}")
        pages = cell["pool_pages"]
        used = max((s.pages_used for s in rec.steps), default=0)
        reserved = serve.pool_bytes(engine)
        log(f"[pool] reserved {pages} pages, {reserved} B over the tenants' "
            f"pools; peak in use {used} pages ({100.0 * used / pages:.1f}%, "
            f"{reserved * used // pages} B)")
        del engine
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        res = check.judge(run, params, args.seed, control=bool(args.control),
                          log=log)
    spec = cell["check"]
    n_events = sum(events.values())
    numbers = check.numbers(res, spec, n_events)
    correct = check.passes(numbers)
    control = None
    if args.control:
        control = check.numbers(res, spec, n_events, prefix="control_")
        for k, v in control.items():
            log(f"[control] {k} {v['value']!r} limit {v['limit']!r}")
        if check.passes(control):
            log("bench: the control passes the cell's limits, so they "
                "separate nothing")
            return 4
    bad = forbidden_modules(allowed)
    if bad:
        log(f"bench: modules loaded that must not be: {bad}")
        return 3
    line = {"correct": bool(correct), "attempted": len(run.attempted()),
            "failed": len(run.failed()), "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    if control is not None:
        line["control"] = {k: v["value"] for k, v in control.items()}
        line["control_correct"] = False
    line["check"] = numbers
    for k, v in numbers.items():
        log(f"[check] {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0
