"""Find a cell's files by the names ``BENCHMARK.json`` gives: the cell
``bench/cells/<workload>.json``, its configuration
``bench/configs/<config>.json``, its traffic mix
``bench/traffic/<traffic>.json`` and each metric's reader
``bench/metrics/<metric>.py`` (a module with ``read(run)``, which returns
a number or None where it finds nothing to read). A metric named
``<reader>.<suffix>`` with no file of its own is read by ``<reader>``'s:
the same quantity in the cells where it moves another end-to-end metric
(``decode.mfu.batch``: ``decode.mfu`` in the closed-loop cell)."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> Dict:
    return _json(ROOT, "BENCHMARK.json")


def workload(name: str, bench: Optional[Dict] = None) -> Dict:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell(name: str) -> Dict:
    return _json(BENCH, "cells", f"{name}.json")


def config(name: str) -> Dict:
    return _json(BENCH, "configs", f"{name}.json")


def mix(name: str) -> Dict:
    return _json(BENCH, "traffic", f"{name}.json")


def reader(name: str) -> str:
    """The reader file's name of metric ``name``: its own, or that of the
    longest dotted prefix of it that has one."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        base = ".".join(parts[:n])
        if os.path.exists(os.path.join(BENCH, "metrics", f"{base}.py")):
            return base
    raise KeyError(f"no reader for metric {name!r} in bench/metrics")


def metric(name: str):
    name = reader(name)
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(name: str, traced: bool, bench: Optional[Dict] = None
               ) -> List[Dict]:
    """The metric entries a run of workload ``name`` reports: its
    end-to-end metrics untraced, its per-layer metrics traced (an entry
    with ``workloads`` applies to the cells it lists, one without to
    every cell)."""
    bench = bench or benchmark()
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]
