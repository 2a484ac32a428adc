"""Every name in BENCHMARK.json finds its file: each cell, its
configuration and its traffic mix, and each metric's reader; the
configurations' ``port`` widths are what the port's registry runs, and the
file keeps to the benchmark's contract's limits."""
import dataclasses
import json
import os
import re

import pytest

import benchkit
from harness import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    cell = registry.cell(w["name"])
    assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
    conf = registry.config(w["config"])
    mix = registry.mix(w["traffic"])
    assert mix["loop"] in ("open", "closed")
    assert ("rate_per_s" in cell) == (mix["loop"] == "open")
    assert cell["engine"] == {"mode": "mirage", "scheduler": "spatial",
                              "prefill_chunk_tokens": 0,
                              "decode_graphs": True}
    assert conf["port"]["name"] == w["config"]
    assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_readers(kind):
    for m in BENCH[kind]:
        mod = registry.metric(m["name"])
        assert callable(mod.read), m["name"]
        assert NAME.match(m["name"])
        if kind == "per_layer":
            assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_is_the_ports(c):
    """The ``port`` widths a configuration file runs are the port
    registry's model of that name, field for field, but for the RoPE base,
    which runs as published."""
    from repro_torch.configs import ARCHS
    from harness.serve import model_config
    conf = registry.config(c["name"])
    assert c["file"] == f"bench/configs/{c['name']}.json"
    assert conf["source"] == c["source"]
    assert set(conf["reduced"]) == set(c["reduced"])
    run = model_config(conf["port"])
    ref = ARCHS[c["name"]]
    assert run.rope_theta == conf["rope_theta"]
    for f in dataclasses.fields(run):
        if f.name not in ("source", "rope_theta"):
            assert getattr(run, f.name) == getattr(ref, f.name), f.name
    widths = re.compile(r"(_dim|_rank|hidden_size|intermediate_size|"
                        r"num_experts_per_tok|heads)$")
    assert not [k for k in conf["reduced"] if widths.search(k)]
    for k, v in conf["published"].items():
        assert k in conf["reduced"] and conf[k] != v


def test_benchmark_json_limits():
    with open(os.path.join(benchkit.ROOT, "BENCHMARK.json")) as f:
        raw = f.read()
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(raw.encode()) <= 64 * 1024
    assert b["paths"] == ["bench"] and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in b["per_layer"]:
        assert "bound" not in m and len(m["layer"]) <= 200


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_what_its_metrics_move(w):
    """A cell reports ``setup_s``, another end-to-end metric and a
    per-layer metric, and every per-layer metric it reports moves an
    end-to-end metric that it reports too."""
    e2e = {m["name"] for m in registry.metrics_of(w["name"], False, BENCH)}
    layer = registry.metrics_of(w["name"], True, BENCH)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert all(m["moves"] in e2e for m in layer), w["name"]


def test_metric_workloads_name_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert set(m.get("workloads", cells)) <= cells, m["name"]


def test_a_suffixed_name_reads_its_base_reader():
    """``<reader>.<suffix>`` with no file of its own loads ``<reader>``'s;
    a name with no reader under any prefix is an error."""
    assert registry.reader("decode.mfu.batch") == "decode.mfu"
    assert registry.reader("decode.mfu") == "decode.mfu"
    with pytest.raises(KeyError):
        registry.reader("no_such_metric.batch")
