"""Helpers of the benchmark's tests: the harness's import path, tiny
stand-ins for the configurations and cells, and a whole run of a tiny cell
on the CPU (``run_tiny``), which drives everything but the look for a
card."""
from __future__ import annotations

import copy
import io
import json
import os
import sys
from contextlib import redirect_stderr, redirect_stdout

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

DENSE = {"name": "tiny-dense", "family": "dense", "num_layers": 2,
         "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab_size": 256, "rope_theta": 10000.0,
         "norm_eps": 1e-05, "tie_embeddings": False, "dtype": "bfloat16",
         "moe": None}
# the MoE runs in f32: in bf16 at this width its routing flips against
# the f32 reference as often as float8's do, and no limit separates them
MOE = dict(DENSE, name="tiny-moe", family="moe", d_ff=0, num_kv_heads=4,
           dtype="float32",
           moe={"num_experts": 8, "top_k": 2, "d_expert": 32,
                "capacity_factor": 1.25, "min_capacity": 2, "period": 1})

OPEN_MIX = {"name": "tiny-open", "loop": "open", "arrivals": "poisson",
            "tenant_shares": [3, 1],
            "prompt_tokens": {"dist": "lognormal", "mean": 12, "sigma": 0.5,
                              "min": 4, "max": 24},
            "output_tokens": {"dist": "lognormal", "mean": 8, "sigma": 0.5,
                              "min": 3, "max": 16}}
CLOSED_MIX = {"name": "tiny-closed", "loop": "closed", "clients": 4,
              "think_s": 0.0, "requests_per_client": 40,
              "tenant_shares": [1],
              "prompt_tokens": {"dist": "lognormal", "mean": 10, "sigma": 0.5,
                                "min": 4, "max": 20},
              "output_tokens": {"dist": "lognormal", "mean": 10,
                                "sigma": 0.5, "min": 4, "max": 16}}


def cell(config: str, traffic: str, tenants: int, **kw):
    c = {"config": config, "traffic": traffic, "tenants": tenants,
         "slots": 4, "max_context": 48, "page_size": 4,
         "pool_pages": 112, "rate_per_s": 40.0, "drain_s": 20,
         "engine": {"mode": "mirage", "scheduler": "spatial",
                    "prefill_chunk_tokens": 0, "decode_graphs": True},
         "warm_up": {"prompt": 8, "new": 3},
         "profile": {"tail_s": 0.5},
         "check": {"sample_tokens": 60, "min_tokens": 10,
                   "limits": {"logit_gap": 0.05}}}
    c.update(kw)
    return c


CELLS = {"tiny-dense.open": cell("tiny-dense", "tiny-open", 2),
         "tiny-moe.closed": cell(
             "tiny-moe", "tiny-closed", 1,
             check={"sample_tokens": 60, "min_tokens": 10,
                    "limits": {"logit_gap": 1e-3, "logit_gap_mean": 1e-4}})}
CONFIGS = {"tiny-dense": {"port": DENSE}, "tiny-moe": {"port": MOE}}
MIXES = {"tiny-open": OPEN_MIX, "tiny-closed": CLOSED_MIX}


def bench(cells=None):
    """A BENCHMARK.json of the tiny cells with the real metric names."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        real = json.load(f)
    b = copy.deepcopy(real)
    b["workloads"] = [{"name": n, "config": c["config"],
                       "traffic": c["traffic"], "chips": 1, "why": "test"}
                      for n, c in (cells or CELLS).items()]
    for m in b["per_layer"] + b["end_to_end"]:
        m.pop("workloads", None)
    return b


def patch_registry(monkeypatch, cells=None):
    from harness import registry
    cells = cells or CELLS
    monkeypatch.setattr(registry, "cell", lambda n: copy.deepcopy(cells[n]))
    monkeypatch.setattr(registry, "config",
                        lambda n: copy.deepcopy(CONFIGS[n]))
    monkeypatch.setattr(registry, "mix", lambda n: copy.deepcopy(MIXES[n]))


class StepClock:
    """A clock that counts: each reading advances it by ``tick`` seconds and
    ``sleep`` by the time asked, so a tiny run takes the same steps however
    busy the host's cores are (a test run shares them with other
    workers)."""

    def __init__(self, tick: float = 0.005):
        self.t, self.tick = 0.0, tick

    def now(self) -> float:
        self.t += self.tick
        return self.t

    def sleep(self, s: float) -> None:
        self.t += max(s, 0.0)


def run_tiny(monkeypatch, workload: str, seed: int = 5, seconds: float = 1.5,
             hooks=None, control: bool = False, cells=None):
    """(exit code, the result line or None, standard error) of a whole run
    of a tiny cell on the CPU."""
    from harness import cli
    patch_registry(monkeypatch, cells)
    # the repository's other tests load jax and repro in this process
    loaded = cli.forbidden_modules()
    out, err = io.StringIO(), io.StringIO()
    argv = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", "0", "--control", str(int(control))]
    # one thread, as bench/run.py sets it: the test workers share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with redirect_stdout(out), redirect_stderr(err):
            rc = cli.main(argv, device="cpu", bench=bench(cells),
                          hooks=hooks, allowed=loaded, clock=StepClock())
    finally:
        torch.set_num_threads(threads)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
