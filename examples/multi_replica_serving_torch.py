"""Replica fleet with remap-aware routing + coordinated reverts, on the
PyTorch port's simulator and cluster layer (no tensors: the same numbers
as the JAX package's ``examples/multi_replica_serving.py``, line for line).

Two simulator replicas (each a full accelerator: own allocator, own
RemappingController) serve a latency-critical chat tenant and a
best-effort batch tenant in diurnal anti-phase, declared ONCE via
``RuntimeConfig``/``TenantSpec`` and lowered to the simulator backend.
The slack-aware router avoids replicas mid remap-drain, and the
``CoordinatedRemapPolicy`` staggers Dynamic Reversion so one replica's
revert drains while its twin absorbs the traffic (compare the
simultaneous-drain tick counts below).

  PYTHONPATH=src python examples/multi_replica_serving_torch.py
"""
import argparse

from repro_torch.cluster import ReplicaGroup, Router
from repro_torch.configs import ARCHS
from repro_torch.serving import (
    DiurnalSpec, LATENCY, RuntimeConfig, SLOSpec, TenantSpec,
)
from repro_torch.serving.hw import GH200
from repro_torch.serving.perf_model import PerfModel

CHAT, BATCH = "granite-3-8b", "llama3-8b"
CHAT_SLO = SLOSpec(ttft_target=1.0, tbt_target=0.04, tier=LATENCY)
HW = GH200.with_host_link("pcie5")   # drains cost real iterations here


def frac(name, kv_gb):
    pm = PerfModel(ARCHS[name], HW)
    return (pm.param_bytes + kv_gb * 2**30) / HW.hbm_bytes


def config():
    return RuntimeConfig(
        tenants={
            CHAT: TenantSpec(
                ARCHS[CHAT], slo=CHAT_SLO, max_batch=8,
                mem_fraction=frac(CHAT, 0.25),
                trace=DiurnalSpec(CHAT, "sharegpt", 16.0, duration=24.0,
                                  period=12.0, duty=0.5, burstiness=3.0,
                                  off_scale=0.25)),
            BATCH: TenantSpec(
                ARCHS[BATCH], max_batch=32, mem_fraction=frac(BATCH, 1.0),
                trace=DiurnalSpec(BATCH, "alpaca", 12.0, duration=24.0,
                                  period=12.0, duty=0.5, phase=6.0)),
        },
        mode="mirage", scheduler="slo", quantum_steps=4, slack_margin=0.04,
        prefill_chunk_tokens=128, step_tokens=256)


def main(argv=None) -> dict:
    argparse.ArgumentParser().parse_args(argv)
    out = {}
    for coordinate in (False, True):
        cfg = config()
        group = ReplicaGroup.from_config(
            cfg, n_replicas=2, backend="sim",
            router=Router("slack_aware"), coordinate=coordinate,
            hw=HW, reversion_hysteresis=0.4)
        group.run(cfg.trace(seed=11))
        tiers = group.tier_metrics()
        lat, be = tiers["latency"], tiers["best_effort"]
        label = "coordinated " if coordinate else "uncoordinated"
        print(f"{label}: lat p99 TBT {lat.p99_tbt * 1e3:7.2f} ms  "
              f"p99 TTFT {lat.p99_ttft:6.2f} s  "
              f"attainment {lat.slo_attainment(CHAT_SLO):5.1%}  "
              f"be thru {be.throughput_tok_s:6.0f} tok/s")
        print(f"  drain ticks {group.drain_ticks}, simultaneous "
              f"{group.simultaneous_drain_ticks}, routed "
              f"{len(group.router.assignments)} requests "
              f"({sum(1 for v in group.router.assignments.values() if v == 0)}"
              f"/{sum(1 for v in group.router.assignments.values() if v == 1)}"
              " per replica)")
        out[label.strip()] = {
            "p99_tbt": lat.p99_tbt, "p99_ttft": lat.p99_ttft,
            "attainment": lat.slo_attainment(CHAT_SLO),
            "throughput": be.throughput_tok_s,
            "simultaneous_drain_ticks": group.simultaneous_drain_ticks}
    return out


if __name__ == "__main__":
    main()
