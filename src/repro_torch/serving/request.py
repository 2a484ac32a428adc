"""Serving request + lifecycle bookkeeping."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.slo import SLOSpec, slo_attainment as _slo_attainment

# Admission watermark: tokens of decode headroom reserved per running
# request so decode can always progress without admission thrash. The ONE
# shared knob behind both runtimes: the engine reserves
# ``pages_needed(DECODE_WATERMARK_TOKENS)`` allocator pages per running
# request, the simulator charges the same number of KV-token bytes.
DECODE_WATERMARK_TOKENS = 32


@dataclasses.dataclass
class Request:
    rid: str
    model: str
    prompt: np.ndarray                 # int32 tokens
    max_new_tokens: int
    arrival: float = 0.0
    session: str = ""                  # conversation id (multi-turn traces)
    # runtime
    slot: int = -1                     # decode batch slot (engine)
    generated: List[int] = dataclasses.field(default_factory=list)
    t_first_token: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    finished: bool = False
    preemptions: int = 0               # vLLM-baseline recompute evictions
    prefix_matched_tokens: int = 0     # prefill tokens served from the cache
    #                                    (accumulated across re-admissions)
    # chunked prefill: tokens already computed + scattered into the paged
    # pool (includes any CoW-shared prefix). prefilling=True while the
    # request owns a batch slot but has not yet emitted its first token.
    prefill_pos: int = 0
    prefilling: bool = False

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def total_len(self) -> int:
        return self.prompt_len + len(self.generated)

    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival

    def tbts(self) -> List[float]:
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]


def percentile(vals, p) -> float:
    if not vals:
        return float("nan")
    return float(np.percentile(np.asarray(vals, np.float64), p))


@dataclasses.dataclass
class ServingMetrics:
    p99_ttft: float
    p99_tbt: float
    p50_ttft: float
    p50_tbt: float
    mean_ttft: float
    throughput_tok_s: float
    total_tokens: int
    makespan: float
    preemptions: int
    # prefix sharing (0 when disabled)
    saved_prefill_tokens: int = 0      # prompt tokens served from cached KV
    prefix_hit_rate: float = 0.0       # saved / total prompt tokens
    # transfer pipeline (0 when never remapped): fetch-miss stall charged
    # by the event model, filled in by the runtime after aggregation.
    # bubble_time is ALWAYS in modeled seconds — in the functional engine
    # (whose other metrics count steps) it comes from the PerfModel, so
    # only the unitless bubble_fraction is comparable to its step clock
    bubble_time: float = 0.0           # total stall (modeled seconds)
    bubble_fraction: float = 0.0       # stall / total modeled decode time
    # requests submitted but not finished when the run was truncated
    # (engine: max_steps exhausted; simulator: max_time) — nonzero means
    # the latency/throughput numbers above under-count real work
    unfinished: int = 0
    # fleet prefix cache (0 when no FleetPrefixCache is installed; filled
    # by ReplicaGroup.metrics from the fleet index's counters).
    # fleet_hit_rate = fleet-matched / looked-up prompt tokens — the
    # replica-count-invariant counterpart of prefix_hit_rate
    fleet_hit_rate: float = 0.0
    transferred_prefix_tokens: int = 0   # fetched cross-replica
    recomputed_prefix_tokens: int = 0    # fleet-hit but recompute won
    prefix_fetch_bytes: int = 0          # KV bytes moved over host links
    # per-request (ttft-or-None, max tbt) samples retained so SLO
    # attainment can be evaluated against any spec after the fact
    _per_request: List = dataclasses.field(
        default_factory=list, repr=False, compare=False)
    # raw pooled samples + denominators retained so ``merge`` can
    # recompute fleet-level tails from samples, never average tails
    _tbts: List = dataclasses.field(
        default_factory=list, repr=False, compare=False)
    _prompt_tokens: int = dataclasses.field(
        default=0, repr=False, compare=False)
    _decode_time: float = dataclasses.field(   # bubble_fraction denominator
        default=0.0, repr=False, compare=False)
    # fleet_hit_rate numerator/denominator, kept so ``merge`` recomputes
    # the rate from pooled counts instead of averaging rates
    _fleet_matched_tokens: int = dataclasses.field(
        default=0, repr=False, compare=False)
    _fleet_lookup_tokens: int = dataclasses.field(
        default=0, repr=False, compare=False)

    @staticmethod
    def from_requests(reqs: List[Request], makespan: float,
                      model: Optional[str] = None) -> "ServingMetrics":
        """Aggregate over ``reqs`` (optionally one tenant's slice — the
        interference benchmarks report the victim tenant's tail alone)."""
        if model is not None:
            reqs = [r for r in reqs if r.model == model]
        # one pass: ttft()/tbts() are per-request allocations, and a
        # million-request replay calls this once per request
        ttfts, tbts, per_request = [], [], []
        for r in reqs:
            tf = r.ttft()
            bt = r.tbts()
            if tf is not None:
                ttfts.append(tf)
            tbts.extend(bt)
            per_request.append((tf, max(bt, default=0.0)))
        tokens = sum(len(r.generated) for r in reqs)
        saved = sum(r.prefix_matched_tokens for r in reqs)
        prompt_tokens = sum(r.prompt_len for r in reqs)
        return ServingMetrics(
            p99_ttft=percentile(ttfts, 99),
            p99_tbt=percentile(tbts, 99),
            p50_ttft=percentile(ttfts, 50),
            p50_tbt=percentile(tbts, 50),
            mean_ttft=float(np.mean(ttfts)) if ttfts else float("nan"),
            throughput_tok_s=tokens / makespan if makespan > 0 else float("nan"),
            total_tokens=tokens,
            makespan=makespan,
            preemptions=sum(r.preemptions for r in reqs),
            saved_prefill_tokens=saved,
            prefix_hit_rate=saved / prompt_tokens if prompt_tokens else 0.0,
            _per_request=per_request,
            _tbts=tbts,
            _prompt_tokens=prompt_tokens,
        )

    @staticmethod
    def merge(parts: List["ServingMetrics"]) -> "ServingMetrics":
        """Fleet-level aggregate over per-replica metrics (``ReplicaGroup``).

        Tails are recomputed from the POOLED per-request samples — an
        average of per-replica p99s would systematically understate the
        fleet tail whenever one replica is the straggler. Makespan is the
        max (replicas run concurrently) and throughput is pooled tokens
        over that merged makespan. Parts with no samples (a tier that
        idled on some replica — NaN rows) contribute nothing, so merging
        all-empty slices stays NaN instead of degrading to zeros."""
        parts = list(parts)
        per_request = [s for p in parts for s in p._per_request]
        ttfts = [t for t, _ in per_request if t is not None]
        tbts = [x for p in parts for x in p._tbts]
        tokens = sum(p.total_tokens for p in parts)
        makespan = max((p.makespan for p in parts), default=0.0)
        prompt_tokens = sum(p._prompt_tokens for p in parts)
        saved = sum(p.saved_prefill_tokens for p in parts)
        bubble = sum(p.bubble_time for p in parts)
        decode = sum(p._decode_time for p in parts)
        fleet_matched = sum(p._fleet_matched_tokens for p in parts)
        fleet_lookup = sum(p._fleet_lookup_tokens for p in parts)
        return ServingMetrics(
            p99_ttft=percentile(ttfts, 99),
            p99_tbt=percentile(tbts, 99),
            p50_ttft=percentile(ttfts, 50),
            p50_tbt=percentile(tbts, 50),
            mean_ttft=float(np.mean(ttfts)) if ttfts else float("nan"),
            throughput_tok_s=tokens / makespan if makespan > 0
            else float("nan"),
            total_tokens=tokens,
            makespan=makespan,
            preemptions=sum(p.preemptions for p in parts),
            saved_prefill_tokens=saved,
            prefix_hit_rate=saved / prompt_tokens if prompt_tokens else 0.0,
            bubble_time=bubble,
            bubble_fraction=bubble / decode if decode else 0.0,
            unfinished=sum(p.unfinished for p in parts),
            fleet_hit_rate=fleet_matched / fleet_lookup
            if fleet_lookup else 0.0,
            transferred_prefix_tokens=sum(
                p.transferred_prefix_tokens for p in parts),
            recomputed_prefix_tokens=sum(
                p.recomputed_prefix_tokens for p in parts),
            prefix_fetch_bytes=sum(p.prefix_fetch_bytes for p in parts),
            _per_request=per_request,
            _tbts=tbts,
            _prompt_tokens=prompt_tokens,
            _decode_time=decode,
            _fleet_matched_tokens=fleet_matched,
            _fleet_lookup_tokens=fleet_lookup,
        )

    def slo_attainment(self, spec: SLOSpec) -> float:
        """Fraction of this slice's requests meeting ``spec`` (request
        level: TTFT within target AND every TBT within target). NaN when
        the slice is empty; a request that never got a first token counts
        as a miss."""
        ttfts = [t for t, _ in self._per_request]
        max_tbts = [m for _, m in self._per_request]
        return _slo_attainment(ttfts, max_tbts, spec)

    @staticmethod
    def per_tier(reqs: List[Request], specs: Dict[str, SLOSpec],
                 makespan: float) -> Dict[str, "ServingMetrics"]:
        """Tail metrics per SLO tier. Every tier named by ``specs`` gets an
        entry, including tiers with no finished requests (NaN tails, zero
        tokens) — benchmark tables stay rectangular when a tier idles."""
        out: Dict[str, ServingMetrics] = {}
        for tier in dict.fromkeys(s.tier for s in specs.values()):
            models = {m for m, s in specs.items() if s.tier == tier}
            out[tier] = ServingMetrics.from_requests(
                [r for r in reqs if r.model in models], makespan)
        return out

    def row(self) -> str:
        return (f"p99_ttft={self.p99_ttft:.4f} p99_tbt={self.p99_tbt:.5f} "
                f"p50_tbt={self.p50_tbt:.5f} thru={self.throughput_tok_s:.1f} "
                f"preempt={self.preemptions} "
                f"prefix_hit={self.prefix_hit_rate:.2f}")
