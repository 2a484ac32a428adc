"""Workload generation: bursty arrivals + dataset-like length distributions.

ShareGPT / Alpaca length statistics follow the paper's synthetic setup
(§7.2: short ≈ 634 avg tokens, long ≈ 1734 avg tokens); arrivals are
Gamma-burst modulated Poisson, mimicking the Azure coding-trace burstiness
the paper replays (scaled to a target request rate, preserving burst shape).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.request import Request

DATASETS = {
    # (mean prompt, mean output) tokens, lognormal sigma
    "sharegpt": (415, 220, 0.9),
    "alpaca": (80, 140, 0.7),
    "synthetic_short": (434, 200, 0.5),
    "synthetic_long": (1334, 400, 0.5),
}


def _lognormal_lengths(rng, mean: float, sigma: float, n: int,
                       lo: int = 4, hi: int = 32768) -> np.ndarray:
    mu = np.log(mean) - sigma ** 2 / 2
    v = rng.lognormal(mu, sigma, n)
    return np.clip(v.astype(np.int64), lo, hi)


def _dataset_requests(rng, model: str, dataset: str, arrivals,
                      vocab: int, rid_prefix: str) -> List["Request"]:
    """Length-sample and build one tenant's requests for the given
    arrival times (shared by ``make_trace`` and ``diurnal_trace`` so the
    two workloads can never drift apart in how they sample lengths or
    construct requests). Draw order — prompt lengths, output lengths,
    then per-request prompt tokens — is part of the seed-stability
    contract."""
    mean_in, mean_out, sigma = DATASETS[dataset]
    n = len(arrivals)
    p_lens = _lognormal_lengths(rng, mean_in, sigma, n)
    o_lens = _lognormal_lengths(rng, mean_out, sigma, n)
    return [Request(
        rid=f"{rid_prefix}-{i}",
        model=model,
        prompt=rng.integers(0, vocab, int(p_lens[i])).astype(np.int32),
        max_new_tokens=int(o_lens[i]),
        arrival=float(arrivals[i]),
    ) for i in range(n)]


def bursty_arrivals(rng, rate: float, duration: float,
                    burstiness: float = 2.0) -> np.ndarray:
    """Gamma-modulated Poisson arrivals over [0, duration) at ``rate`` req/s.
    burstiness=1 -> plain Poisson; >1 -> azure-like bursts."""
    t, out = 0.0, []
    while t < duration:
        # burst episode: intensity scaled by gamma draw
        lam = rate * rng.gamma(1.0 / burstiness, burstiness)
        episode = min(duration - t, rng.uniform(1.0, 5.0))
        n = rng.poisson(lam * episode)
        out.extend(t + rng.uniform(0, episode, n))
        t += episode
    return np.sort(np.asarray(out))


@dataclasses.dataclass
class TraceSpec:
    model: str
    dataset: str
    rate: float                    # requests/s
    duration: float = 60.0
    burstiness: float = 2.0
    vocab: int = 32000


def make_trace(specs: Sequence[TraceSpec], seed: int = 0) -> List[Request]:
    """Multi-tenant request trace, merged and sorted by arrival.

    Seed stability: every spec draws from its own RNG stream, keyed by
    (seed, spec index) — adding, removing, or editing one tenant's spec
    never reshuffles another tenant's arrivals or lengths. This makes A/B
    tenant-mix experiments comparable: the control tenants see bit-identical
    workloads across runs.
    """
    reqs: List[Request] = []
    for si, spec in enumerate(specs):
        rng = np.random.default_rng([seed, si])
        arr = bursty_arrivals(rng, spec.rate, spec.duration, spec.burstiness)
        reqs.extend(_dataset_requests(rng, spec.model, spec.dataset, arr,
                                      spec.vocab, f"{spec.model}-{si}"))
    reqs.sort(key=lambda r: r.arrival)
    return reqs


# ------------------------------------------------- diurnal on/off activity
@dataclasses.dataclass
class DiurnalSpec:
    """One tenant's diurnal activity pattern: the tenant cycles between an
    ON phase (Poisson bursts at ``peak_rate``) and an OFF phase (a trickle
    at ``peak_rate * off_scale``, 0 = fully dark). Anti-phase tenants
    (``phase`` offsets of half a period) produce the paper's multi-tenant
    sweet spot: while one tenant sleeps, its parameters are pure remap
    fuel for the tenant that is awake."""
    model: str
    dataset: str
    peak_rate: float               # requests/s while ON
    duration: float = 60.0
    period: float = 30.0           # ON+OFF cycle length (s)
    duty: float = 0.5              # fraction of the period that is ON
    phase: float = 0.0             # cycle offset (s); period/2 = anti-phase
    off_scale: float = 0.0         # OFF-phase rate as a fraction of peak
    burstiness: float = 2.0        # Gamma burst shape within the ON phase
    vocab: int = 32000


def diurnal_trace(specs: Sequence[DiurnalSpec], seed: int = 0) -> List[Request]:
    """Multi-tenant diurnal/bursty trace, merged and sorted by arrival.

    Same seed-stability contract as ``make_trace``: every spec draws from
    its own RNG stream keyed by (seed, stream, spec index), so editing one
    tenant's spec never reshuffles another tenant's workload."""
    reqs: List[Request] = []
    for si, spec in enumerate(specs):
        rng = np.random.default_rng([seed, 3 << 16, si])
        on_len = spec.period * spec.duty
        arr: List[float] = []
        # walk the phase windows; each ON window gets its own bursty
        # arrival process, each OFF window a thin Poisson trickle
        t = -spec.phase % spec.period - spec.period
        while t < spec.duration:
            for win, rate in ((on_len, spec.peak_rate),
                              (spec.period - on_len,
                               spec.peak_rate * spec.off_scale)):
                if win <= 0 or rate <= 0:
                    t += win
                    continue
                win_arr = bursty_arrivals(rng, rate, win, spec.burstiness)
                arr.extend(t + a for a in win_arr
                           if 0.0 <= t + a < spec.duration)
                t += win
        arr.sort()
        reqs.extend(_dataset_requests(rng, spec.model, spec.dataset, arr,
                                      spec.vocab, f"{spec.model}-d{si}"))
    reqs.sort(key=lambda r: r.arrival)
    return reqs


# ---------------------------------------------------- multi-turn conversations
@dataclasses.dataclass
class ConversationSpec:
    """Sessions of growing multi-turn conversations (the shared-prefix
    workload): every session's turn-t prompt is the full history — a system
    prompt shared by ALL sessions of this spec, plus per-turn user
    utterances and (synthetic) assistant responses. Consecutive turns
    therefore share an ever-growing token prefix, and all sessions share
    the system prompt — the structure prefix caching exploits."""
    model: str
    num_sessions: int = 8
    turns: int = 4                  # turns per session
    system_prompt_len: int = 64
    user_len: int = 32              # mean tokens of each new user utterance
    assistant_len: int = 32         # mean tokens of each synthetic response
    max_new_tokens: int = 32        # decode budget per turn
    think_time: float = 4.0         # gap between a response and the next turn
    session_rate: float = 1.0       # session arrivals per second
    vocab: int = 32000
    sigma: float = 0.3              # lognormal spread of utterance lengths


def multi_turn_trace(specs: Sequence[ConversationSpec],
                     seed: int = 0) -> List[Request]:
    """Conversation trace for prefix-sharing experiments. Per-spec RNG
    streams (same stability contract as ``make_trace``). The *synthetic*
    assistant tokens woven into later prompts stand in for the real
    responses (unknowable at trace-generation time); the cacheable overlap
    between turn t and t+1 is turn t's full prompt, which is what a served
    system would observe minus the response itself."""
    reqs: List[Request] = []
    for si, spec in enumerate(specs):
        rng = np.random.default_rng([seed, 1 << 16, si])
        toks = lambda n: rng.integers(0, spec.vocab, int(n)).astype(np.int32)
        sys_prompt = toks(spec.system_prompt_len)
        for s in range(spec.num_sessions):
            arrival = float(s / max(spec.session_rate, 1e-9)
                            + rng.uniform(0, 1.0 / max(spec.session_rate, 1e-9)))
            history = sys_prompt
            for turn in range(spec.turns):
                user = toks(max(1, _lognormal_lengths(
                    rng, spec.user_len, spec.sigma, 1)[0]))
                prompt = np.concatenate([history, user]).astype(np.int32)
                reqs.append(Request(
                    rid=f"{spec.model}-s{s}-t{turn}",
                    model=spec.model,
                    prompt=prompt,
                    max_new_tokens=spec.max_new_tokens,
                    arrival=arrival,
                    session=f"{spec.model}-s{s}",
                ))
                assistant = toks(max(1, _lognormal_lengths(
                    rng, spec.assistant_len, spec.sigma, 1)[0]))
                history = np.concatenate([prompt, assistant]).astype(np.int32)
                arrival += spec.think_time * rng.uniform(0.7, 1.3)
    reqs.sort(key=lambda r: r.arrival)
    return reqs


# ------------------------------------------- long-prompt vs chat interference
def interference_trace(
    long_model: str,
    chat_model: str,
    *,
    n_long: int = 64,
    long_prompt: int = 8192,
    long_new: int = 8,
    n_chat: int = 48,
    chat_prompt: int = 128,
    chat_new: int = 192,
    duration: float = 24.0,
    jitter: float = 0.0,
    vocab: int = 32000,
    seed: int = 0,
) -> List[Request]:
    """Head-of-line interference workload for chunked prefill: one tenant
    streams long prompts back-to-back (near-saturated with prefill work),
    another serves steady decode-heavy chat traffic. With monolithic
    prefill every long admission stalls the shared iteration clock for a
    full ``prefill(long_prompt)``, which lands squarely on the chat
    tenant's tail TBT once the long tenant's prefill duty cycle makes
    those stalls more frequent than 1 in 100 chat tokens. Chunked prefill
    bounds each stall at ``prefill(chunk)``. Per-role RNG streams (same
    seed-stability contract as ``make_trace``)."""
    reqs: List[Request] = []
    for role, (model, n, p_len, m_new) in enumerate([
            (long_model, n_long, long_prompt, long_new),
            (chat_model, n_chat, chat_prompt, chat_new)]):
        rng = np.random.default_rng([seed, 2 << 16, role])
        for i in range(n):
            arrival = duration * i / n
            if jitter:
                arrival += rng.uniform(0, jitter)
            reqs.append(Request(
                rid=f"{model}-{'long' if role == 0 else 'chat'}-{i}",
                model=model,
                prompt=rng.integers(0, vocab, p_len).astype(np.int32),
                max_new_tokens=m_new,
                arrival=float(arrival),
            ))
    reqs.sort(key=lambda r: r.arrival)
    return reqs


# ------------------------------------------------ expert-load skew (MoE)
@dataclasses.dataclass
class ZipfRouting:
    """Synthetic MoE router popularity: expert loads follow a Zipf law
    (rank r gets weight r^-s), with the hot set ROTATING every
    ``rotation_period`` seconds (rank assignment rolls by
    ``rotation_stride`` experts) — the adversarial regime for expert
    pinning, since yesterday's hot expert is tomorrow's cold one.

    Deterministic by construction (expected counts, no sampling): the
    same trace replayed against engine and simulator feeds both the
    identical routing signal, which the differential tests rely on."""
    num_experts: int
    top_k: int
    zipf_s: float = 1.2
    rotation_period: float = 0.0       # 0 = static hot set
    rotation_stride: int = 1

    def probs_at(self, t: float) -> np.ndarray:
        """Per-expert routing probability at trace time ``t`` (sums to 1)."""
        w = np.arange(1, self.num_experts + 1, dtype=float) ** -self.zipf_s
        p = w / w.sum()
        if self.rotation_period > 0:
            shift = (int(t / self.rotation_period) * self.rotation_stride) \
                % self.num_experts
            p = np.roll(p, shift)
        return p

    def counts_at(self, t: float, tokens: int) -> np.ndarray:
        """Expected per-expert assignment counts for ``tokens`` decode
        tokens at time ``t`` (each token routes to ``top_k`` experts)."""
        return self.probs_at(t) * tokens * self.top_k

    def routed_probability(self, t: float, batch: int) -> np.ndarray:
        """P(expert touched by at least one of ``batch`` tokens) — what
        ``expected_cold_fetches`` integrates over the remapped set."""
        p = np.minimum(self.probs_at(t) * self.top_k, 1.0)
        return 1.0 - (1.0 - p) ** max(batch, 1)


@dataclasses.dataclass
class ExpertSkewSpec:
    """One MoE tenant's workload for the expert-load-skew experiments:
    standard bursty arrivals plus a ``ZipfRouting`` popularity profile
    driving which experts its decode traffic exercises."""
    model: str
    dataset: str
    rate: float                    # requests/s
    num_experts: int
    top_k: int
    duration: float = 60.0
    zipf_s: float = 1.2
    rotation_period: float = 0.0
    rotation_stride: int = 1
    burstiness: float = 2.0
    vocab: int = 32000


def expert_skew_trace(specs: Sequence[ExpertSkewSpec], seed: int = 0):
    """(requests, {model: ZipfRouting}) for MoE expert-remap experiments.

    Same per-spec RNG stream contract as ``make_trace`` (stream tag
    4<<16), so layer-granular vs expert-granular A/B runs see
    bit-identical arrivals and lengths."""
    reqs: List[Request] = []
    routing: Dict[str, ZipfRouting] = {}
    for si, spec in enumerate(specs):
        rng = np.random.default_rng([seed, 4 << 16, si])
        arr = bursty_arrivals(rng, spec.rate, spec.duration, spec.burstiness)
        reqs.extend(_dataset_requests(rng, spec.model, spec.dataset, arr,
                                      spec.vocab, f"{spec.model}-e{si}"))
        routing[spec.model] = ZipfRouting(
            spec.num_experts, spec.top_k, spec.zipf_s,
            spec.rotation_period, spec.rotation_stride)
    reqs.sort(key=lambda r: r.arrival)
    return reqs, routing


def tiny_trace(models: Sequence[str], n_per_model: int = 4,
               prompt_len: int = 8, max_new: int = 6, vocab: int = 256,
               spacing: float = 0.01, seed: int = 0) -> List[Request]:
    """Small deterministic trace for functional engine tests."""
    rng = np.random.default_rng(seed)
    reqs = []
    t = 0.0
    for i in range(n_per_model):
        for m in models:
            reqs.append(Request(
                rid=f"{m}-{i}", model=m,
                prompt=rng.integers(0, vocab, prompt_len).astype(np.int32),
                max_new_tokens=max_new, arrival=t))
            t += spacing
    return reqs
