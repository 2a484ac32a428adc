"""Victim-selection policies (paper §5.2) + remap caps.

Order in which models donate parameter memory (first donates first):
  1. inactive models before active ones (always);
  2. within each group, best-effort tenants before latency-critical ones
     (``ModelInfo.slo_tier``) — the SLO layer's rule that *who* pays the
     reclamation cost matters as much as how much is reclaimed;
  3. then by live SLO slack, descending — the model with the most
     deadline headroom donates first (inf = no SLO, donates earliest);
  4. then scheduler priority if provided (lowest number donates first);
  5. then recency: MRU — the *most recently used* model is remapped
     first, deferring its reload cost furthest into the future under
     round-robin scheduling (paper Fig. 11: MRU beats LRU by up to 22%
     tail latency) — or LRU when configured;
  6. name, so the order is fully deterministic.

Unlike the earlier implementation, priority and recency compose as sort
keys instead of priority *replacing* recency: two models with equal
priority still order by MRU/LRU, and every comparison has a total order.
``next_revert`` walks the same order backwards (active, latency-critical,
least-slack models get their parameters back first) and honours the same
``use_priority`` switch as ``next_victim``.
"""
from __future__ import annotations

import math
from typing import List, Optional

from repro_torch.core.metadata_store import MetadataStore, ModelInfo


def _donate_key(m: ModelInfo, policy: str, have_prio: bool):
    if policy == "mru":
        recency = -m.last_active_step
    elif policy == "lru":
        recency = m.last_active_step
    else:
        raise ValueError(f"unknown victim policy {policy!r}")
    slack = m.slack if m.slack == m.slack else math.inf   # NaN -> inf
    # same semantics as serving/slo.tier_rank: best-effort donates first,
    # anything else (latency-critical or an unrecognized tier string) is
    # protected — the two halves of "who pays" must never disagree
    tier = 0 if m.slo_tier == "best_effort" else 1
    return (tier, -slack, m.priority if have_prio else 0, recency, m.name)


def victim_order(store: MetadataStore, policy: str = "mru",
                 use_priority: bool = True) -> List[ModelInfo]:
    inactive = store.inactive_models()
    active = store.active_models()
    have_prio = use_priority and any(m.priority for m in store.models.values())
    inactive.sort(key=lambda m: _donate_key(m, policy, have_prio))
    # active models donate last, ordered by the same tier/slack/priority
    # key (lowest priority number donates first)
    active.sort(key=lambda m: _donate_key(m, policy, have_prio))
    return inactive + active


def next_victim(store: MetadataStore, policy: str = "mru",
                alpha_caps: Optional[dict] = None,
                use_priority: bool = True) -> Optional[ModelInfo]:
    """First model in victim order that can still donate a unit."""
    for m in victim_order(store, policy, use_priority):
        cap = m.max_alpha_cap
        if alpha_caps and m.name in alpha_caps:
            cap = min(cap, alpha_caps[m.name])
        if m.remapped_alpha < cap:
            return m
    return None


def next_revert(store: MetadataStore, policy: str = "mru",
                use_priority: bool = True) -> Optional[ModelInfo]:
    """Model whose parameters we restore first when pressure subsides:
    reverse of the victim order — active, latency-critical, least-slack
    models (most likely to need their layers next) revert first."""
    for m in reversed(victim_order(store, policy, use_priority)):
        if m.remapped_alpha > 0:
            return m
    return None
