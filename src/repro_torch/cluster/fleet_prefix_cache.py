"""Fleet-wide content-addressed prefix cache.

``PrefixIndex`` is strictly per-replica: a system prompt cached on
replica A is recomputed from scratch on B, so fleet-level prefix hit
rate *falls* as replicas scale — the inverse of what a multi-tenant
fleet needs. This module is the cluster-level fix: one fleet index maps
SHA-truncated **chained** content hashes of token blocks (block i's key
covers blocks 0..i, so one key lookup proves the whole prefix matches)
to the set of replicas currently holding that block's KV.

    publish (any replica finishes a prefill)
        ──>  fleet index: chain key -> {holders, last_use, seq}
    match (router consults before assignment)
        ──>  per-replica contiguous depth: how much of THIS prompt each
             replica could serve from cache
    import (fleet hit lands on a cold replica)
        ──>  fetch the span's KV pages over the host link — unless the
             analytic transfer-vs-recompute decision
             (``PerfModel.prefix_transfer_costs``) says the marginal
             prefill is cheaper

Eviction is the ``prompt-cache-engine`` dual rule: TTL (entries idle
longer than ``ttl`` are expired on touch) AND capacity (LRU by
``(last_use, seq)`` — insertion order breaks ties, never dict order).
The index stores no KV bytes, only hashes and holder sets: it can be
stale (a holder may have evicted locally), so consumers re-verify with
``ServingRuntime.prefix_probe`` before fetching.

The fleet cache never mutates replica state on ``match``/``publish``;
with one replica every hit is already local and no fetch can trigger, so
a 1-replica fleet-cache run stays byte-identical to the bare runtime.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.core.prefix_index import chain_hashes


@dataclasses.dataclass
class FleetStats:
    lookups: int = 0
    hits: int = 0                   # lookups matching >= 1 block fleet-wide
    lookup_tokens: int = 0
    matched_tokens: int = 0         # tokens covered by the fleet index
    publishes: int = 0
    published_blocks: int = 0       # distinct new (key, holder) additions
    expired_blocks: int = 0         # TTL evictions
    evicted_blocks: int = 0         # capacity evictions
    transfers: int = 0              # cross-replica KV fetches performed
    transferred_tokens: int = 0     # prefix tokens moved over the host link
    recomputed_tokens: int = 0      # fleet-hit tokens recomputed (fetch lost)
    fetch_bytes: int = 0            # KV bytes fetched cross-replica
    dedup_coroutes: int = 0         # same-round arrivals steered to a leader

    @property
    def hit_rate(self) -> float:
        """Fraction of looked-up prompt tokens cached SOMEWHERE in the
        fleet — the replica-count-invariant counterpart of the local
        ``PrefixStats.hit_rate`` (which dilutes as replicas scale)."""
        return self.matched_tokens / self.lookup_tokens \
            if self.lookup_tokens else 0.0


class _Entry:
    __slots__ = ("key", "holders", "last_use", "seq")

    def __init__(self, key: str, last_use: float, seq: int):
        self.key = key
        self.holders: Set[int] = set()
        self.last_use = last_use
        self.seq = seq


@dataclasses.dataclass
class FleetMatch:
    """Result of one fleet lookup: ``tokens`` is the longest chained span
    present anywhere (any holder per block); ``depths`` maps replica ->
    contiguous-from-block-0 span (tokens) that replica holds, which is
    what a fetch needs (a mid-chain block with no leading blocks cannot
    be imported — the chain key wouldn't attach to anything local)."""
    tokens: int = 0
    depths: Dict[int, int] = dataclasses.field(default_factory=dict)

    def best_holder(self, exclude: int = -1) -> "tuple[int, int]":
        """Deepest-span holder (tie: lowest replica index), excluding
        ``exclude``. Returns (replica, span_tokens) or (-1, 0)."""
        best, depth = -1, 0
        for h in sorted(self.depths):
            if h == exclude:
                continue
            d = self.depths[h]
            if d > depth:
                best, depth = h, d
        return best, depth


class FleetPrefixCache:
    def __init__(self, page_size: int, *, capacity_blocks: int = 1_000_000,
                 ttl: float = math.inf):
        assert page_size >= 1
        self.page_size = page_size
        self.capacity_blocks = capacity_blocks
        #: idle time (in the driving runtime's clock units) after which an
        #: entry expires; checked lazily on match/publish
        self.ttl = ttl
        self.stats = FleetStats()
        self._entries: Dict[str, _Entry] = {}
        self._seq = 0

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------- publish
    def publish(self, replica: int, model: str, tokens: Sequence[int],
                now: float = 0.0) -> int:
        """Record that ``replica`` now holds the KV of every full block of
        ``tokens``. Idempotent; returns the number of new (key, holder)
        pairs added. Keys are rooted at the model name, so equal token
        streams of different tenants never alias."""
        self.stats.publishes += 1
        added = 0
        for key in chain_hashes(tokens, self.page_size, root_key=model):
            e = self._entries.get(key)
            if e is None:
                self._seq += 1
                e = _Entry(key, now, self._seq)
                self._entries[key] = e
            if replica not in e.holders:
                e.holders.add(replica)
                added += 1
            e.last_use = now
        self.stats.published_blocks += added
        self._evict_capacity()
        return added

    # --------------------------------------------------------------- match
    def match(self, model: str, tokens: Sequence[int], now: float = 0.0,
              max_tokens: Optional[int] = None) -> FleetMatch:
        """Longest chained span of ``tokens`` present in the fleet, plus
        each replica's contiguous depth. Expired entries are dropped on
        touch (the TTL half of the dual eviction); live matched entries
        get their ``last_use`` refreshed (the LRU half)."""
        n = len(tokens) if max_tokens is None else min(len(tokens),
                                                       max_tokens)
        self.stats.lookups += 1
        self.stats.lookup_tokens += n
        m = FleetMatch()
        alive: Optional[Set[int]] = None
        blocks = 0
        for key in chain_hashes(tokens, self.page_size, max_tokens,
                                root_key=model):
            e = self._entries.get(key)
            if e is not None and now - e.last_use > self.ttl:
                del self._entries[key]
                self.stats.expired_blocks += 1
                e = None
            if e is None:
                break
            blocks += 1
            e.last_use = now
            if alive is None:
                alive = set(e.holders)
            else:
                for r in alive - e.holders:
                    m.depths[r] = (blocks - 1) * self.page_size
                alive &= e.holders
        for r in alive or ():
            m.depths[r] = blocks * self.page_size
        m.tokens = blocks * self.page_size
        self.stats.matched_tokens += m.tokens
        if m.tokens:
            self.stats.hits += 1
        return m

    # ----------------------------------------------------- pre-flight dedup
    def batch_key(self, model: str, tokens: Sequence[int]) -> Optional[str]:
        """Chain key of the leading block — the grouping key for
        pre-flight batch dedup (requests sharing it share at least one
        prefillable block). ``None`` for prompts under one block."""
        keys = chain_hashes(tokens, self.page_size, self.page_size,
                            root_key=model)
        return keys[0] if keys else None

    def analyze_batch(self, batch: Sequence["tuple[str, Sequence[int]]"]
                      ) -> Dict[str, List[int]]:
        """Group one admission round's (model, prompt) pairs by leading
        block: each multi-member group needs its shared block prefilled
        ONCE — the leader computes, the rest CoW-fork — instead of N
        identical prefills racing to publish. Returns key -> indices for
        groups of 2+ (singletons dedup nothing)."""
        groups: Dict[str, List[int]] = {}
        for i, (model, tokens) in enumerate(batch):
            key = self.batch_key(model, tokens)
            if key is not None:
                groups.setdefault(key, []).append(i)
        return {k: v for k, v in groups.items() if len(v) >= 2}

    # ------------------------------------------------------------- eviction
    def _evict_capacity(self) -> None:
        while len(self._entries) > self.capacity_blocks:
            victim = min(self._entries.values(),
                         key=lambda e: (e.last_use, e.seq))
            del self._entries[victim.key]
            self.stats.evicted_blocks += 1

    def drop_replica(self, replica: int) -> None:
        """Forget every block held only by ``replica`` (scale-in): other
        holders keep shared entries alive."""
        dead = []
        for key, e in self._entries.items():
            e.holders.discard(replica)
            if not e.holders:
                dead.append(key)
        for key in dead:
            del self._entries[key]
            self.stats.evicted_blocks += 1
