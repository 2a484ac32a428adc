"""Paged KV allocator with elastic segments (paper §6, vAttention-adapted)
and refcounted copy-on-write pages for prefix sharing.

The pool is a set of *segments* of pages. Segment 0 is the static KV
reservation; further segments are backed by device memory donated by
remapped parameters (the JAX analogue of vAttention's physical-page
remapping: at a tier switch the evicted parameter stack is donated and a
KV segment of the same size allocated — the runtime allocator reuses the
freed HBM; page tables span segments so compiled attention sees one pool).

Page lifecycle: a page is either *free* (on the free list) or *live* with
a refcount ≥ 1. References come from sequences mapping the page
(``allocate`` / ``fork``) and from the prefix cache (``cache_hold``).
Copy-on-write discipline: forked (shared) pages are only ever the fully
written prompt-prefix pages, and writers always append into freshly
allocated pages — so "copy"-on-write never actually copies; shared pages
are read-only by construction.

Invariants (property-tested):
  * free + live == total across all segments, every live refcount ≥ 1;
  * a page's refcount equals the number of sequences mapping it plus one
    if the prefix cache holds it;
  * segments only shrink when none of their pages are live.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


@dataclasses.dataclass
class Segment:
    start: int            # first global page id
    num_pages: int
    source: str           # "static" | model name that donated the memory

    @property
    def end(self) -> int:
        return self.start + self.num_pages


class PagedKVAllocator:
    def __init__(self, base_pages: int, page_size: int):
        self.page_size = page_size
        self.segments: List[Segment] = [Segment(0, base_pages, "static")]
        self._next_start = base_pages
        self.free_list: List[int] = list(range(base_pages))
        self.refs: Dict[int, int] = {}                  # page -> refcount
        self.cached: Set[int] = set()                   # cache holds one ref
        self.seq_pages: Dict[str, List[int]] = {}       # request id -> pages
        self.seq_tokens: Dict[str, int] = {}
        self.seq_shared: Dict[str, int] = {}            # leading CoW pages

    # ------------------------------------------------------------- capacity
    @property
    def total_pages(self) -> int:
        return sum(s.num_pages for s in self.segments)

    @property
    def used_pages(self) -> int:
        return len(self.refs)

    @property
    def free_pages(self) -> int:
        return len(self.free_list)

    @property
    def cached_pages(self) -> int:
        return len(self.cached)

    def grow(self, num_pages: int, source: str) -> Segment:
        seg = Segment(self._next_start, num_pages, source)
        self._next_start += num_pages
        self.segments.append(seg)
        self.free_list.extend(range(seg.start, seg.end))
        return seg

    @property
    def page_id_bound(self) -> int:
        """Exclusive upper bound on every page id ever minted. Pool arrays
        must be sized by THIS, not ``total_pages``: ids are monotonic
        (freed segment ranges are never reissued), so after any shrink the
        live id range exceeds the live page count."""
        return self._next_start

    def segment_in_use(self, seg: Segment) -> bool:
        return any(seg.start <= p < seg.end for p in self.refs)

    def releasable_pages(self, source: str) -> int:
        """Pages ``shrink(source)`` would release right now (segments
        donated by ``source`` with no live page). Checked BEFORE shrinking
        so a doomed reversion can be undone without freeing and re-minting
        segments (which would leak page ids past the tenants' pools)."""
        return sum(seg.num_pages for seg in self.segments
                   if seg.source == source and not self.segment_in_use(seg))

    def segment_cached(self, seg: Segment) -> List[int]:
        """Cached (refcount held only by the prefix cache) pages inside
        ``seg`` — eviction candidates when the segment must be reverted."""
        return [p for p in self.cached
                if seg.start <= p < seg.end and self.refs.get(p) == 1]

    def shrink(self, source: str) -> int:
        """Release all unused segments donated by ``source``; returns pages
        released. Segments with live pages are kept (caller retries later)."""
        released = 0
        keep = []
        for seg in self.segments:
            if seg.source == source and not self.segment_in_use(seg):
                released += seg.num_pages
                live = set(range(seg.start, seg.end))
                self.free_list = [p for p in self.free_list if p not in live]
            else:
                keep.append(seg)
        self.segments = keep
        return released

    # ------------------------------------------------------------ allocation
    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

    def can_allocate(self, num_tokens: int) -> bool:
        return self.pages_needed(num_tokens) <= self.free_pages

    def allocate(self, rid: str, num_tokens: int) -> Optional[List[int]]:
        """Allocate pages for ``num_tokens`` NEW tokens of request rid."""
        have = self.seq_tokens.get(rid, 0)
        cur_pages = len(self.seq_pages.get(rid, []))
        need = self.pages_needed(have + num_tokens) - cur_pages
        if need > len(self.free_list):
            return None
        pages = [self.free_list.pop() for _ in range(need)]
        for p in pages:
            self.refs[p] = 1
        self.seq_pages.setdefault(rid, []).extend(pages)
        self.seq_tokens[rid] = have + num_tokens
        return self.seq_pages[rid]

    def fork(self, rid: str, pages: Sequence[int], num_tokens: int) -> None:
        """Copy-on-write map of a cached prefix into a fresh request:
        ``pages`` (full prompt-prefix pages holding ``num_tokens`` tokens)
        are shared read-only; subsequent ``allocate`` calls append the
        request's private suffix pages after them."""
        assert rid not in self.seq_pages, f"fork into live request {rid}"
        assert num_tokens == len(pages) * self.page_size, \
            "only fully written pages are shareable"
        for p in pages:
            assert p in self.refs, f"fork of non-live page {p}"
            self.refs[p] += 1
        self.seq_pages[rid] = list(pages)
        self.seq_tokens[rid] = num_tokens
        self.seq_shared[rid] = len(pages)

    def _unref(self, p: int) -> bool:
        """Drop one reference; returns True when the page became free."""
        self.refs[p] -= 1
        if self.refs[p] == 0:
            del self.refs[p]
            self.free_list.append(p)
            return True
        return False

    def free(self, rid: str) -> int:
        """Release a request's references. Pages shared with other requests
        or retained by the prefix cache stay live; returns pages actually
        returned to the free list."""
        pages = self.seq_pages.pop(rid, [])
        self.seq_tokens.pop(rid, None)
        self.seq_shared.pop(rid, None)
        return sum(1 for p in pages if self._unref(p))

    # --------------------------------------------------------- prefix cache
    def cache_hold(self, pages: Sequence[int]) -> None:
        """The prefix cache takes one reference per page: the page then
        survives its owners finishing, as a refcount-1 cached block."""
        for p in pages:
            assert p in self.refs, f"cache_hold of non-live page {p}"
            assert p not in self.cached, f"page {p} already cached"
            self.refs[p] += 1
            self.cached.add(p)

    def cache_drop(self, pages: Sequence[int]) -> int:
        """Prefix-cache eviction: drop the cache's reference; pages nobody
        else maps return to the free list (the low-pressure free-page
        source tried before the remapping controller escalates)."""
        freed = 0
        for p in pages:
            assert p in self.cached, f"cache_drop of uncached page {p}"
            self.cached.discard(p)
            freed += self._unref(p)
        return freed

    # ------------------------------------------------------------ page table
    def page_table(self, rids: List[str], max_pages: int) -> np.ndarray:
        """[len(rids), max_pages] int32, padded with page 0 (masked by
        context_lens in the attention kernel)."""
        out = np.zeros((len(rids), max_pages), np.int32)
        for i, rid in enumerate(rids):
            pages = self.seq_pages.get(rid, [])
            out[i, :len(pages)] = pages
        return out

    def context_lens(self, rids: List[str]) -> np.ndarray:
        return np.array([self.seq_tokens.get(r, 0) for r in rids], np.int32)

    def check_invariants(self) -> None:
        total = self.total_pages
        assert len(self.free_list) + len(self.refs) == total, \
            (len(self.free_list), len(self.refs), total)
        assert len(set(self.free_list)) == len(self.free_list)
        assert not (set(self.free_list) & set(self.refs))
        live = {p for s in self.segments for p in range(s.start, s.end)}
        assert set(self.refs).issubset(live)
        assert set(self.free_list).issubset(live)
        assert self.cached.issubset(set(self.refs))
        # refcount == #mapping sequences + cache hold
        expect: Dict[int, int] = {p: 1 for p in self.cached}
        for pages in self.seq_pages.values():
            for p in pages:
                expect[p] = expect.get(p, 0) + 1
        assert expect == self.refs, "refcounts out of sync"
        # CoW: shared prefix pages precede private pages and stay full
        for rid, shared in self.seq_shared.items():
            assert shared <= len(self.seq_pages.get(rid, []))


class ShardedPagedKVAllocator(PagedKVAllocator):
    """One LOGICAL page space shared by the ``shards`` devices of a
    model-parallel set.

    Under SERVING_RULES the KV heads are striped over the "model" axis, so
    every shard holds the same token pages for its own head slice: page ids,
    refcounts, segments and the free list are *logical* (one bookkeeping
    instance, inherited unchanged), while each physical page is
    ``1/shards``-th the logical page's bytes on every device. Allocation
    and eviction therefore stay single-decision — a page is resident on ALL
    shards or on none, the KV analogue of the lock-step drain invariant —
    and ``shard_page_tables`` materializes the per-device tables, identical
    along the shard axis by construction (asserted in tests).

    ``shards=1`` is behaviorally identical to ``PagedKVAllocator``.
    """

    def __init__(self, base_pages: int, page_size: int, *, shards: int = 1,
                 logical_page_bytes: int = 0):
        super().__init__(base_pages, page_size)
        self.shards = max(int(shards), 1)
        self.logical_page_bytes = logical_page_bytes

    @property
    def shard_page_bytes(self) -> int:
        """Physical bytes one device commits per logical page."""
        return self.logical_page_bytes // self.shards

    def shard_page_tables(self, rids: List[str], max_pages: int) -> np.ndarray:
        """[shards, len(rids), max_pages] int32 — one table per device.
        Rows are identical along axis 0: the cross-shard symmetry
        invariant that makes a single routing/eviction decision valid for
        the whole set."""
        table = self.page_table(rids, max_pages)
        return np.broadcast_to(table, (self.shards,) + table.shape).copy()

    def check_invariants(self) -> None:
        super().check_invariants()
        if self.seq_pages:
            rids = list(self.seq_pages)
            mp = max(len(p) for p in self.seq_pages.values())
            stacked = self.shard_page_tables(rids, mp)
            for s in range(1, self.shards):
                assert (stacked[s] == stacked[0]).all(), \
                    "per-shard page tables diverged"
