"""Prefix-aware KV sharing: a token-block radix trie over the paged pool.

Multi-turn and multi-agent workloads resend the same prompt prefix (system
prompt + conversation history) thousands of times; SGLang's RadixAttention
and vLLM's automatic prefix caching deduplicate the KV for those prefixes.
Here the idea composes with MIRAGE's elastic pool: one cached prefix page
serves many requests, so every page the Remapping Controller wins from
parameter memory is multiplied by its share count.

Design (block = ``page_size`` tokens = exactly one allocator page):

  * The trie stores only *full* blocks: a node per block, children keyed by
    the block's token tuple, so `match` is O(L) dict hops for an L-token
    prompt. Partial trailing blocks are never shared — the page a request
    is still writing into is always exclusively owned, which is what makes
    sharing copy-on-write-safe without ever copying (shared pages are
    read-only by construction; new tokens land in fresh pages).
  * Per-node refcounts track how many live requests hold the node in their
    page table (the engine mirrors these as allocator page refcounts).
  * Unreferenced cached blocks are evicted leaf-first in LRU order; parents
    become leaves as their children go. Interior nodes are never evicted
    while a descendant survives — a match must never dangle mid-path.

The index is data-plane agnostic: ``page`` is an opaque int handle (a real
allocator page id in the serving engine, a virtual id in the event-driven
simulator).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: hex chars kept of each chained SHA-256 block digest — 64 bits, plenty
#: for a fleet index that tops out at a few hundred thousand blocks.
HASH_HEX = 16


def block_hash(parent_key: str, block: Sequence[int]) -> str:
    """Chained content hash of one token block: H(parent_key || tokens),
    SHA-truncated. Chaining means a key identifies the *whole* prefix up
    to and including this block, so a single key lookup proves the entire
    prefix matches — the property the fleet cache relies on."""
    h = hashlib.sha256()
    h.update(parent_key.encode())
    h.update(b"|")
    h.update(",".join(str(int(t)) for t in block).encode())
    return h.hexdigest()[:HASH_HEX]


def chain_hashes(tokens: Sequence[int], page_size: int,
                 limit: Optional[int] = None, root_key: str = "") -> List[str]:
    """Chained hashes for every *full* block of ``tokens`` (block i's key
    covers blocks 0..i). ``root_key`` namespaces the chain (the fleet
    cache roots it at the tenant/model name so equal token streams of
    different models never collide)."""
    n = len(tokens)
    if limit is not None:
        n = min(n, max(limit, 0))
    n = (n // page_size) * page_size
    keys: List[str] = []
    key = root_key
    for i in range(0, n, page_size):
        key = block_hash(key, tokens[i:i + page_size])
        keys.append(key)
    return keys


class PrefixNode:
    __slots__ = ("block", "page", "parent", "children", "refs", "last_use",
                 "key", "seq")

    def __init__(self, block: Tuple[int, ...], page: int,
                 parent: Optional["PrefixNode"], key: str = "", seq: int = 0):
        self.block = block
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "PrefixNode"] = {}
        self.refs = 0          # live requests holding this block mapped
        self.last_use = 0
        self.key = key         # chained content hash (fleet-cache identity)
        self.seq = seq         # insertion order — stable LRU tie-break

    def is_leaf(self) -> bool:
        return not self.children


@dataclasses.dataclass
class PrefixMatch:
    """Longest cached prefix for a prompt: ``tokens`` is always a multiple
    of the block size; ``nodes`` is the root-to-deepest matched path."""
    tokens: int
    pages: List[int]
    nodes: List[PrefixNode]


@dataclasses.dataclass
class PrefixStats:
    lookups: int = 0
    hits: int = 0                  # lookups matching >= 1 block
    lookup_tokens: int = 0
    matched_tokens: int = 0        # prefill tokens served from cache
    inserted_blocks: int = 0
    evicted_blocks: int = 0

    @property
    def hit_rate(self) -> float:
        """Fraction of looked-up prompt tokens served from cache."""
        return self.matched_tokens / self.lookup_tokens \
            if self.lookup_tokens else 0.0


class PrefixIndex:
    def __init__(self, page_size: int):
        assert page_size >= 1
        self.page_size = page_size
        self.root = PrefixNode((), -1, None)      # sentinel, never evicted
        self.stats = PrefixStats()
        self._clock = 0
        self._seq = 0
        self._num_blocks = 0

    def __len__(self) -> int:
        return self._num_blocks

    @property
    def num_blocks(self) -> int:
        return self._num_blocks

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _blocks(self, tokens: Sequence[int], limit: Optional[int]
                ) -> List[Tuple[int, ...]]:
        n = len(tokens)
        if limit is not None:
            n = min(n, max(limit, 0))
        n = (n // self.page_size) * self.page_size
        return [tuple(int(t) for t in tokens[i:i + self.page_size])
                for i in range(0, n, self.page_size)]

    # ---------------------------------------------------------------- match
    def match(self, tokens: Sequence[int], max_tokens: Optional[int] = None,
              record: bool = True) -> PrefixMatch:
        """Longest-prefix match in full blocks, capped at ``max_tokens``
        (callers cap at prompt_len-1 so at least one token is always
        recomputed to produce the first logits). ``record=False`` peeks
        without counting a lookup (admission may still fail on capacity;
        the caller records via ``record_lookup`` once it commits)."""
        now = self._tick()
        node = self.root
        pages: List[int] = []
        nodes: List[PrefixNode] = []
        for blk in self._blocks(tokens, max_tokens):
            child = node.children.get(blk)
            if child is None:
                break
            child.last_use = now
            pages.append(child.page)
            nodes.append(child)
            node = child
        matched = len(pages) * self.page_size
        if record:
            self.record_lookup(matched, len(tokens))
        return PrefixMatch(matched, pages, nodes)

    def peek(self, tokens: Sequence[int],
             max_tokens: Optional[int] = None) -> int:
        """Longest-prefix match length in tokens, WITHOUT mutating any
        index state — no clock tick, no ``last_use`` refresh, no stats.
        Fleet probes use this: a remote replica asking "do you still hold
        this span?" must not perturb the local LRU order, or a 1-replica
        fleet-cache run would stop being byte-identical to the bare
        runtime."""
        node = self.root
        matched = 0
        for blk in self._blocks(tokens, max_tokens):
            child = node.children.get(blk)
            if child is None:
                break
            matched += self.page_size
            node = child
        return matched

    def record_lookup(self, matched_tokens: int, lookup_tokens: int) -> None:
        self.stats.lookups += 1
        self.stats.lookup_tokens += lookup_tokens
        self.stats.matched_tokens += matched_tokens
        if matched_tokens:
            self.stats.hits += 1

    # ------------------------------------------------------------ refcounts
    def acquire(self, nodes: Sequence[PrefixNode]) -> None:
        for nd in nodes:
            nd.refs += 1

    def release(self, nodes: Sequence[PrefixNode]) -> None:
        for nd in nodes:
            assert nd.refs > 0, "release without matching acquire"
            nd.refs -= 1

    # ---------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               max_tokens: Optional[int] = None
               ) -> Tuple[List[int], List[PrefixNode]]:
        """Publish the full blocks of ``tokens`` whose KV lives in ``pages``
        (pages[i] holds block i). Blocks already cached keep their existing
        page (the caller's duplicate page simply stays private to it).

        Returns (newly cached page ids, full root-to-end path). The caller
        owns taking a cache reference on the new pages (engine: allocator
        ``cache_hold``) and request references on the path (``acquire``).
        """
        now = self._tick()
        node = self.root
        new_pages: List[int] = []
        path: List[PrefixNode] = []
        for i, blk in enumerate(self._blocks(tokens, max_tokens)):
            assert i < len(pages), "fewer pages than full token blocks"
            child = node.children.get(blk)
            if child is None:
                self._seq += 1
                child = PrefixNode(blk, int(pages[i]), node,
                                   key=block_hash(node.key, blk),
                                   seq=self._seq)
                node.children[blk] = child
                self._num_blocks += 1
                self.stats.inserted_blocks += 1
                new_pages.append(child.page)
            child.last_use = now
            path.append(child)
            node = child
        return new_pages, path

    # ---------------------------------------------------------------- evict
    def _evictable_leaves(self, evictable: Optional[Callable[[int], bool]]
                          ) -> List[PrefixNode]:
        out: List[PrefixNode] = []
        stack = list(self.root.children.values())
        while stack:
            nd = stack.pop()
            if nd.is_leaf():
                if nd.refs == 0 and (evictable is None or evictable(nd.page)):
                    out.append(nd)
            else:
                stack.extend(nd.children.values())
        return out

    def evict(self, max_blocks: int,
              evictable: Optional[Callable[[int], bool]] = None) -> List[int]:
        """Drop up to ``max_blocks`` unreferenced cached blocks, leaf-first
        in LRU order, returning their page ids (the caller returns them to
        the allocator's free list). ``evictable`` lets the engine veto pages
        the allocator still sees referenced.

        LRU ties break by insertion order (``seq``), never by trie
        iteration order, so two identically-driven indices evict the same
        pages in the same order."""
        freed: List[int] = []
        while len(freed) < max_blocks:
            leaves = self._evictable_leaves(evictable)
            if not leaves:
                break
            leaves.sort(key=lambda nd: (nd.last_use, nd.seq))
            for nd in leaves:
                if len(freed) >= max_blocks:
                    break
                del nd.parent.children[nd.block]
                self._num_blocks -= 1
                self.stats.evicted_blocks += 1
                freed.append(nd.page)
        return freed

    def evict_pages(self, pages: Sequence[int],
                    evictable: Optional[Callable[[int], bool]] = None
                    ) -> List[int]:
        """Targeted eviction (e.g. cached pages sitting in a segment the
        controller wants to revert): drops any currently evictable leaf
        whose page is in ``pages``; interior blocks stay until their
        descendants go (callers retry on later iterations)."""
        want = set(int(p) for p in pages)
        freed: List[int] = []
        progress = True
        while progress:
            progress = False
            for nd in self._evictable_leaves(evictable):
                if nd.page in want:
                    del nd.parent.children[nd.block]
                    self._num_blocks -= 1
                    self.stats.evicted_blocks += 1
                    freed.append(nd.page)
                    progress = True
        return freed

    # ------------------------------------------------------------ snapshot
    def paths(self, max_blocks: Optional[int] = None
              ) -> List[Tuple[int, ...]]:
        """Token streams of every *maximal* cached prefix (root-to-leaf
        paths), non-mutating — no clock tick, no ``last_use`` refresh, no
        stats. Deterministic order: paths sorted by the leaf's insertion
        ``seq``, so two identically-driven indices snapshot identically.
        ``max_blocks`` bounds the total blocks across returned paths (a
        pre-warm transfer budget); a path that would overflow it is
        skipped, not truncated mid-chain."""
        leaves: List[Tuple[int, PrefixNode]] = []
        stack = list(self.root.children.values())
        while stack:
            nd = stack.pop()
            if nd.is_leaf():
                leaves.append((nd.seq, nd))
            else:
                stack.extend(nd.children.values())
        leaves.sort()
        out: List[Tuple[int, ...]] = []
        budget = math.inf if max_blocks is None else max(max_blocks, 0)
        for _seq, leaf in leaves:
            blocks: List[Tuple[int, ...]] = []
            nd = leaf
            while nd is not self.root:
                blocks.append(nd.block)
                nd = nd.parent
            if len(blocks) > budget:
                continue
            budget -= len(blocks)
            out.append(tuple(t for blk in reversed(blocks) for t in blk))
        return out

    # ------------------------------------------------------------- integrity
    def check_invariants(self) -> None:
        seen_pages = set()
        count = 0
        stack = [(self.root, 0)]
        while stack:
            nd, depth = stack.pop()
            if nd is not self.root:
                count += 1
                assert len(nd.block) == self.page_size
                assert nd.refs >= 0
                assert nd.page not in seen_pages, "page cached twice"
                seen_pages.add(nd.page)
                assert nd.parent.children[nd.block] is nd
            for c in nd.children.values():
                stack.append((c, depth + 1))
        assert count == self._num_blocks, (count, self._num_blocks)
