"""The engine's compiled decode step: CUDA graphs keyed by the remap plan
(the PyTorch/CUDA counterpart of the reference engine's ``_decode_fn`` jit
cache, ``Tenant._decode_jit`` in ``repro.serving.engine``).

The reference jits one decode step per (resident layers, cycle layers,
paged) and replays that executable every step; the stacks and index maps
are jit arguments, and XLA overlaps the cycling layers' host-to-device
copies with compute inside the executable. Here a tenant's step is
captured once as a CUDA graph and replayed. A graph bakes in what a jit
argument leaves free, so its key (``decode_key``) also holds the batch and
page-table width, the storage of the pools (paged) or of every decode-state
leaf (dense), the storage of the resident and cycle stacks, the plan's
index maps and β. A pool growth or a tier switch therefore misses; a
tenant's graphs whose storage is gone are dropped with their memory pools.

What changes under a graph, against the eager step:

* Inputs live in fixed device buffers. Tokens, page table and write
  cursors are copied in before each replay, non-blocking from pinned host
  memory (the engine keeps host mirrors of the table and the cursors).
* Outputs are the graph's own: the argmax runs inside it, so a step reads
  back B token ids and nothing else; the new cursors (paged) or ``pos``
  (dense) are copied into the fixed state inside the graph, so the state
  the engine keeps across steps is the graph's own buffers.
* A remapped step's ``StreamingFetch`` is built once per key. Its copy
  stream, events and β slot buffers live with the graph: under capture its
  ``freed`` / ``done`` events are the fork and join of the copy stream,
  and its copies read the pinned cycle stack by address (the graph holds
  the stack). The bytes it copies are counted at capture and added to the
  transfer engine's ``host_fetch_bytes`` at every replay.
* The kernels' launch counters are Python increments in their wrappers,
  so they run only at capture: each graph records its launches and adds
  them at every replay.

A key's first step is the capture's warm-up: it runs eagerly, on the
capture stream, and is that step's result (the kernels' first-use build,
their shared-memory attributes and the library handles of that stream are
set up there, outside the capture). Every later step with the key replays.
A capture or a replay that fails raises; nothing falls back to the eager
step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.transfer_engine import StreamingFetch, make_fetch
from repro_torch.kernels.graphs import GraphStats, add_launches, capture
from repro_torch.models.common import tree_leaves


def decode_fn(t, state, tokens, fetch=None):
    """One decode step of tenant ``t`` on ``state``: against its paged pool,
    or against its dense decode state (both updated in place; the new write
    cursors or ``pos`` come back in the returned state)."""
    if t.paged:
        return t.model.impl.decode_step_paged(t.params, state, tokens,
                                              fetch=fetch)
    return t.model.decode_step(t.params, state, tokens, t.max_context,
                               fetch=fetch)


def _ptrs(tree) -> Tuple[int, ...]:
    return tuple(a.data_ptr() for a in tree_leaves(tree))


@dataclasses.dataclass(frozen=True)
class DecodeKey:
    """What one captured step bakes in. ``shape``: the reference's key
    (resident repeats, cycle repeats, paged) and the batch and page-table
    width; ``storage``: the pools' (paged) or every dense state leaf's
    addresses; ``stacks``: a remapped step's resident and cycle stacks'
    addresses, its index maps and β (None when no repeat cycles)."""
    shape: Tuple
    storage: Tuple
    stacks: Optional[Tuple]

    def live_with(self, current: "DecodeKey") -> bool:
        """Whether a graph of this key still reads live storage when the
        tenant's key is ``current``: its pools or state are the tenant's,
        and its stacks (where it streams) the transfer engine's split."""
        return self.storage == current.storage and (
            self.stacks is None or self.stacks == current.stacks)


def decode_key(t, plan, split) -> DecodeKey:
    """The cache key of tenant ``t``'s decode step under ``plan`` with the
    transfer engine's current ``split`` (resident, cycle, maps)."""
    remapped = plan.m > 0
    if t.paged:
        st = t.state
        storage = (st["pool_k"].data_ptr(), st["pool_v"].data_ptr(),
                   tuple(st["pool_k"].shape))
        width = st["page_table"].shape[1]
    else:
        storage = _ptrs(t.state)
        width = 0
    stacks = None
    if remapped:
        resident, cycle, maps = split
        stacks = (_ptrs(resident), _ptrs(cycle),
                  maps["is_resident"].tobytes(),
                  maps["idx_in_stack"].tobytes(), max(plan.beta, 1))
    shape = (len(plan.resident_layers) if remapped else t.model.repeats,
             len(plan.cycle_layers) if remapped else 0, t.paged,
             t.max_batch, width)
    return DecodeKey(shape, storage, stacks)


class DecodeGraph:
    """One captured decode step of a tenant under one ``DecodeKey``."""

    def __init__(self, t, key: DecodeKey, plan, split, stream):
        dev = t.device
        self.key = key
        self.stream = stream
        self.graph = torch.cuda.CUDAGraph()
        b = t.max_batch
        self.tokens = torch.zeros((b,), dtype=torch.int32, device=dev)
        self._tokens_host = torch.empty((b,), dtype=torch.int32,
                                        pin_memory=True)
        if t.paged:
            n = t.state["page_table"].shape[1]
            self.page_table = torch.empty((b, n), dtype=torch.int32,
                                          device=dev)
            self.ctx = torch.empty((b,), dtype=torch.int32, device=dev)
            self._pt_host = torch.empty((b, n), dtype=torch.int32,
                                        pin_memory=True)
            self._ctx_host = torch.empty((b,), dtype=torch.int32,
                                         pin_memory=True)
            # the pools by address; cursors and table are the graph's own
            self.state = {"pool_k": t.state["pool_k"],
                          "pool_v": t.state["pool_v"],
                          "page_table": self.page_table, "ctx": self.ctx}
        else:
            self.state = t.state
        # held for the graph's life: it reads the stacks by address
        self.split = split if plan.m > 0 else None
        self.fetch = None
        if self.split is not None:
            resident, cycle, maps = split
            self.fetch = make_fetch(resident, cycle, maps,
                                    slots=max(plan.beta, 1))
        # the tenant is passed in where it is needed, never kept: a graph
        # that held it would put its engine in a reference cycle, whose
        # pools and weights then outlive it until the collector runs
        self.name, self.device = t.name, dev
        self.logits: Optional[torch.Tensor] = None
        self.choices: Optional[torch.Tensor] = None
        self.h2d_bytes = 0
        self.launches: Dict[str, int] = {}
        self.pool_bytes = 0
        self.capture_ms = 0.0

    # ------------------------------------------------------------- inputs
    def load(self, tokens: np.ndarray, page_table: Optional[np.ndarray],
             ctx: Optional[np.ndarray]) -> None:
        """Copy a step's inputs into the fixed buffers (non-blocking from
        pinned memory; the previous step's read-back has waited for the
        previous copies, so the pinned buffers are free to refill)."""
        self._tokens_host.numpy()[:] = tokens
        self.tokens.copy_(self._tokens_host, non_blocking=True)
        if page_table is not None:
            self._pt_host.numpy()[:] = page_table
            self._ctx_host.numpy()[:] = ctx
            self.page_table.copy_(self._pt_host, non_blocking=True)
            self.ctx.copy_(self._ctx_host, non_blocking=True)

    # --------------------------------------------------------------- step
    def _body(self, t):
        """Tenant ``t``'s step on the fixed buffers; the new cursors / ``pos``
        go back into the fixed state, the argmax comes out beside the
        logits."""
        if isinstance(self.fetch, StreamingFetch):
            self.fetch.reset()
        logits, out = decode_fn(t, self.state, self.tokens, self.fetch)
        for dst, src in zip(tree_leaves(self.state), tree_leaves(out)):
            if dst is not src:
                dst.copy_(src)
        return logits, torch.argmax(logits, dim=-1)

    def warm_and_capture(self, t):
        """Run tenant ``t``'s step eagerly on the capture stream (the
        warm-up, and this step's result), then capture it. Returns (logits,
        choices on the host, host-to-device bytes the warm-up copied)."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            logits, choices = self._body(t)
        cur.wait_stream(self.stream)
        warm_bytes = getattr(self.fetch, "h2d_bytes", 0)
        out = choices.cpu().numpy()
        (self.logits, self.choices), self.capture_ms, self.pool_bytes, \
            self.launches = capture(
                self.graph, self.stream, self.device, lambda: self._body(t),
                f"decode graph capture failed for tenant {self.name} "
                f"(key {self.key.shape})")
        self.h2d_bytes = getattr(self.fetch, "h2d_bytes", 0)
        return logits, out, warm_bytes

    def replay(self):
        """Replay the captured step on the current stream. Returns (logits,
        valid until the next replay; choices on the host)."""
        try:
            self.graph.replay()
            out = self.choices.cpu().numpy()
        except Exception as e:
            raise RuntimeError(
                f"decode graph replay failed for tenant {self.name} "
                f"(key {self.key.shape}): {e}") from e
        add_launches(self.launches)
        return self.logits, out


class DecodeGraphs:
    """One tenant's decode-graph cache (the reference's ``_decode_jit``)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.graphs: Dict[DecodeKey, DecodeGraph] = {}
        self.stats = GraphStats()

    def _drop_stale(self, key: DecodeKey) -> None:
        """Drop every graph whose pools, state or stacks are no longer the
        tenant's (a pool growth, a tier switch): their memory pools go with
        them. A graph without cycling repeats stays while its storage
        does (a reverted tenant replays it again)."""
        for k in list(self.graphs):
            if not k.live_with(key):
                self.stats.pool_bytes -= self.graphs.pop(k).pool_bytes
                self.stats.dropped += 1

    def step(self, t, plan, split, tokens: np.ndarray,
             page_table: Optional[np.ndarray], ctx: Optional[np.ndarray]):
        """Decode one step of ``t`` through its graph for the current plan
        and split, capturing it first on a miss. Returns (logits, choices
        on the host, host-to-device bytes the step copied)."""
        key = decode_key(t, plan, split)
        g = self.graphs.get(key)
        if g is None:
            self._drop_stale(key)
            g = DecodeGraph(t, key, plan, split, self.stream)
            g.load(tokens, page_table, ctx)
            logits, choices, h2d = g.warm_and_capture(t)
            self.graphs[key] = g
            self.stats.captures += 1
            self.stats.capture_ms += g.capture_ms
            self.stats.pool_bytes += g.pool_bytes
        else:
            g.load(tokens, page_table, ctx)
            logits, choices = g.replay()
            h2d = g.h2d_bytes
            self.stats.replays += 1
        if t.paged:
            t.state = dict(t.state, page_table=g.page_table, ctx=g.ctx)
        return logits, choices, h2d
