"""The engine's compiled chunked prefill: CUDA graphs of one chunk of the
paged prefill, keyed by the chunk's shape and the storage a capture bakes
in (the PyTorch/CUDA counterpart of the reference's
``LM.prefill_chunk_paged``, which scans the layer stack with ``lax.scan``:
one compiled executable a chunk shape).

A chunk's graph holds the whole layer loop (``LM.prefill_chunk_stack``):
the embedding, each layer's K/V scatter into the slot's pages,
``paged_prefill_attention``, the FFN or MoE, the last row's logits and
their argmax. What changes against the eager step
(``LM.prefill_chunk_paged``):

* Inputs live in fixed device buffers: the chunk's tokens [S], its start
  [1] (the positions, ``q_start`` and ``ctx_end`` derive from it on the
  device) and the slot's page-table row [N] (from the engine's host mirror
  of the table), copied in before each replay, non-blocking from pinned
  host memory. An event recorded after the copies guards the pinned
  buffers: the next chunk waits for it before it refills them.
* The write cursor ``ctx[slot]`` is set after the replay, in place on the
  tenant's ``ctx`` (the eager step returns a new ``ctx``; the decode step
  reads the cursors from the engine's host mirror either way).
* ``paged_prefill_attention`` encodes its TMA tensor maps on the host at
  each call, so a capture bakes in the pools' addresses: the key holds the
  pools' storage and the parameters'. A ``grow_pool`` misses, and the miss
  drops the graphs whose pools are gone, with their memory.

Chunk lengths vary (a prompt's tail, budget-limited chunks) and are not
padded: the MoE capacity depends on the token count. Each distinct S
captures once, as each shape compiles once in the reference. A tenant's
chunk graphs share one memory pool, so a replay's logits are valid until
the next replay of any of them. The first chunk of a key is the capture's
warm-up: it runs eagerly on the capture stream and is that chunk's
result. A failed capture or replay raises; nothing falls back to the eager
step. The monolithic paged prefill and the dense prefill stay eager, as in
the reference (whose ``_prefill_jit`` is never filled), apart from the
sLSTM time chunks (``models.slstm_graph``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.graphs import GraphStats, add_launches, capture
from repro_torch.models.common import tree_leaves


@dataclasses.dataclass(frozen=True)
class PrefillKey:
    """What one captured chunk bakes in. ``shape``: the chunk length S and
    the page-table width N; ``storage``: the pools' addresses and shape;
    ``params``: every parameter leaf's address."""
    shape: Tuple[int, int]
    storage: Tuple
    params: Tuple[int, ...]

    def live_with(self, current: "PrefillKey") -> bool:
        """Whether a graph of this key still reads live storage when the
        tenant's key is ``current``."""
        return self.storage == current.storage and \
            self.params == current.params


def chunk_logits(lm, params, pool_k, pool_v, pt_row, tokens, start):
    """One prefill chunk from device tensors alone (what a ``ChunkGraph``
    captures): ``tokens`` [S] int64 at positions ``start + arange(S)``
    (``start`` [1] int32) of the sequence whose page-table row is
    ``pt_row`` [N], its K/V scattered into the pools in place. Returns the
    last row's logits [V] and their argmax."""
    x = lm.embed(params, tokens[None, :])                      # [1, S, D]
    s = x.shape[1]
    pos = start + torch.arange(s, dtype=torch.int32, device=x.device)
    logits = lm.prefill_chunk_stack(params, pool_k, pool_v, pt_row, x, pos,
                                    start, start + s)[0]
    return logits, torch.argmax(logits)


def prefill_key(t, s: int) -> PrefillKey:
    """The cache key of a chunk of ``s`` tokens of paged tenant ``t``."""
    st = t.state
    return PrefillKey(
        (s, st["page_table"].shape[1]),
        (st["pool_k"].data_ptr(), st["pool_v"].data_ptr(),
         tuple(st["pool_k"].shape)),
        tuple(a.data_ptr() for a in tree_leaves(t.params)))


class ChunkGraph:
    """One captured prefill chunk of a tenant under one ``PrefillKey``."""

    def __init__(self, t, key: PrefillKey, stream, pool):
        s, n = key.shape
        dev = t.device
        self.key, self.stream, self.pool, self.device = key, stream, pool, dev
        self.graph = torch.cuda.CUDAGraph()
        self.tokens = torch.zeros((s,), dtype=torch.int64, device=dev)
        self.start = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.pt_row = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._host = {name: torch.empty(tuple(buf.shape), dtype=buf.dtype,
                                        pin_memory=True)
                      for name, buf in self._buffers().items()}
        self.copied = torch.cuda.Event()
        # read by address: held for the graph's life (the tenant is passed
        # in where it is needed, never kept)
        self.pools = (t.state["pool_k"], t.state["pool_v"])
        self.name = t.name
        self.logits = self.choice = None
        self.launches: Dict[str, int] = {}
        self.capture_ms = 0.0
        self.pool_bytes = 0

    def _buffers(self) -> Dict[str, torch.Tensor]:
        return {"tokens": self.tokens, "start": self.start,
                "pt_row": self.pt_row}

    def load(self, tokens: np.ndarray, start: int, row: np.ndarray) -> None:
        """Copy a chunk's inputs into the fixed buffers, non-blocking from
        pinned memory, once the previous chunk's copies have read it."""
        self.copied.synchronize()
        for name, value in (("tokens", tokens), ("start", start),
                            ("pt_row", row)):
            self._host[name].numpy()[:] = value
            self._buffers()[name].copy_(self._host[name], non_blocking=True)
        self.copied.record()

    def _body(self, lm, params):
        return chunk_logits(lm, params, *self.pools, self.pt_row,
                            self.tokens, self.start)

    def warm_and_capture(self, t):
        """Run tenant ``t``'s chunk eagerly on the capture stream (the
        warm-up, and this chunk's result), then capture it. Returns the
        warm-up's (logits, argmax)."""
        lm = t.model.impl
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = self._body(lm, t.params)
        cur.wait_stream(self.stream)
        (self.logits, self.choice), self.capture_ms, self.pool_bytes, \
            self.launches = capture(
                self.graph, self.stream, self.device,
                lambda: self._body(lm, t.params),
                f"prefill graph capture failed for tenant {self.name} "
                f"(chunk {self.key.shape})", self.pool)
        return out

    def replay(self):
        """Replay the captured chunk on the current stream. Returns its
        (logits, argmax), valid until the next replay of the cache."""
        try:
            self.graph.replay()
        except Exception as e:
            raise RuntimeError(
                f"prefill graph replay failed for tenant {self.name} "
                f"(chunk {self.key.shape}): {e}") from e
        add_launches(self.launches)
        return self.logits, self.choice


class PrefillGraphs:
    """One paged tenant's chunked-prefill graph cache (the reference's
    compiled ``prefill_chunk_paged``, one executable a chunk shape)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[PrefillKey, ChunkGraph] = {}
        self.stats = GraphStats()

    def _drop_stale(self, key: PrefillKey) -> None:
        """Drop every graph whose pools or parameters are no longer the
        tenant's (a pool growth): their memory goes with them."""
        for k in list(self.graphs):
            if not k.live_with(key):
                self.stats.pool_bytes -= self.graphs.pop(k).pool_bytes
                self.stats.dropped += 1

    @torch.no_grad()
    def chunk(self, t, slot: int, tokens: np.ndarray, start: int):
        """Prefill ``tokens`` of batch row ``slot`` of paged tenant ``t`` at
        positions ``start + arange(S)`` through the chunk's graph,
        capturing it first on a miss, and set ``ctx[slot]`` to ``start +
        S``. Returns (the last row's logits [V], valid until the cache's
        next replay; their argmax, a device scalar)."""
        key = prefill_key(t, len(tokens))
        g = self.graphs.get(key)
        if g is None:
            self._drop_stale(key)
            g = ChunkGraph(t, key, self.stream, self.pool)
            g.load(tokens, start, t.pt_host[slot])
            logits, choice = g.warm_and_capture(t)
            self.graphs[key] = g
            self.stats.captures += 1
            self.stats.capture_ms += g.capture_ms
            self.stats.pool_bytes += g.pool_bytes
        else:
            g.load(tokens, start, t.pt_host[slot])
            logits, choice = g.replay()
            self.stats.replays += 1
        t.state["ctx"][slot] = start + len(tokens)
        return logits, choice
