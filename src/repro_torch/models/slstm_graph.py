"""The sLSTM time loop's compiled chunk: ``ck`` steps of the cell captured
once as a CUDA graph and replayed over the sequence (the PyTorch/CUDA
counterpart of the reference's ``jax.lax.scan`` over time chunks in the
sLSTM block's ``fwd_seq``, one compiled XLA loop).

Run eagerly, each step of the cell is ~14 small kernels a token and a
layer, so the host's launches bound a prefill. Here a chunk runs on fixed
buffers:

* ``wx`` [B, ck, 4, H, hd], the chunk's pre-activations, copied in before
  each replay;
* the carry ``c``, ``n``, ``h`` [B, H, hd]: the captured body writes the
  new carry back into them, so each replay continues from the one before
  (zeroed at the start of a layer);
* ``hs`` [B, ck, H, hd], the chunk's outputs, copied out after it;
* ``r`` and ``b``, the layer's recurrent weights and bias, copied in at the
  start of each layer (one pair of buffers for all of a cache's graphs).

The key is (B, ck, H, hd, the dtypes, the device). Copying ``r`` and ``b``
(16.8 MB a layer for xlstm-1.3b) lets one graph serve every sLSTM layer of
a stack and keeps the graph free of weights; keying by each layer's
storage instead would capture one graph a layer and hold each layer's
weights as long as its graph. A cache's graphs share one memory pool.

The first chunk of a key is the warm-up: it runs eagerly on the capture
stream and is that chunk's result; then the key is captured, and every
later chunk replays. A failed capture or replay raises; nothing falls back
to the eager loop. ``SLSTM.fwd_seq`` routes here only where
``kernels.graphs.replayable`` holds; every other call runs its eager loop.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels.graphs import GraphStats, capture


class _ChunkGraph:
    """One captured chunk of ``ck`` sLSTM steps on its fixed buffers."""

    def __init__(self, wx: torch.Tensor, w, ck: int, stream, pool):
        b, _, g, h, hd = wx.shape
        dev = wx.device
        self.stream, self.pool, self.device = stream, pool, dev
        self.wx = torch.empty((b, ck, g, h, hd), dtype=wx.dtype, device=dev)
        self.c, self.n, self.h = (
            torch.zeros((b, h, hd), dtype=torch.float32, device=dev)
            for _ in range(3))
        self.hs = torch.empty((b, ck, h, hd), dtype=torch.float32,
                              device=dev)
        self.w = w                                   # {"r", "b"} buffers
        self.graph = None
        self.capture_ms = 0.0
        self.pool_bytes = 0

    def _body(self, cell: Callable) -> None:
        """``ck`` steps of ``cell`` from the carry buffers; each step's h
        into ``hs``, the last step's carry back into the buffers."""
        st = {"c": self.c, "n": self.n, "h": self.h}
        for i in range(self.wx.shape[1]):
            st = cell(self.w, self.wx[:, i], st)
            self.hs[:, i].copy_(st["h"])
        for name in ("c", "n", "h"):
            getattr(self, name).copy_(st[name])

    def warm_and_capture(self, cell: Callable, key) -> None:
        """Run the chunk eagerly on the capture stream (the warm-up, and
        this chunk's result), then capture it."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            self._body(cell)
        cur.wait_stream(self.stream)
        self.graph = torch.cuda.CUDAGraph()
        _, self.capture_ms, self.pool_bytes, _ = capture(
            self.graph, self.stream, self.device, lambda: self._body(cell),
            f"sLSTM chunk graph capture failed (key {key})", self.pool)

    def replay(self, key) -> None:
        try:
            self.graph.replay()
        except Exception as e:
            raise RuntimeError(f"sLSTM chunk graph replay failed (key {key}):"
                               f" {e}") from e


class SLSTMGraphs:
    """One owner's captured sLSTM chunks (``Model.slstm_graphs``; a serving
    tenant's model owns its own). It holds no reference to its owner or to
    any weights."""

    def __init__(self):
        self.graphs: Dict[Tuple, _ChunkGraph] = {}
        self.stats = GraphStats()
        self._streams: Dict[torch.device, Tuple] = {}   # (stream, pool)
        # the r and b buffers the graphs read, by device, shapes and dtypes
        self._weights: Dict[Tuple, Dict[str, torch.Tensor]] = {}

    def _graph(self, wx: torch.Tensor, w, ck: int) -> _ChunkGraph:
        """A new chunk graph for ``wx``'s shape reading the weight buffers
        ``w``, on the capture stream and in the memory pool of the cache
        for ``wx``'s device."""
        if wx.device not in self._streams:
            self._streams[wx.device] = (torch.cuda.Stream(wx.device),
                                        torch.cuda.graph_pool_handle())
        return _ChunkGraph(wx, w, ck, *self._streams[wx.device])

    def run(self, cell: Callable, p, wx: torch.Tensor, ck: int):
        """The recurrence of ``cell`` (``SLSTM._cell``) with the layer's
        ``p["r"]``, ``p["b"]`` over ``wx`` [B, T, 4, H, hd] from a zero
        carry, ``ck`` steps a replay (``ck`` divides T). Returns ((c, n,
        h), the final carry; hs [B, T, H, hd] f32, every step's h)."""
        b, t = wx.shape[:2]
        key = (b, ck) + tuple(wx.shape[3:]) + (wx.dtype, p["r"].dtype,
                                               wx.device)
        g = self.graphs.get(key)
        if g is None:
            wkey = (wx.device,) + tuple((tuple(p[n].shape), p[n].dtype)
                                        for n in ("r", "b"))
            if wkey not in self._weights:
                self._weights[wkey] = {n: torch.empty_like(p[n])
                                       for n in ("r", "b")}
            g = self._graph(wx, self._weights[wkey], ck)
        for name in ("r", "b"):
            g.w[name].copy_(p[name])
        for buf in (g.c, g.n, g.h):
            buf.zero_()
        hs = torch.empty((b, t) + tuple(g.hs.shape[2:]), dtype=g.hs.dtype,
                         device=wx.device)
        for c0 in range(0, t, ck):
            g.wx.copy_(wx[:, c0:c0 + ck])
            if key in self.graphs:
                g.replay(key)
                self.stats.replays += 1
            else:
                g.warm_and_capture(cell, key)
                self.graphs[key] = g
                self.stats.captures += 1
                self.stats.capture_ms += g.capture_ms
                self.stats.pool_bytes += g.pool_bytes
            hs[:, c0:c0 + ck].copy_(g.hs)
        return (g.c.clone(), g.n.clone(), g.h.clone()), hs
