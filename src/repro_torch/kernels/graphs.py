"""Capturing a step that launches the kernels as one CUDA graph: the
bookkeeping that the compiled decode step (``serving.decode_graph``), the
compiled prefill (``serving.prefill_graph``, ``models.slstm_graph``) and the
compiled training step (``training.train_graph``) share.

The kernels' launch counters are Python increments in their wrappers, so
they run only while a step is captured: a capture records each kernel's
launches and rolls the counters back (the capture launched nothing), and
every replay adds them. A CUDA graph that the garbage collector destroys
mid-capture (one held in a reference cycle) frees its pool there, which
invalidates the capture: the capture collects first and pauses the
collector while it runs. A capture that fails raises.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import WRAPPERS, launch_counts


@dataclasses.dataclass
class GraphStats:
    captures: int = 0
    replays: int = 0
    dropped: int = 0
    capture_ms: float = 0.0
    pool_bytes: int = 0         # reserved by the live graphs' captures


def replayable(x: torch.Tensor, mesh=None) -> bool:
    """Whether work on ``x`` may replay a captured graph: ``x`` lies on a
    CUDA device, no mesh is in play (the gloo collectives cannot be
    captured), autograd is off (a replay records no backward) and no
    capture is running on the current stream (the compiled training step
    captures the whole forward). Everything else runs eagerly."""
    return (x.is_cuda and mesh is None and not torch.is_grad_enabled()
            and not torch.cuda.is_current_stream_capturing())


def capture(graph: torch.cuda.CUDAGraph, stream, device, body: Callable,
            what: str, pool: Optional[Tuple[int, int]] = None
            ) -> Tuple[object, float, int, Dict[str, int]]:
    """Capture ``body()`` into ``graph`` on ``stream`` (into the memory
    pool ``pool`` that other graphs of one cache share, where given).
    Returns (what ``body`` returned: the graph's outputs, capture ms, the
    bytes its capture added to the reserved memory, the kernels' launches
    by name). A failure raises ``RuntimeError`` with ``what`` before the
    cause."""
    before = launch_counts()
    t0 = time.perf_counter()
    gc.collect()
    # the capture empties the allocator's cache first; empty it here so
    # the reserved bytes' growth is the graph's pool alone
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            out = body()
    except Exception as e:
        raise RuntimeError(f"{what}: {e}") from e
    finally:
        if collecting:
            gc.enable()
        after = launch_counts()
        for name, w in WRAPPERS.items():   # the capture launched nothing
            w.launches = before[name]
    ms = (time.perf_counter() - t0) * 1e3
    pool = torch.cuda.memory_reserved(device) - reserved
    return out, ms, pool, {n: after[n] - before[n] for n in before
                           if after[n] != before[n]}


def add_launches(launches: Dict[str, int]) -> None:
    """Count one replay of a graph that recorded ``launches``."""
    for name, n in launches.items():
        WRAPPERS[name].launches += n
