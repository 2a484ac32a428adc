"""The compiled training step: a whole train step captured as one CUDA
graph and replayed (the PyTorch/CUDA counterpart of the reference
launcher's ``jax.jit(make_train_step(...))`` in ``repro.launch.train``).

The reference jits the step once per argument shape and runs that
executable every step; the parameters and the optimizer state are its
arguments and results. A CUDA graph bakes in addresses instead, so the key
of a captured step (``TrainKey``) holds the storage of every parameter and
optimizer-state leaf (address, shape, dtype), the batch's names, shapes
and dtypes, and the step's microbatch count and remat policy. The port's
optimizers update in place, so successive steps keep their key; a restored
checkpoint (``TrainRunner.resume``: new tensors) or a batch of another
shape misses, and a miss drops every graph whose storage is not the
state's, with its memory pool.

What changes under a graph, against the eager step (``make_train_step``):

* The batch lives in fixed device buffers; each call copies its batch in.
* The optimizers return a new step counter; inside the graph it is copied
  into the state's counter, so the trees a call returns hold the same
  tensors at every step, and the learning rate and the bias corrections
  read the counter on the device (no Python number depends on the step).
* ``loss`` and ``grad_norm`` come back as fresh tensors (one clone each),
  which the next replay does not overwrite.
* The kernels' launch counters are Python increments, so they run only at
  capture: each graph records its launches and adds them at every replay
  (``kernels.graphs``).

A key's first call is the warm-up: the step runs eagerly on the capture
stream (it updates the state in place, so it cannot run twice) and is that
call's step; then the capture, which executes nothing. Every later call
with the key replays. The warm-up also builds the kernels and sets up the
capture stream's library handles outside the capture. A capture that fails
raises; nothing falls back to the eager step. The step runs on one CUDA
device: ``compile_train_step`` raises on the CPU and for a step built or
called inside a mesh context (gloo's collectives cannot be captured, and a
mesh across cards is not measured).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.distributed.sharding import get_mesh
from repro_torch.kernels.graphs import GraphStats, add_launches, capture
from repro_torch.models.common import tree_leaves, tree_map


def _storage(tree) -> Tuple:
    return tuple((a.data_ptr(), tuple(a.shape), a.dtype)
                 for a in tree_leaves(tree))


@dataclasses.dataclass(frozen=True)
class TrainKey:
    """What one captured step bakes in. ``storage``: every parameter and
    optimizer-state leaf's (address, shape, dtype); ``batch``: each batch
    entry's (name, shape, dtype), in the batch's order; ``step``: the
    microbatch count and the remat policy."""
    storage: Tuple
    batch: Tuple
    step: Tuple


def train_key(step_fn, params, opt_state, batch) -> TrainKey:
    """The cache key of ``step_fn`` (a ``make_train_step`` step) on this
    state and batch."""
    return TrainKey(_storage((params, opt_state)),
                    tuple((k, tuple(v.shape), v.dtype)
                          for k, v in batch.items()),
                    (step_fn.microbatches, step_fn.remat_policy))


def step_in_place(step_fn, params, opt_state, batch):
    """One step of ``step_fn`` that leaves the state in the tensors it was
    given: a leaf the step returns anew (the optimizer's counter) is copied
    into the state's. Returns (loss, grad norm)."""
    new = step_fn(params, opt_state, batch)

    def keep(dst, src):
        if dst is not src:
            dst.copy_(src)
    tree_map(keep, (params, opt_state), new[:2])
    return new[2]["loss"], new[2]["grad_norm"]


class TrainGraph:
    """One captured train step under one ``TrainKey``. It holds the state's
    leaves (it reads and writes them by address) and its batch buffers, and
    nothing of the model or of the caller's trees, so dropping it frees its
    memory pool by reference count."""

    def __init__(self, key: TrainKey, state, batch, stream, device):
        self.key = key
        self.stream = stream
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self.leaves = tree_leaves(state)
        self.batch = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                      for k, v in batch.items()}
        self.loss = self.grad_norm = None
        self.launches: Dict[str, int] = {}
        self.pool_bytes = 0
        self.capture_ms = 0.0

    def load(self, batch) -> None:
        """Copy a step's batch into the fixed buffers (on the current
        stream, in order with the replay)."""
        for k, v in batch.items():
            self.batch[k].copy_(v, non_blocking=True)

    def warm_and_capture(self, step_fn, params, opt_state):
        """Run the step eagerly on the capture stream (the warm-up, and this
        call's step), then capture it. Returns (loss, grad norm) of the
        warm-up, fresh tensors."""
        # the warm-up allocates on the capture stream, which cannot reuse
        # the blocks cached for another stream: hand those back first (a
        # step's activations take tens of GB at full width)
        torch.cuda.empty_cache()
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            loss, gnorm = step_in_place(step_fn, params, opt_state,
                                        self.batch)
            loss, gnorm = loss.clone(), gnorm.clone()
        cur.wait_stream(self.stream)
        (self.loss, self.grad_norm), self.capture_ms, self.pool_bytes, \
            self.launches = capture(
                self.graph, self.stream, self.device,
                lambda: step_in_place(step_fn, params, opt_state,
                                      self.batch),
                f"train graph capture failed (batch {self.key.batch}, "
                f"microbatches and remat {self.key.step})")
        return loss, gnorm

    def replay(self):
        """Replay the captured step on the current stream. Returns (loss,
        grad norm), fresh tensors."""
        try:
            self.graph.replay()
        except Exception as e:
            raise RuntimeError(f"train graph replay failed (batch "
                               f"{self.key.batch}): {e}") from e
        add_launches(self.launches)
        return self.loss.clone(), self.grad_norm.clone()


def _refuse_mesh(step_fn) -> None:
    if get_mesh() is not None or step_fn.mesh is not None:
        raise ValueError("the compiled train step runs on one device: a "
                         "mesh's collectives cannot be captured (run the "
                         "eager step over a mesh)")


class CompiledTrainStep:
    """``step_fn`` (a ``make_train_step`` step) through CUDA graphs: called
    as the step, (params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"}), the same trees back with their leaves updated in place.
    ``stats``: captures, replays, dropped graphs, capture ms and the live
    graphs' pool bytes."""

    def __init__(self, step_fn: Callable, device="cuda"):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"the compiled train step needs a CUDA device, "
                             f"not {self.device} (run the eager step there)")
        _refuse_mesh(step_fn)
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.step_fn = step_fn
        self.stream = torch.cuda.Stream(self.device)
        self.graphs: Dict[TrainKey, TrainGraph] = {}
        self.stats = GraphStats()

    def _drop_stale(self, key: TrainKey) -> None:
        """Drop every graph whose storage is not the state's (a restored
        checkpoint): their memory pools go with them."""
        for k in list(self.graphs):
            if k.storage != key.storage:
                self.stats.pool_bytes -= self.graphs.pop(k).pool_bytes
                self.stats.dropped += 1

    def _check_device(self, params, opt_state) -> None:
        off = {str(a.device) for a in tree_leaves((params, opt_state))
               if a.device != self.device}
        if off:
            raise ValueError(f"the compiled train step runs on "
                             f"{self.device}; the state lies on "
                             f"{sorted(off)}")

    def __call__(self, params, opt_state, batch):
        _refuse_mesh(self.step_fn)
        key = train_key(self.step_fn, params, opt_state, batch)
        g = self.graphs.get(key)
        if g is None:
            self._check_device(params, opt_state)
            self._drop_stale(key)
            g = TrainGraph(key, (params, opt_state), batch, self.stream,
                           self.device)
            g.load(batch)
            loss, gnorm = g.warm_and_capture(self.step_fn, params, opt_state)
            self.graphs[key] = g
            self.stats.captures += 1
            self.stats.capture_ms += g.capture_ms
            self.stats.pool_bytes += g.pool_bytes
        else:
            g.load(batch)
            loss, gnorm = g.replay()
            self.stats.replays += 1
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}


def compile_train_step(step_fn: Callable, device="cuda") -> CompiledTrainStep:
    """The compiled counterpart of ``step_fn`` on ``device`` (one CUDA
    device); raises ``ValueError`` on the CPU or under a mesh."""
    return CompiledTrainStep(step_fn, device)
