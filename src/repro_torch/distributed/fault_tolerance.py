"""Fault tolerance and straggler mitigation (``repro.distributed.
fault_tolerance``):

  * chip/host loss   -> checkpoint/restore (``training.checkpoint``) and
                        deterministic data replay keyed by step
                        (``training.data``);
  * stragglers       -> a per-step wall-clock watchdog with an EWMA
                        baseline; a slow step is recorded as a
                        ``StragglerEvent`` (a step that is slow on the host
                        side, such as an input stall, shows up too);
  * silent divergence -> a non-finite loss raises ``FloatingPointError``.

``TrainRunner`` packages the loop: a checkpoint every K steps, resume from
the latest checkpoint, failures injected in tests via ``fail_at``. Over a
mesh the runner saves and restores under the train state's shardings (a
restore under another mesh's is the elastic path), and ``elastic_reshard``
moves a live tree from one mesh's shardings to another's.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional

from repro_torch.distributed.sharding import gather_full, local_shard
from repro_torch.models.common import tree_map
from repro_torch.training import checkpoint as ckpt


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    baseline: float


class StepWatchdog:
    """EWMA per-step wall-clock monitor; flags steps slower than
    ``threshold`` x the moving baseline (straggler / input stall)."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.2):
        self.threshold = threshold
        self.alpha = alpha
        self.baseline: Optional[float] = None
        self.events: List[StragglerEvent] = []

    def observe(self, step: int, duration: float) -> Optional[StragglerEvent]:
        ev = None
        if self.baseline is not None and \
                duration > self.threshold * self.baseline:
            ev = StragglerEvent(step, duration, self.baseline)
            self.events.append(ev)
        self.baseline = (duration if self.baseline is None
                         else (1 - self.alpha) * self.baseline
                         + self.alpha * duration)
        return ev


def elastic_reshard(tree, shardings_from, shardings_to):
    """Re-place a live tree of rank blocks under ``shardings_from`` (a
    ``NamedSharding`` per leaf) onto ``shardings_to``, whose mesh may have
    another shape over the same world (a pod lost, a mesh regrouped): each
    leaf gathered whole over the first mesh and cut to the rank's block of
    the second, one leaf at a time. Every rank calls it."""
    return tree_map(
        lambda x, a, b: local_shard(gather_full(x, a.spec, a.mesh), b.spec,
                                    b.mesh),
        tree, shardings_from, shardings_to)


class TrainRunner:
    """Checkpointed training loop with failure injection for tests."""

    def __init__(self, train_step: Callable, batch_fn: Callable,
                 ckpt_dir: str, ckpt_every: int = 10,
                 watchdog: Optional[StepWatchdog] = None, shardings=None):
        """``shardings``: the {"params", "opt"} sharding tree where the
        state is a mesh's blocks (checkpoints gather it whole)."""
        self.train_step = train_step
        self.shardings = shardings
        self.batch_fn = batch_fn            # step -> batch (deterministic)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.watchdog = watchdog or StepWatchdog()
        self.metrics_log: List[Dict[str, float]] = []

    def run(self, params, opt_state, *, num_steps: int,
            start_step: int = 0, fail_at: Optional[int] = None):
        """Runs [start_step, num_steps); raises RuntimeError at ``fail_at``
        (test hook) AFTER the latest checkpoint, like a real crash. The
        step's wall time includes waiting for its loss (``float`` of it
        synchronises the device)."""
        step = start_step
        while step < num_steps:
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.monotonic()
            batch = self.batch_fn(step)
            params, opt_state, metrics = self.train_step(
                params, opt_state, batch)
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}")
            self.watchdog.observe(step, time.monotonic() - t0)
            self.metrics_log.append(
                {"step": step, **{k: float(v) for k, v in metrics.items()}})
            step += 1
            if step % self.ckpt_every == 0 or step == num_steps:
                ckpt.save(self.ckpt_dir, step,
                          {"params": params, "opt": opt_state},
                          shardings=self.shardings)
        return params, opt_state

    def resume(self, params_like, opt_like, *, num_steps: int, device=None,
               fail_at: Optional[int] = None):
        """Restore the latest checkpoint into trees shaped like
        ``params_like`` and ``opt_like`` (on ``device``, default each
        leaf's; the blocks of the runner's shardings, where it has them:
        those of another mesh restore elastically) and continue (crash
        recovery)."""
        step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.ckpt_dir}")
        tree, _ = ckpt.restore(self.ckpt_dir, step,
                               {"params": params_like, "opt": opt_like},
                               device, self.shardings)
        return self.run(tree["params"], tree["opt"], num_steps=num_steps,
                        start_step=step, fail_at=fail_at)
