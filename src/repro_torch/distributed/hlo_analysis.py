"""Per-rank collective bytes of a step (PyTorch counterpart of
``repro.distributed.hlo_analysis``).

The reference parses the post-SPMD HLO of a compiled step and multiplies
each collective by the trip counts of the ``while`` loops around it (its
models scan over the layers). The port has no HLO: its collectives are
written out in ``distributed.collectives`` and the eager loop calls each
one once a layer, so there is no trip count to multiply. The statistics
come from that module's counter instead (``collectives.op_counts``), which
counts, by the reference's op names, each call and the bytes of its result
on this rank: the reference's rule (an all-gather its gathered tensor, an
all-reduce its tensor, a reduce-scatter the rank's block).

``all_sum``, ``all_max``, the backward of ``copy_to_region`` and
``reduce_from_region`` are all-reduces; ``all_gather_dim`` and
``gather_over`` all-gathers; ``reduce_scatter_dim`` a reduce-scatter. The
port makes no all-to-all and no collective-permute in training.

The reference's ``collective_bytes(hlo)`` and ``count_op(hlo, opname)``
have no counterpart, because no HLO exists.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.distributed import collectives

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, int]
    count_by_op: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())


def collective_stats() -> CollectiveStats:
    """The collectives this rank has made since the last
    ``collectives.reset_counts``, by op: calls and result bytes."""
    ops = collectives.op_counts()
    return CollectiveStats({k: v["bytes"] for k, v in ops.items()},
                           {k: v["calls"] for k, v in ops.items()})
