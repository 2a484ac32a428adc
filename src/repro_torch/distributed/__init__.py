"""Distributed training support of the port. Only the fault-tolerance
loop is ported so far; sharding, the analytic cost model and the HLO
analysis wait for ROADMAP queue 1 item 9."""
from repro_torch.distributed.fault_tolerance import (
    StepWatchdog, StragglerEvent, TrainRunner, elastic_reshard,
)
