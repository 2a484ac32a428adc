"""Multi-replica cluster layer over the ``ServingRuntime`` protocol."""
from repro_torch.cluster.autoscaler import (
    Autoscaler, FleetSignal, ScalingPolicy, SchedulePolicy, SLOSlackPolicy,
    TargetUtilizationPolicy,
)
from repro_torch.cluster.fleet_prefix_cache import (
    FleetMatch, FleetPrefixCache, FleetStats,
)
from repro_torch.cluster.policy import CoordinatedRemapPolicy
from repro_torch.cluster.replica_group import ACTIVE, LEAVING, ReplicaGroup, WARMING
from repro_torch.cluster.router import (
    LEAST_LOADED, PREFIX_AFFINITY, POLICIES, SLACK_AWARE, Router,
)
from repro_torch.cluster.shard_set import ShardSet
