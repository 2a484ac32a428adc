"""MIRAGE core — the paper's contribution: dynamic parameter remapping."""
from repro_torch.core.layer_selection import (
    uniform_interval_layers, min_circular_gap, beta1_feasible, beta2_feasible,
    choose_m, max_alpha, make_plan, RemapPlan,
)
from repro_torch.core.metadata_store import MetadataStore, ModelInfo, MemoryInfo
from repro_torch.core.remap_policy import victim_order, next_victim, next_revert
from repro_torch.core.remapping_controller import (
    RemappingController, ControllerConfig, RemapDecision,
)
from repro_torch.core.kv_allocator import (
    PagedKVAllocator, Segment, ShardedPagedKVAllocator,
)
from repro_torch.core.prefix_index import (
    PrefixIndex, PrefixMatch, PrefixNode, PrefixStats, block_hash,
    chain_hashes,
)
from repro_torch.core.transfer_engine import (
    StreamingFetch, TransferEngine, TransferStats, make_fetch, merge_blocks,
    split_blocks,
)
from repro_torch.core.transfer_pipeline import (
    FetchMiss, PlanDrain, PrefixFetch, ShardedPlanDrain, StepTiming,
    choose_m_pipeline,
    identity_plan, make_plan_pipeline, max_alpha_pipeline, plan_bubble,
    simulate_decode_step, sync_step_time, uniform_plan,
)
from repro_torch.core.expert_remap import (
    ExpertPlan, ExpertRemapState, ExpertRoutingStats, expert_plan_from_units,
    identity_expert_plan, merge_experts, residency_states, split_experts,
    step_fetch_plan,
)
