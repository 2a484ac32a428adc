from repro_torch.serving.engine import ServingEngine, TenantConfig
from repro_torch.serving.request import Request, ServingMetrics
from repro_torch.serving.runtime import (
    RuntimeConfig, ServingRuntime, TenantSpec, merge_arrivals, scale_slo,
)
from repro_torch.serving.slo import (
    BEST_EFFORT, LATENCY, SLOSpec, slo_attainment, tenant_slack,
)
from repro_torch.serving.scheduler import (
    SLOScheduler, SpatialScheduler, TemporalScheduler, make_scheduler,
)
from repro_torch.serving.trace_replay import (
    ReplaySpec, TraceRecord, load_trace, replay_trace, synth_records,
    write_sample_traces,
)
from repro_torch.serving.traces import (
    ConversationSpec, DiurnalSpec, TraceSpec, diurnal_trace, make_trace,
    multi_turn_trace, tiny_trace,
)
from repro_torch.serving.hw import HardwareSpec, TPU_V5E, TPU_V5E_PCIE, GH200, SPECS
from repro_torch.serving.perf_model import PerfModel
