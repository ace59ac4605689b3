"""Telemetry of the port (counterpart of the JAX package's ``obs``): the
metrics registry, the run ledger, the trainers' and the server's spans,
traces, health monitors, the capacity meter, continuous profiling over
``torch.profiler``, and the ledger readers (``obs.report``, the fleet
merge, the cross-run registry and compare, ``obs.top``), under the JAX
package's exported names. Recompile tracking (``obs.recompile``) comes
with queue A 13's remainder."""

from tensorflowdistributedlearning_tpu_torch.obs.capacity import (
    COST_EVENT,
    WATERMARK_EVENT,
    CostMeter,
    WatermarkTracker,
)
from tensorflowdistributedlearning_tpu_torch.obs.compare import (
    compare_workdirs,
    load_registry,
    register_run,
    run_summary,
)
from tensorflowdistributedlearning_tpu_torch.obs.fleet import (
    STRAGGLER_ALERT_EVENT,
    ProcessLedger,
    discover_ledgers,
    fleet_section,
    fleet_summary,
)
from tensorflowdistributedlearning_tpu_torch.obs.health import (
    HEALTH_ALERT_EVENT,
    HeadroomMonitor,
    HealthAbortError,
    HealthMonitor,
    SloTracker,
)
from tensorflowdistributedlearning_tpu_torch.obs.ledger import (
    LEDGER_FILENAME,
    RunLedger,
    flush_all_ledgers,
    per_process_filename,
    read_ledger,
    read_ledger_with_errors,
)
from tensorflowdistributedlearning_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    MetricsRegistry,
    TimeHistogram,
    time_summary,
)
from tensorflowdistributedlearning_tpu_torch.obs.profiler import (
    OP_ROOFLINE_EVENT,
    PROFILE_CAPTURE_EVENT,
    ContinuousProfiler,
    build_roofline,
    resolve_peak_flops,
)
from tensorflowdistributedlearning_tpu_torch.obs.telemetry import (
    NULL_TELEMETRY,
    PREFETCH_DEPTH_HISTOGRAM,
    SPAN_BARRIER,
    SPAN_CHECKPOINT,
    SPAN_DATA_WAIT,
    SPAN_EVAL,
    SPAN_FETCH_WAIT,
    SPAN_STEP,
    Telemetry,
)
from tensorflowdistributedlearning_tpu_torch.obs.trace import (
    NULL_TRACER,
    TRACE_EVENT,
    TraceContext,
    Tracer,
    export_chrome_trace,
    write_chrome_trace,
)

__all__ = [
    "COST_EVENT",
    "HEALTH_ALERT_EVENT",
    "PREFETCH_DEPTH_HISTOGRAM",
    "SPAN_BARRIER",
    "SPAN_CHECKPOINT",
    "SPAN_DATA_WAIT",
    "SPAN_EVAL",
    "SPAN_FETCH_WAIT",
    "SPAN_STEP",
    "STRAGGLER_ALERT_EVENT",
    "TRACE_EVENT",
    "WATERMARK_EVENT",
    "CostMeter",
    "Counter",
    "Gauge",
    "HeadroomMonitor",
    "HealthAbortError",
    "HealthMonitor",
    "LEDGER_FILENAME",
    "MetricsRegistry",
    "NULL_TELEMETRY",
    "NULL_TRACER",
    "OP_ROOFLINE_EVENT",
    "PROFILE_CAPTURE_EVENT",
    "ContinuousProfiler",
    "ProcessLedger",
    "RunLedger",
    "SloTracker",
    "Telemetry",
    "TimeHistogram",
    "TraceContext",
    "Tracer",
    "WatermarkTracker",
    "build_roofline",
    "compare_workdirs",
    "discover_ledgers",
    "export_chrome_trace",
    "fleet_section",
    "fleet_summary",
    "flush_all_ledgers",
    "load_registry",
    "per_process_filename",
    "read_ledger",
    "read_ledger_with_errors",
    "register_run",
    "resolve_peak_flops",
    "run_summary",
    "time_summary",
    "write_chrome_trace",
]
