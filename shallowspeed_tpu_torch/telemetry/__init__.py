"""Runtime telemetry of the port — counterpart of
`shallowspeed_tpu/telemetry/`.

- `trace`        the span tracer (`tracer().span("step", step=s)`):
                 host wall-clock and, at the `spans` level, device time
                 through CUDA synchronizes at span exits; streams
                 `spans.jsonl` and writes a Chrome `trace.json`.
- `collectives`  per-axis collective traffic (bytes, calls), counted
                 where the engines move data between cells.
- `memory`       allocated device bytes and their peak from the CUDA
                 caching allocator, the ownership registry
                 (`register_owner`, per-owner bytes by storage), host
                 RSS, `forensics()` and the `MemoryWatch` detector.
- `report`       `RunTelemetry`, the step-line fields and the run
                 summary; the request helpers (`percentile`,
                 `request_summary`, ...).
- `schema`, `sketch`, `regress`, `tracing`: copies of the reference's
                 pure modules (the line schema, mergeable histograms,
                 the bench gate, the cross-process request stitcher).
- `profiler`     the host sampling profiler, phase tags, capture
                 windows and the `torch.profiler` device trace.
- `health`, `anomaly`, `numerics`: the training-health pack, the
                 anomaly detector and the fp8 numerics monitor.
- `monitor`      the live plane: streaming sketches, the StatusServer
                 (/status.json, /sketches.json, /profile.json,
                 /metrics), SLO burn-rate alerts, the flight recorder,
                 the --live tailer.
- `goodput`      the run-level goodput ledger and its reducer.
- `bubble`       static, replayed and calibrated pipeline bubbles.
- `attribution`  the roofline waterfall: `roofline_of_step` (a dispatch
                 mode over one real step, plus the hand-written
                 kernels' self-reports) against the card's peaks.
- `fleet`        N replicas in one view: `FleetCollector` (merged
                 sketches, fleet SLOs, straggler scoring, replica
                 registration), `format_fleet_status`, `fleet_main`.
- `python -m shallowspeed_tpu_torch.telemetry --validate / --stitch /
                 --profile / --regress / --goodput / --live / --fleet`.

Levels: `off` (no-ops — no fences, no buffers), `steps` (host
timestamps only; dispatch stays asynchronous), `spans` (device fences
at span exits: attributable time, serialized dispatch).
"""

from shallowspeed_tpu_torch.telemetry.trace import (  # noqa: F401
    Tracer, configure, tracer)

_LAZY = {
    "device_memory_stats": "memory", "live_hbm_high_water": "memory",
    "register_owner": "memory", "unregister_owner": "memory",
    "clear_owners": "memory", "registered_owners": "memory",
    "per_owner_accounting": "memory", "top_live_arrays": "memory",
    "host_rss_bytes": "memory", "forensics": "memory",
    "MemoryWatch": "memory",
    "RunTelemetry": "report",
    "HealthMonitor": "health", "grad_health": "health",
    "update_health": "health", "merge_packs": "health",
    "fetch_pack": "health",
    "AnomalyDetector": "anomaly", "GuardPolicy": "anomaly",
    "RobustEWMA": "anomaly", "Verdict": "anomaly",
    "check_trajectory": "regress", "load_trajectory": "regress",
    "LogHistogram": "sketch", "MetricSketches": "sketch",
    "request_timeline": "report",
    "new_trace_id": "tracing", "new_span_id": "tracing",
    "stitch": "tracing", "goodput_block": "tracing",
    "PHASE_COMPONENT": "tracing",
    "request_waterfall": "report",
    "SamplingProfiler": "profiler", "ProfilerPlane": "profiler",
    "CaptureWindow": "profiler", "device_trace_ctx": "profiler",
    "profiler_tag": "profiler", "merge_profiles": "profiler",
    "flame_tree": "profiler", "profile_main": "profiler",
    "static_bubble": "bubble", "trace_bubble": "bubble",
    "two_point_bubble": "bubble", "replay_trace": "bubble",
    "costed_replay": "bubble", "calibrate_compiled": "bubble",
    "step_waterfall": "attribution", "roofline_of_step": "attribution",
    "device_rates": "attribution",
    "GoodputLedger": "goodput", "run_goodput": "goodput",
    "Monitor": "monitor", "StatusServer": "monitor",
    "FlightRecorder": "monitor", "SloRule": "monitor",
    "parse_slos": "monitor", "FileTailer": "monitor",
    "PortInUseError": "monitor", "prom_escape": "monitor",
    "FleetCollector": "fleet", "Replica": "fleet",
    "format_fleet_status": "fleet", "fleet_main": "fleet",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(
        f"shallowspeed_tpu_torch.telemetry.{mod}"), name)
