"""Training telemetry of the port — the health half of
`shallowspeed_tpu/telemetry/`:

- `health`   the training-health pack (gradient and parameter norms,
             the update-to-parameter ratio, the non-finite sentinel)
             computed on the device after every step, the cumulative
             counters, and `HealthMonitor`, the host-side reducer;
- `anomaly`  the streaming anomaly detector and the guard policy (pure
             Python, a copy of the reference's);
- `numerics` `NumericsMonitor`, the fp8 path's runtime precision
             monitor (pure Python, a copy of the reference's).

The reference's other planes (spans and tracing, bubble accounting,
memory, the live monitor, the profiler, goodput) are not ported yet
(ROADMAP Queue 1 item 6).
"""
