"""The drivers' telemetry wiring — what the root `train_lm.py` and
`train.py` do around their loops, shared by the port's two training
drivers (and, for the live monitor, `serve`): the flags, the tracer and
`RunTelemetry` with the memory owners, the profiling plane, the live
monitor and its endpoint, and their teardown."""

from __future__ import annotations

from pathlib import Path

from shallowspeed_tpu_torch import distributed as D
from shallowspeed_tpu_torch.telemetry import memory, monitor, profiler
from shallowspeed_tpu_torch.telemetry.report import RunTelemetry
from shallowspeed_tpu_torch.telemetry.trace import configure, tracer
from shallowspeed_tpu_torch.utils import rprint

# where the root drivers' still-refused telemetry flags come from
CHAOS = "Queue 1 item 6c, chaos and elastic"


def add_monitor_flags(p) -> None:
    """The root drivers' live-monitoring flags (`telemetry/monitor`)."""
    p.add_argument("--monitor-port", type=int, default=None,
                   help="serve /status.json, /sketches.json, "
                        "/profile.json and /metrics (Prometheus text) on "
                        "127.0.0.1:PORT while the run is live (0 = pick a "
                        "free port, printed at start)")
    p.add_argument("--slo", default="",
                   help="declarative SLOs evaluated over dual burn-rate "
                        "windows, e.g. 'step_p95_ms<500' or "
                        "'ttft_p95_ms<500,availability>0.99'; state "
                        "transitions land as 'alert' events")
    p.add_argument("--flight-recorder", type=int, default=0,
                   help="keep the last N metrics/span records in a ring "
                        "and dump flightrec_<step>.json (next to "
                        "--log-file) on an anomaly verdict or an SLO "
                        "alert (0 = off)")


def add_telemetry_flags(p) -> None:
    """The root training drivers' telemetry flags."""
    p.add_argument("--telemetry", default="off",
                   choices=["off", "steps", "spans"],
                   help="runtime telemetry level: steps = host-clock "
                        "spans + the step lines' memory and collective "
                        "fields (dispatch stays asynchronous); spans = "
                        "device-fenced phase spans (attributable time; "
                        "serializes dispatch — a measurement mode, not a "
                        "throughput mode)")
    p.add_argument("--trace-dir", type=str, default="",
                   help="write the telemetry trace here: spans.jsonl "
                        "(streamed), trace.json (Chrome/Perfetto), "
                        "telemetry.json (run summary). Implies "
                        "--telemetry steps when the level is off")
    p.add_argument("--profile-dir", type=str, default="",
                   help="write a torch.profiler trace (CPU and CUDA "
                        "activity, Chrome format) of the training loop")
    p.add_argument("--profile", default="off",
                   choices=["off", "host", "host+device"],
                   help="continuous profiling plane (telemetry/"
                        "profiler): the host stack sampler streaming "
                        "'profile' events into --log-file (step spans "
                        "tag the samples when --telemetry is on); "
                        "'host+device' wraps each triggered capture in "
                        "a bounded torch.profiler trace")
    p.add_argument("--profile-hz", type=float, default=None,
                   help="host sampler rate (default 67 Hz)")
    add_monitor_flags(p)


def owners_of(engine) -> dict:
    """The reference drivers' memory owners, "train.params" and
    "train.opt_state", as resolvers of the trees the engine keeps
    resident (`engine.resident()`: every replica's or cell's own, not a
    gathered copy). Resolvers, since the engine replaces these trees."""
    return {"train.params": lambda: engine.resident()["params"],
            "train.opt_state": lambda: engine.resident()["opt_state"]}


def start_telemetry(args, engine, metrics, owners, dtype: str = "bf16",
                    ledger=None):
    """The root drivers' telemetry wiring: the process's tracer at
    --telemetry (`--trace-dir` implies `steps`; under several processes
    each writes into its own `p<index>` subdirectory), a `RunTelemetry`
    over `engine` when the level is on (its waterfall priced at `dtype`'s
    peak, `ledger`'s totals in its run summary), with `owners` ({name:
    resolver}) registered in the memory observatory, and the profiling
    plane of --profile. Returns (telemetry or None, plane or None)."""
    if args.trace_dir and args.telemetry == "off":
        args.telemetry = "steps"     # --trace-dir implies tracing
    trace_dir = args.trace_dir or None
    if trace_dir and D.process_count() > 1:
        trace_dir = str(Path(trace_dir) / f"p{D.process_index()}")
        args.trace_dir = trace_dir
    tracer = configure(trace_dir=trace_dir, level=args.telemetry)
    telem = None
    if args.telemetry != "off":
        telem = RunTelemetry(engine, tracer, dtype=dtype)
        telem.ledger = ledger
        for name, resolve in owners.items():
            memory.register_owner(name, resolve)
    plane = profiler.from_args(args, metrics)
    return telem, plane


def stop_telemetry(args, telem, plane, owners) -> None:
    """Close what `start_telemetry` opened: the tracer (spans.jsonl
    flushed, trace.json written) back to `off`, the run summary into
    --trace-dir, the owners, the profiling plane's last snapshot."""
    try:
        if telem is not None and args.trace_dir:
            path = telem.write_summary(args.trace_dir)
            rprint(f"telemetry: {path} (+ spans.jsonl, trace.json)")
    finally:
        configure()
        for name in owners:
            memory.unregister_owner(name)
        if plane is not None:
            plane.close()


def start_monitor(args, metrics, plane=None):
    """The live monitor of --monitor-port / --slo / --flight-recorder
    (`monitor.from_args`), on process 0 only: fed every line `metrics`
    logs, the tracer's spans when tracing is on, and wired to the
    profiling plane `plane` (its snapshot behind /profile.json, its
    capture windows armed by the monitor's incidents and alerts). Prints
    the endpoint's URL. Returns (monitor, server), (None, None) when the
    plane is off."""
    if not D.process_zero():
        return None, None
    mon, srv = monitor.from_args(args, metrics)
    if mon is None:
        return None, None
    tr = tracer()
    if tr.level != "off":
        tr.subscribers.append(mon.record_span)
    if plane is not None:
        mon.profiler = plane
        mon.alert_listeners.append(plane.on_alert)
    if srv is not None:
        rprint(f"monitor: {srv.url('/status.json')} (+ /metrics)",
               flush=True)
    return mon, srv


def stop_monitor(mon, srv) -> None:
    """The monitor's final sketch snapshot into the log, then the
    endpoint shut down (`monitor.close_monitor`)."""
    if mon is None:
        return
    tr = tracer()
    if mon.record_span in tr.subscribers:
        tr.subscribers.remove(mon.record_span)
    monitor.close_monitor(mon, srv)


def telemetry_line(fields: dict) -> str:
    """The root driver's telemetry print lines of a step's fields ("" when
    there is nothing to print): the bubble, collective bytes and memory
    line, then the waterfall line at the `spans` level."""
    parts = []
    if "bubble_measured" in fields:
        parts.append(f"bubble {fields['bubble_measured']:.1%} (static "
                     f"{fields['bubble_static']:.1%})")
    elif "bubble_static" in fields:
        parts.append(f"bubble static {fields['bubble_static']:.1%}")
    if "coll_bytes_per_step" in fields:
        parts.append(f"coll {fields['coll_bytes_per_step'] / 2**20:,.1f} "
                     f"MiB/step")
    if "hbm_live_mib" in fields:
        parts.append(f"hbm {fields['hbm_live_mib']:,.0f} MiB")
    lines = [("             " + "  ".join(parts))] if parts else []
    if "attrib_unexplained_frac" in fields:
        wf = [f"compute {fields['attrib_compute_frac']:.0%}"]
        for key, name in (("attrib_comm_exposed_frac", "comm"),
                          ("attrib_bubble_frac", "bubble"),
                          ("attrib_host_frac", "host")):
            if key in fields:
                wf.append(f"{name} {fields[key]:.0%}")
        lines.append("             waterfall " + " + ".join(wf)
                     + f" -> unexplained "
                     f"{fields['attrib_unexplained_frac']:.0%}"
                     f"  (t_step {fields['attrib_t_step_ms']:.0f} ms)")
    return "\n".join(lines)
