"""The drivers' telemetry wiring — what the root `train_lm.py` and
`train.py` do around their loops, shared by the port's two training
drivers: the flags, the tracer and `RunTelemetry` with the memory
owners, the profiling plane, and their teardown."""

from __future__ import annotations

from pathlib import Path

from shallowspeed_tpu_torch import distributed as D
from shallowspeed_tpu_torch.telemetry import memory, profiler
from shallowspeed_tpu_torch.telemetry.report import RunTelemetry
from shallowspeed_tpu_torch.telemetry.trace import configure
from shallowspeed_tpu_torch.utils import rprint

# where the root drivers' still-refused telemetry flags come from
MONITOR = "Queue 1 item 6b, monitor and accounting"
CHAOS = "Queue 1 item 6c, chaos and elastic"


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


def owners_of(engine) -> dict:
    """The reference drivers' memory owners, "train.params" and
    "train.opt_state", as resolvers of the trees the engine keeps
    resident (`engine.resident()`: every replica's or cell's own, not a
    gathered copy). Resolvers, since the engine replaces these trees."""
    return {"train.params": lambda: engine.resident()["params"],
            "train.opt_state": lambda: engine.resident()["opt_state"]}


def start_telemetry(args, engine, metrics, owners):
    """The root drivers' telemetry wiring: the process's tracer at
    --telemetry (`--trace-dir` implies `steps`; under several processes
    each writes into its own `p<index>` subdirectory), a `RunTelemetry`
    over `engine` when the level is on, with `owners` ({name: resolver})
    registered in the memory observatory, and the profiling plane of
    --profile. Returns (telemetry or None, plane or None)."""
    if args.trace_dir and args.telemetry == "off":
        args.telemetry = "steps"     # --trace-dir implies tracing
    trace_dir = args.trace_dir or None
    if trace_dir and D.process_count() > 1:
        trace_dir = str(Path(trace_dir) / f"p{D.process_index()}")
        args.trace_dir = trace_dir
    tracer = configure(trace_dir=trace_dir, level=args.telemetry)
    telem = None
    if args.telemetry != "off":
        telem = RunTelemetry(engine, tracer)
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


def telemetry_line(fields: dict) -> str:
    """The root driver's telemetry print line of a step's fields ("" when
    there is nothing to print); its bubble part waits for `bubble.py`."""
    parts = []
    if "coll_bytes_per_step" in fields:
        parts.append(f"coll {fields['coll_bytes_per_step'] / 2**20:,.1f} "
                     f"MiB/step")
    if "hbm_live_mib" in fields:
        parts.append(f"hbm {fields['hbm_live_mib']:,.0f} MiB")
    return ("             " + "  ".join(parts)) if parts else ""
