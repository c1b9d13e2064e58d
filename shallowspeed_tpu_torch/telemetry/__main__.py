"""CLI of the port's telemetry, counterpart of
`shallowspeed_tpu/telemetry/__main__.py`: validate JSONL, gate the
bench trajectory, stitch request traces, reduce profiles, reduce a
run's goodput ledger, watch a run live.

    python -m shallowspeed_tpu_torch.telemetry --validate run/spans.jsonl
    python -m shallowspeed_tpu_torch.telemetry --validate docs_runs/
    python -m shallowspeed_tpu_torch.telemetry --regress BENCH_*.json
    python -m shallowspeed_tpu_torch.telemetry --trace-stitch \
        run/router.jsonl run/replica_r0.jsonl --out stitched.json
    python -m shallowspeed_tpu_torch.telemetry --profile run/metrics.jsonl \
        --out flame.json
    python -m shallowspeed_tpu_torch.telemetry --goodput run/metrics.jsonl
    python -m shallowspeed_tpu_torch.telemetry --live run/metrics.jsonl \
        [--slo 'step_p95_ms<500'] [--once]
    python -m shallowspeed_tpu_torch.telemetry --fleet \
        http://127.0.0.1:9100 http://127.0.0.1:9101 [--port 9200]
    python -m shallowspeed_tpu_torch.telemetry --fleet r0.jsonl r1.jsonl \
        --once

--validate checks metrics and span lines against the schema (the
reference's, `schema.SCHEMA_VERSION`); --regress is the reference's
bench-trajectory gate; --trace-stitch (also --stitch) joins a router
log and replica logs on one skew-corrected timeline and writes a
Chrome trace (telemetry/tracing.py); --profile reduces the host
sampler's "profile" events to a flamegraph JSON; --goodput prints the
run-level wall-clock decomposition (goodput and named losses) of one
metrics JSONL, of either package (extra files: replica logs joined by
trace id); --live tails a growing metrics JSONL and renders the view
the /status.json endpoint serves (--once: render once and exit);
--fleet aggregates N replicas (status URLs and/or metrics JSONL files)
into one fleet view — merged quantiles, per-replica breakdown, fleet
SLO burn, straggler detection — optionally served again on --port as
the fleet's own /status.json + /metrics (telemetry/fleet.py).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m shallowspeed_tpu_torch.telemetry")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--validate", nargs="+", metavar="PATH",
                   help="JSONL files (or directories scanned for "
                        "*.jsonl) to check against the telemetry/"
                        "metrics schema")
    g.add_argument("--regress", nargs="+", metavar="PATH",
                   help="BENCH_r*.json files (or directories scanned "
                        "for them) — fail when the newest round drops "
                        "below the prior rounds beyond the noise band")
    g.add_argument("--trace-stitch", "--stitch", nargs="+",
                   metavar="JSONL", dest="trace_stitch",
                   help="join a router log + N replica logs on one "
                        "skew-corrected timeline and write a Chrome "
                        "trace to --out; prints the clock fit and each "
                        "request's latency waterfall")
    g.add_argument("--profile", nargs="+", metavar="JSONL",
                   help="reduce the 'profile' events of one or more "
                        "metrics JSONLs to a flamegraph JSON (--out) + "
                        "a printed top-frames/phases summary")
    g.add_argument("--goodput", nargs="+", metavar="JSONL",
                   help="reduce one metrics JSONL to the goodput "
                        "report (wall-clock decomposition + losses, "
                        "MTTR, availability, p50/p95 ttft/tpot on "
                        "serving runs); extra files are replica logs "
                        "joined by trace id into the per-request "
                        "waterfall block")
    g.add_argument("--live", metavar="JSONL",
                   help="tail a growing metrics JSONL and render the "
                        "live status view (the /status.json surface "
                        "for endpoint-less runs); Ctrl-C exits")
    g.add_argument("--fleet", nargs="+", metavar="TARGET",
                   help="aggregate N replicas into one fleet view: "
                        "http(s) targets are polled /status.json + "
                        "/sketches.json endpoints, anything else is a "
                        "metrics JSONL to tail (telemetry/fleet.py) — "
                        "merged quantiles, per-replica breakdown, "
                        "fleet SLO burn, straggler detection")
    p.add_argument("--once", action="store_true",
                   help="with --live/--fleet: render the current state "
                        "once and exit instead of following")
    p.add_argument("--slo", default="",
                   help="with --live/--fleet: evaluate these SLOs over "
                        "the (merged) stream (telemetry/monitor DSL, "
                        "e.g. 'ttft_p95_ms<500,availability>0.99')")
    p.add_argument("--interval", type=float, default=2.0,
                   help="with --live/--fleet: seconds between renders")
    p.add_argument("--port", type=int, default=None,
                   help="with --fleet: also serve the fleet's own "
                        "/status.json + /metrics (replica-labelled) "
                        "here (0 = free port)")
    p.add_argument("--log-file", default=None,
                   help="with --fleet: append straggler/alert events "
                        "to this JSONL")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="with --trace-stitch: where the Chrome trace "
                        "JSON lands (default: stitched_trace.json "
                        "next to the first input); with --profile: "
                        "where the flamegraph JSON lands (omitted = "
                        "summary only)")
    args = p.parse_args(argv)

    if args.fleet:
        from shallowspeed_tpu_torch.telemetry.fleet import fleet_main

        return fleet_main(args.fleet, slos=args.slo, once=args.once,
                          interval=args.interval, port=args.port,
                          log_file=args.log_file)

    if args.live:
        from shallowspeed_tpu_torch.telemetry.monitor import live_main

        return live_main(args.live, slos=args.slo, once=args.once,
                         interval=args.interval)

    if args.goodput:
        from shallowspeed_tpu_torch.telemetry.goodput import (format_report,
                                                              run_goodput)

        print(format_report(run_goodput(
            args.goodput[0], extra_paths=args.goodput[1:])))
        return 0

    if args.profile:
        from shallowspeed_tpu_torch.telemetry.profiler import profile_main

        return profile_main(args.profile, out=args.out)

    if args.trace_stitch:
        from shallowspeed_tpu_torch.telemetry.tracing import stitch_main

        out = args.out
        if out is None:
            out = str(Path(args.trace_stitch[0]).parent
                      / "stitched_trace.json")
        return stitch_main(args.trace_stitch, out=out)

    if args.regress:
        from shallowspeed_tpu_torch.telemetry.regress import main as rmain

        return rmain(args.regress)

    from shallowspeed_tpu_torch.telemetry.schema import validate_file

    files: list[Path] = []
    for raw in args.validate:
        path = Path(raw)
        if path.is_dir():
            files.extend(sorted(path.glob("*.jsonl")))
        else:
            files.append(path)
    if not files:
        print("no .jsonl files to validate")
        return 0
    problems = []
    for f in files:
        if not f.exists():
            problems.append(f"{f}: no such file")
            continue
        problems.extend(validate_file(f))
    for prob in problems:
        print(prob, file=sys.stderr)
    print(f"validated {len(files)} file(s): "
          f"{'OK' if not problems else f'{len(problems)} problem(s)'}")
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
