"""Fleet serving driver for the PyTorch port: an SLO-aware,
fault-tolerant router over N `serve --serve` replica processes.
Counterpart of the root `router.py`.

    python -m shallowspeed_tpu_torch.router --replicas 2 \
        --requests reqs.jsonl --log-file run/router.jsonl \
        [--device cpu] [--slo 'ttft_p95_ms<500'] [--autoscale] \
        [--hang-timeout 10] [--chaos-fleet 'r0=kill@6;r1=stall@4:0.5' \
         --chaos-state run/chaos]

Each replica is `python -m shallowspeed_tpu_torch.serve --serve` on the
router's `--device` (default cuda: a replica that cannot reach the card
fails and is respawned on its restart budget, never moved to the CPU),
with its own monitor + request endpoint, heartbeat file and metrics
JSONL in `--run-dir`; it registers its endpoint at the router's fleet
collector (`--monitor-port`, 0 = a free port, printed as a
`{"event": "fleet_listening", ...}` line). The pieces are
`shallowspeed_tpu_torch/serving/router.py`'s: per-replica circuit
breakers, per-request deadlines and progress timeouts with seeded
re-dispatch (a failed-over stream continues on another replica as the
solo stream would), fleet-edge backpressure (typed reject with a
retry-after), classified respawn on `elastic.RestartPolicy`, hang
detection off the heartbeat files, burn-driven autoscaling
(`--autoscale`).

Requests use `serve`'s JSONL format. Every routing decision lands in
`--log-file` ("route" / "failover" / "scale" events, breaker and
restart_downtime ledger stamps, fleet-edge "request" records), so

    python -m shallowspeed_tpu_torch.telemetry --goodput run/router.jsonl

reports request percentiles, per-replica MTTR and fleet availability
from the router log alone, and `--trace-stitch run/router.jsonl
run/replica_r*.jsonl --out trace.json` joins the fleet's logs on one
timeline. `--chaos-fleet` hands each named replica its own seeded fault
plan (`serve --chaos`, markers under `--chaos-state/<name>`).

Beyond the root driver: `--await-replicas S` holds the first request
until every initial replica has registered (at most S seconds; request
`at` offsets then count from there), `--settle S` keeps the fleet up
after the last request until every replica is back up with a closed
breaker (at most S seconds; a respawn's restart_downtime stamp then
lands in the log), and a `{"event": "replica_ready", "replica", "start_s"}`
line is printed each time a replica (first start or respawn) registers.
The root driver's `--platform` is refused (`NotPorted`): `--device`
replaces it.
"""

from __future__ import annotations

import argparse
import json
import shlex
import sys
import time
from collections import deque
from pathlib import Path

from shallowspeed_tpu_torch import NotPorted

# the root driver's flags this driver does not have, and what takes
# each one's place
UNPORTED = {"--platform": "--device replaces it: every replica runs there"}


class _Refuse(argparse.Action):
    """Any use of an unported flag raises `NotPorted`."""

    def __call__(self, parser, namespace, values, option_string=None):
        raise NotPorted(f"router {option_string}", UNPORTED[option_string])


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    m = p.add_argument_group("model (forwarded to every replica)")
    m.add_argument("--vocab", type=int, default=256)
    m.add_argument("--d-model", type=int, default=64)
    m.add_argument("--n-heads", type=int, default=4)
    m.add_argument("--n-layers", type=int, default=2)
    m.add_argument("--max-seq", type=int, default=512)
    m.add_argument("--rope", action="store_true")
    m.add_argument("--init-seed", type=int, default=0)
    m.add_argument("--ckpt", default=None)
    s = p.add_argument_group("serving (forwarded to every replica)")
    s.add_argument("--n-blocks", type=int, default=128)
    s.add_argument("--block-size", type=int, default=16)
    s.add_argument("--slots", type=int, default=4)
    s.add_argument("--prefill-chunk", type=int, default=64)
    s.add_argument("--prefix-cache", default="on", choices=["off", "on"],
                   help="prefix caching on every replica (serve "
                        "--prefix-cache) and sticky prefix-affinity "
                        "routing here: a replica that already served a "
                        "prompt's leading aligned chunks earns a bounded "
                        "dispatch bonus")
    s.add_argument("--replica-args", default="",
                   help="extra raw serve args appended to every replica's "
                        "command (shlex-split), e.g. '--weight-quant int8 "
                        "--spec-k 4'")
    s.add_argument("--profile", default="off",
                   choices=["off", "host", "host+device"],
                   help="the profiling plane, forwarded to every replica "
                        "(serve --profile) and run here too: the router's "
                        "own loop sampled into --log-file, a firing "
                        "straggler event arming a capture window")
    s.add_argument("--device", default=None,
                   help="torch device of every replica (default cuda; "
                        "'cpu' runs the plain torch versions of the "
                        "kernels)")
    f = p.add_argument_group("fleet")
    f.add_argument("--replicas", type=int, default=2,
                   help="initial replica count")
    f.add_argument("--min-replicas", type=int, default=1)
    f.add_argument("--max-replicas", type=int, default=4)
    f.add_argument("--autoscale", action="store_true",
                   help="sustained critical SLO burn spawns a replica, "
                        "sustained idle drains one (graceful, deregistered)")
    f.add_argument("--slo", default="",
                   help="fleet-edge SLOs over the router's own "
                        "observations (monitor DSL, e.g. "
                        "'ttft_p95_ms<500,availability>0.99'); also the "
                        "autoscale burn signal")
    f.add_argument("--scale-hold", type=float, default=5.0,
                   help="seconds a critical burn must last before a "
                        "scale-up")
    f.add_argument("--idle-drain", type=float, default=30.0,
                   help="seconds of fleet idle before a scale-down drain")
    f.add_argument("--scale-cooldown", type=float, default=10.0)
    r = p.add_argument_group("router")
    r.add_argument("--monitor-port", type=int, default=0,
                   help="the fleet endpoint (collector /status.json + "
                        "/metrics + POST /register|/deregister) the "
                        "replicas register with; 0 = a free port")
    r.add_argument("--log-file", default=None,
                   help="router metrics JSONL (route / failover / scale "
                        "events, ledger stamps, fleet-edge request "
                        "records)")
    r.add_argument("--requests", default="-",
                   help="JSONL request file (serve's format), or - for "
                        "stdin")
    r.add_argument("--request-timeout", type=float, default=30.0,
                   help="seconds without new tokens before a request fails "
                        "over to another replica")
    r.add_argument("--deadline", type=float, default=None,
                   help="default per-request end-to-end deadline in "
                        "seconds (typed failure past it); a request's own "
                        "'deadline' field overrides it")
    r.add_argument("--queue-budget", type=int, default=256,
                   help="router pending-queue budget; past it submit "
                        "rejects typed with a retry-after")
    r.add_argument("--await-replicas", type=float, default=0.0,
                   metavar="S",
                   help="hold the first request until every initial "
                        "replica has registered, at most S seconds "
                        "(0 = requests queue here while replicas start)")
    r.add_argument("--settle", type=float, default=0.0, metavar="S",
                   help="after the last request, keep the fleet up until "
                        "every replica is back up with a closed breaker, "
                        "at most S seconds")
    e = p.add_argument_group("supervision (elastic taxonomy)")
    e.add_argument("--hang-timeout", type=float, default=None,
                   help="kill and respawn a replica whose heartbeat goes "
                        "stale this long")
    e.add_argument("--term-grace", type=float, default=5.0)
    e.add_argument("--max-restarts", type=int, default=3,
                   help="per-replica restart budget (per-class jittered "
                        "backoff, elastic.RestartPolicy)")
    e.add_argument("--backoff", type=float, default=1.0)
    c = p.add_argument_group("chaos (fleet drills)")
    c.add_argument("--chaos-fleet", default="",
                   help="per-replica fault plans: 'r0=kill@6;r1=stall@4:0.5'"
                        " — each named replica runs its own seeded plan "
                        "(serve --chaos); faults index engine ticks")
    c.add_argument("--chaos-state", default="",
                   help="fired-marker base dir (per-replica subdirs; must "
                        "survive respawns — required with --chaos-fleet)")
    c.add_argument("--chaos-seed", type=int, default=0)
    p.add_argument("--run-dir", default=None,
                   help="replica logs and heartbeat files land here "
                        "(default: the --log-file's directory, else a "
                        "temporary directory)")
    for flag in UNPORTED:
        p.add_argument(flag, nargs="?", action=_Refuse,
                       help=argparse.SUPPRESS)
    return p


def parse_args(argv=None):
    return parser().parse_args(argv)


def _emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    import tempfile

    from shallowspeed_tpu_torch import chaos
    from shallowspeed_tpu_torch.elastic import install_sigterm_exit
    from shallowspeed_tpu_torch.metrics import MetricsLogger
    from shallowspeed_tpu_torch.serve import load_requests
    from shallowspeed_tpu_torch.serving.router import (FleetOverloaded,
                                                       ReplicaProc, Router)
    from shallowspeed_tpu_torch.telemetry import profiler
    from shallowspeed_tpu_torch.telemetry.fleet import FleetCollector
    from shallowspeed_tpu_torch.telemetry.monitor import StatusServer
    from shallowspeed_tpu_torch.telemetry.report import request_summary

    # SIGTERM becomes SystemExit: the teardown below still stops every
    # replica and prints the summary
    install_sigterm_exit()
    chaos_map = {}
    if args.chaos_fleet:
        if not args.chaos_state:
            raise SystemExit("--chaos-fleet needs --chaos-state (fired-fault "
                             "markers must survive respawns, or every "
                             "respawned replica re-fires every fault)")
        chaos_map = chaos.parse_fleet_spec(args.chaos_fleet)
    run_dir = Path(args.run_dir) if args.run_dir else (
        Path(args.log_file).parent if args.log_file
        else Path(tempfile.mkdtemp(prefix="router_")))
    run_dir.mkdir(parents=True, exist_ok=True)
    reqs = ([] if args.requests == "-" and sys.stdin.isatty()
            else load_requests(args.requests, args.vocab))

    metrics = MetricsLogger(args.log_file, kind="router",
                            replicas=args.replicas, slo=args.slo,
                            autoscale=args.autoscale)
    collector = FleetCollector()
    fleet_srv = StatusServer(collector, port=args.monitor_port)
    fleet_url = f"http://{fleet_srv.host}:{fleet_srv.port}"
    _emit(event="fleet_listening", url=fleet_srv.url("/status.json"))
    collector.start(poll=0.5)

    model_args = ["--vocab", str(args.vocab), "--d-model", str(args.d_model),
                  "--n-heads", str(args.n_heads),
                  "--n-layers", str(args.n_layers),
                  "--max-seq", str(args.max_seq),
                  "--init-seed", str(args.init_seed),
                  "--n-blocks", str(args.n_blocks),
                  "--block-size", str(args.block_size),
                  "--slots", str(args.slots),
                  "--prefill-chunk", str(args.prefill_chunk),
                  "--prefix-cache", args.prefix_cache,
                  "--device", args.device or "cuda"]
    if args.rope:
        model_args.append("--rope")
    if args.ckpt:
        model_args += ["--ckpt", args.ckpt]
    if args.profile != "off":
        model_args += ["--profile", args.profile]
    model_args += shlex.split(args.replica_args)

    # the router's own host sampler (dispatch loop, progress polls) into
    # --log-file; a firing straggler event arms a capture beside it
    plane = profiler.from_args(args, metrics, out_dir=run_dir)
    if plane is not None:
        collector.straggler_listeners.append(plane.on_straggler)

    def spawn(name: str) -> ReplicaProc:
        hb = str(run_dir / f"hb_{name}")
        child = [sys.executable, "-m", "shallowspeed_tpu_torch.serve",
                 "--serve", "--monitor-port", "0",
                 "--fleet-register", fleet_url, "--replica", name,
                 "--log-file", str(run_dir / f"replica_{name}.jsonl"),
                 "--heartbeat-file", hb] + model_args
        if name in chaos_map:
            child += ["--chaos", chaos_map[name],
                      "--chaos-state", str(Path(args.chaos_state) / name),
                      "--chaos-seed", str(args.chaos_seed)]
        return ReplicaProc(name, child, collector, heartbeat_file=hb,
                           hang_timeout=args.hang_timeout,
                           term_grace=args.term_grace,
                           stdout_path=str(run_dir / f"replica_{name}.out"))

    router = Router(
        spawn, n_replicas=args.replicas, collector=collector,
        metrics=metrics, slos=args.slo, queue_budget=args.queue_budget,
        request_timeout=args.request_timeout,
        default_deadline_s=args.deadline, progress_interval=0.2,
        policy_kw=dict(max_restarts=args.max_restarts,
                       backoff=args.backoff, jitter=0.1),
        autoscale=args.autoscale, min_replicas=args.min_replicas,
        max_replicas=args.max_replicas, scale_hold_s=args.scale_hold,
        idle_drain_s=args.idle_drain, scale_cooldown_s=args.scale_cooldown,
        sticky=(args.prefix_cache == "on"), sticky_block=args.block_size)

    announced: dict[str, float] = {}

    def announce() -> None:
        """A replica_ready line for every (re)spawned replica that has
        registered since the last call."""
        for name, entry in router._replicas.items():
            h = entry["handle"]
            if entry["alive"] and not entry["warming"] \
                    and announced.get(name) != h.spawned_at:
                announced[name] = h.spawned_at
                _emit(event="replica_ready", replica=name,
                      start_s=round(time.time() - h.spawned_at, 3))

    def all_up() -> bool:
        return all(e["alive"] and not e["warming"]
                   and router._breakers[n].state == "closed"
                   for n, e in router._replicas.items() if not e["retired"])

    def wait_for(cond, limit: float) -> None:
        t_end = time.time() + limit
        while time.time() < t_end and not cond():
            if not router.step():
                time.sleep(0.02)
            announce()

    t0 = time.time()
    i = 0
    retry: deque = deque()        # (ready_at, request) after an overload
    reported = 0
    try:
        if args.await_replicas > 0:
            wait_for(lambda: not any(e["warming"] for e
                                     in router._replicas.values()),
                     args.await_replicas)
            t0 = time.time()
        while i < len(reqs) or retry or router.unfinished():
            now = time.time() - t0

            def _offer(r):
                try:
                    router.submit(r["prompt"], r["max_new"],
                                  temperature=r.get("temperature", 0.0),
                                  seed=r.get("seed", 0), rid=r["id"],
                                  deadline_s=r.get("deadline", None))
                except FleetOverloaded as e:
                    # fleet-edge backpressure: honour the retry-after
                    retry.append((now + e.retry_after, r))
                except (KeyError, TypeError, ValueError) as e:
                    _emit(event="error", id=r.get("id"),
                          error=f"{type(e).__name__}: {e}")

            while i < len(reqs) and reqs[i]["at"] <= now:
                _offer(reqs[i])
                i += 1
            # retry_after varies per rejection: scan the whole deque
            for _ in range(len(retry)):
                ready_at, r = retry.popleft()
                if ready_at <= now:
                    _offer(r)
                else:
                    retry.append((ready_at, r))
            if not router.step():
                time.sleep(0.02)
            announce()
            if not router.replica_names():
                # every replica retired (restart budgets spent): nothing
                # can become routable again, so every remaining request
                # gets a terminal record instead of a wait forever
                dead = "fleet dead: every replica retired"
                for r in ([reqs[j] for j in range(i, len(reqs))]
                          + [r for _, r in retry]):
                    _emit(event="error", id=r.get("id"), error=dead)
                retry.clear()
                i = len(reqs)
                router.fail_unfinished(dead)
            for rec in router.records[reported:]:
                reported += 1
                out = {"event": "result", **rec}
                if rec["status"] == "done":
                    out["tokens"] = [int(t)
                                     for t in router.results[rec["id"]]]
                _emit(**out)
        if args.settle > 0 and router.replica_names():
            wait_for(all_up, args.settle)
    finally:
        wall = time.time() - t0
        done = [r for r in router.records if r["status"] == "done"]
        summary = request_summary([r for r in done if "ttft_ms" in r]) or {}
        summary.update({"wall_s": round(wall, 3),
                        "replicas": router.replica_names(),
                        "counters": dict(router.counters)})
        _emit(event="summary", **summary)
        router.shutdown()
        if plane is not None:
            plane.close()
        collector.stop()
        fleet_srv.close()
        metrics.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
