"""Trace/metrics JSONL schema — the committed-artifact gate.

A copy of `shallowspeed_tpu/telemetry/schema.py` (pure Python; the
port keeps its own copy rather than import the JAX package).

Two line dialects share `docs_runs/*.jsonl`:

- METRICS lines (`metrics.MetricsLogger`): {"event": <type>, ...} with
  per-type required fields (a "step" line must carry step/loss/
  tokens_per_sec — and, when telemetry was on, its telemetry fields
  must be well-typed).
- SPAN lines (`telemetry.trace.Tracer`): Chrome-trace-shaped events
  {"name", "ph": "X"|"i"|"C", "ts"[, "dur"], "args"} in microseconds.

`validate_line` returns a list of problems (empty = valid);
`validate_file` maps them to line numbers. The pre-commit hook runs
`python -m shallowspeed_tpu_torch.telemetry --validate <files>` over any
committed docs_runs JSONL so a snapshot that drifts from the schema
fails at commit time, not at the next reader.
"""

from __future__ import annotations

import json
from pathlib import Path

# Version of the line dialects this module describes. 1 = the first (spans +
# hardware telemetry step fields); 2 = v1 plus the training-health
# extension (health_* step fields, the "health" event); 3 = v2 plus
# the comm/compute-overlap fields (`exposed_comm_frac` /
# `overlap_ratio` — the step program's dataflow communication
# exposure, `parallel/overlap.collective_exposure` — and the engine's
# `overlap` mode flag); 4 = v3 plus the time-attribution waterfall
# (`attrib_*` step fields, `telemetry/attribution.py`), the goodput
# ledger (`"ledger"` events, `telemetry/goodput.py`) and the absolute
# `wall` timestamp every metrics line now carries so the ledger
# reducer can account wall clock ACROSS process restarts. Writers
# stamp it on their run_start line (metrics.MetricsLogger); 5 = v4
# plus the chaos/recovery extension (`shallowspeed_tpu/chaos.py`,
# round 10): `"fault"` events stamped at every injected fault, and
# the `fail_class` field on supervisor-stamped ledger lines
# (restart_downtime / poison_step_abort / supervisor_abort) that the
# goodput reducer turns into per-failure-class MTTR; 6 = v5 plus the
# serving extension (round 11, `shallowspeed_tpu/serving/`):
# `"request"` events — one per completed request, carrying the
# per-request SLO record (ttft_ms, tpot_ms, queue depth at
# completion, preemption count, tokens in/out) the `--goodput`
# reducer turns into p50/p95 ttft/tpot — and the serving fields the
# periodic `"generate"` tick lines grew (queue_depth, active_slots,
# free_blocks, the live-blocks HBM sweep); 7 = v6 plus the live
# telemetry plane (round 12, `telemetry/monitor.py` + `sketch.py`):
# `"monitor"` events — periodic serializations of the streaming
# log-bucketed histogram sketches (step time, ttft/tpot, tok/s, queue
# depth, free blocks), mergeable across processes/stanzas so the
# supervisor and `--goodput` can recombine them into whole-run
# quantiles — and `"alert"` events stamped by the SLO burn-rate
# evaluator (--slo) at every state transition; 8 = v7 plus the fleet
# observability extension (round 13, `telemetry/fleet.py` +
# `serving/engine.py` lifecycle tracing): `"straggler"` events — a
# FleetCollector's sustained-divergence verdict on one replica's
# per-metric quantiles vs the fleet median (RobustEWMA-scored),
# naming the replica — and `"lifecycle"` events — one line per
# serving-request phase transition (submit -> queued -> admitted ->
# prefill chunk k -> decoding -> preempted -> requeued -> finished)
# that `report.request_timeline` reconstructs into per-request
# timelines; span lines additionally allow ph "M" (Chrome metadata:
# the named per-request trace tracks); 9 = v8 plus the fast-decode
# extension (round 14, speculative decoding in `serving/engine.py`):
# "request" lines may carry the per-request speculation record
# (spec_drafted / spec_accepted), "generate" tick lines grow typed
# serving + speculation fields (queue_depth, active_slots,
# free_blocks, blocks_touched, bytes_per_tick, hbm_gbps, spec_drafted,
# spec_accepted, spec_accept_rate — the acceptance-rate telemetry the
# monitor surfaces at /status.json), and "ledger" lines allow the
# `table_rebucket` stamp's width/prev_width/tick fields (a request's
# block table crossing a geometric width bucket re-traces the decode
# tick; the stamp keeps attribution from booking it as unexplained).
# 10 = v9 plus the fleet-serving extension (round 15, the router —
# `shallowspeed_tpu/serving/router.py` + `router.py`): "route" events
# (one per dispatch: request id -> replica, with the admission score),
# "failover" events (one per seeded idempotent re-dispatch after a
# replica death / progress timeout: from/to replicas, reason, tokens
# already emitted), "scale" events (autoscale decisions: action
# up/drain/down, replica, reason, the burn that triggered), `replica`
# + `state` fields on "ledger" lines (per-replica restart_downtime
# stamps the fleet MTTR/availability reduction reads; circuit-breaker
# open/half_open/closed transitions), `replica`/`failovers` on the
# router's fleet-edge "request" records, and `resumed` on "lifecycle"
# submit lines (a continuation re-prefilled from another engine).
# 11 = v10 plus the distributed-tracing extension (round 16,
# `telemetry/tracing.py`): every metrics line may carry `mono` — the
# monotonic half of a per-process (wall, monotonic) clock pair the
# cross-process stitcher uses to fit one offset per process stanza —
# and the trace-context fields ride the request-path events: `trace`
# (one id per fleet request, minted by `Router.submit` or by
# `ServingEngine.submit` for standalone serving), `span` (this
# process's span id for the request / dispatch attempt), `parent`
# (the upstream span id), and `attempt` (0-based cross-engine
# dispatch attempt — a failover re-dispatch increments it, which is
# what lets `report.request_timeline` key its reduction on
# (rid, attempt) instead of interleaving two attempts' seq counters).
# "route"/"failover" events additionally carry the dispatch span they
# minted plus the router's pre-POST `dispatch_wall`/`dispatch_mono`
# clock pair (the stamp that happens-before the replica's lifecycle
# "submit" — the skew fit's lower bound); "route" grows `wait_ms`
# (router submit -> dispatch) so the stitcher can recover the
# fleet-edge submit time.
# 12 = v11 plus the continuous-profiling extension (round 17,
# `telemetry/profiler.py`): `"profile"` events — periodic CUMULATIVE
# snapshots of the host sampling profiler (folded-stack top-K counts
# + an exact `other` remainder, the span-tagged `phases` breakdown,
# `step_samples` for the attrib_host_frac cross-check, `max_gap_ms`
# the sampler-liveness bound) that merge across replicas like the v7
# sketch snapshots: the LAST event per process stanza is that
# stanza's whole story, and `python -m shallowspeed_tpu_torch.telemetry
# --profile <log> --out flame.json` reduces them to a flamegraph.
# 13 = v12 plus the numerics-observatory extension (round 18,
# `telemetry/numerics.py` + the fp8 numerics pack): `num_*` step
# fields — per-step worst clamp fractions (num_overflow_max /
# num_underflow_max), the live delayed-scale extrema (num_scale_min /
# num_amax_max), the RobustEWMA scale-drift z and sign-flip
# oscillation score (num_drift_z / num_osc), the latest shadow-parity
# sample vs the frozen master-precision oracle (num_parity_loss_rel /
# num_parity_grad_relmax) with its cumulative sample count
# (num_shadow_total), the live compute precision (num_precision:
# "fp8" | "bf16" — flips when the guard takes the bf16 fallback), and
# num_verdicts (the drained scale_collapse / parity_drift window,
# mirroring health_verdicts); "ledger" lines allow the
# `shadow_parity` kind's seconds (goodput-excluded oracle steps).
# 14 = v13 plus the prefix-caching extension (round 19,
# `serving/cache.PrefixIndex` + sticky routing): "request" lines grow
# `prefix_hit_blocks` (shared blocks mapped from the index across the
# request's admission stints) and `prefill_skipped_tokens` (prefill
# work those mappings avoided); "lifecycle" lines allow the
# `prefill_cached` phase (with `blocks` = matched block count) so
# `report.request_timeline` books the skipped prefill explicitly;
# "generate" tick lines grow the `prefix_hit_rate` / `cold_blocks` /
# `prefix_blocks` gauges /status.json + /metrics + the fleet view
# surface; "route" lines may carry the sticky `affinity` bonus.
# 15 = v14 plus the memory-observatory extension (round 20,
# `telemetry/memory.py`): "step" lines may carry the per-owner HBM
# decomposition (`hbm_owned_mib`: registry-owner name -> resident MiB,
# `hbm_untracked_mib`: the unclaimed residual — the leak alarm), the
# host-side series (`host_rss_mib`), and `mem_verdicts` (the drained
# MemoryWatch mem_leak / mem_drift window, mirroring health_verdicts);
# "generate" tick lines grow the capacity-plane gauges (`live_blocks`,
# `blocks_needed` — blocks required to finish every admitted request
# at its max-token budget — and `headroom_blocks` = free + cold -
# still-needed, negative when the replica is overcommitted); "ledger"
# lines allow the `oom` stamp's typed OutOfBlocks payload (requested /
# free / cold / live block counts + the requester `id`) written at
# every recovered block-exhaustion event.
# The validator accepts ALL dialects — every versioned field is
# optional, so committed v1-v14 artifacts (no version stamp / no
# health / overlap / attrib / wall / fault / request / monitor /
# straggler / lifecycle / speculation / routing / tracing / profile /
# numerics / prefix / memory fields) keep validating unchanged.
SCHEMA_VERSION = 15

_NUM = (int, float)

# metrics dialect: per-event required fields and their types
_METRIC_EVENTS = {
    "run_start": {},
    "epoch": {"epoch": int, "epoch_seconds": _NUM},
    "final": {"accuracy": _NUM, "total_seconds": _NUM},
    "step": {"step": int, "loss": _NUM, "tokens_per_sec": _NUM},
    "val": {"step": int, "val_loss": _NUM},
    "moe_router": {"step": int, "drop_fraction": _NUM},
    "bubble": {"bubble_static": _NUM},
    "telemetry": {},
    "health": {"step": int},   # HealthMonitor verdict/summary lines
    # schema v4: goodput-ledger lines (telemetry/goodput.py) — stamped
    # by metrics.StepRates pauses, the drivers, and the elastic
    # supervisor (restart downtime), all into the same JSONL
    "ledger": {"kind": str},
    # schema v4: decode throughput + HBM-roofline line (models/
    # generate.decode_report via the LM driver)
    "generate": {"tokens_per_sec": _NUM},
    # schema v5: chaos fault-injection stamps (shallowspeed_tpu/
    # chaos.py) — the forensic record of what was injected when,
    # fsync'd into the same JSONL the step lines live in
    "fault": {"kind": str},
    # schema v6: one line per COMPLETED serving request
    # (serving/engine.ServingEngine._finish) — the per-request SLO
    # record the --goodput reducer turns into ttft/tpot percentiles
    "request": {"id": str, "ttft_ms": _NUM, "tokens_in": int,
                "tokens_out": int},
    # schema v7: periodic streaming-sketch snapshot (telemetry/
    # monitor.Monitor) — per-metric log-bucketed histograms,
    # mergeable across processes into whole-run quantiles
    "monitor": {"sketches": dict},
    # schema v7: SLO burn-rate state transition (fire / escalate /
    # resolve) from the --slo evaluator
    "alert": {"slo": str, "state": str},
    # schema v8: a FleetCollector's straggler verdict — one replica's
    # per-metric quantile sustained a divergence from the fleet median
    # (telemetry/fleet.py); `state` is "firing" or "resolved"
    "straggler": {"replica": str, "metric": str, "state": str},
    # schema v8: one line per serving-request phase transition
    # (serving/engine.ServingEngine._lifecycle) — the per-request span
    # timeline `report.request_timeline` reconstructs
    "lifecycle": {"id": str, "phase": str},
    # schema v10: one line per router dispatch decision — which
    # replica got the request (serving/router.Router._dispatch)
    "route": {"id": str, "replica": str},
    # schema v10: one line per seeded idempotent re-dispatch — a
    # request whose replica died (or stalled past the progress
    # timeout) continuing, token-identically, elsewhere
    "failover": {"id": str, "replica": str, "reason": str},
    # schema v10: one line per autoscale decision (up / drain / down)
    "scale": {"action": str},
    # schema v12: periodic cumulative host-profiler snapshot
    # (telemetry/profiler.SamplingProfiler) — folded-stack counts +
    # span-tagged phase buckets, mergeable across replicas
    "profile": {"samples": int},
}

# optional typed fields on a "ledger" line (`fail_class`: the
# supervisor's failure classification riding its restart stamps;
# width/prev_width/tick: the v9 `table_rebucket` retrace stamp;
# replica/state: the v10 router stamps — per-replica restart downtime
# and circuit-breaker transitions)
_LEDGER_OPTIONAL = {"seconds": _NUM, "count": int, "fail_class": str,
                    "width": int, "prev_width": int, "tick": int,
                    "replica": str, "state": str,
                    # v15: the `oom` stamp — a recovered OutOfBlocks'
                    # typed payload (allocator counts at the raise; the
                    # requester rid rides as `id`)
                    "requested": int, "free": int, "cold": int,
                    "live": int, "id": str}

# optional typed fields on a "fault" line
_FAULT_OPTIONAL = {"step": int, "save": int, "seconds": _NUM,
                   "leaf": int, "fault_id": str, "point": str,
                   "path": str, "mode": str}

# optional typed fields on a "request" line (schema v6; spec_* are the
# v9 speculative-decoding record). tpot_ms is absent (not null) for
# single-token generations — there is no inter-token interval to
# average
_REQUEST_OPTIONAL = {"tpot_ms": _NUM, "e2e_ms": _NUM, "wait_ms": _NUM,
                     "queue_depth": int, "preempted": int,
                     "spec_drafted": int, "spec_accepted": int,
                     # v10: the router's fleet-edge request records
                     "replica": str, "failovers": int,
                     # v11: trace context (telemetry/tracing.py)
                     "trace": str, "span": str, "attempt": int,
                     # v14: prefix-cache record (serving/cache)
                     "prefix_hit_blocks": int,
                     "prefill_skipped_tokens": int}

# optional typed fields on a "generate" line (schema v9: the serving
# tick fields written since v6 become typed, plus the speculation
# window tallies — spec_accept_rate is what /status.json surfaces)
_GENERATE_OPTIONAL = {"queue_depth": int, "active_slots": int,
                      "free_blocks": int, "blocks_touched": int,
                      "bytes_per_tick": int, "hbm_gbps": _NUM,
                      "spec_drafted": int, "spec_accepted": int,
                      "spec_accept_rate": _NUM,
                      # v14: prefix-cache window gauges
                      "prefix_hit_rate": _NUM, "cold_blocks": int,
                      "prefix_blocks": int,
                      # v15: capacity-plane gauges (memory
                      # observatory) — headroom_blocks goes NEGATIVE
                      # when admitted max-token budgets overcommit the
                      # pool, which is the shed-before-evict signal
                      "live_blocks": int, "blocks_needed": int,
                      "headroom_blocks": int}

# optional typed fields on the schema-v7 events
_MONITOR_OPTIONAL = {"counters": dict, "rel_err": _NUM}
_ALERT_OPTIONAL = {"severity": str, "metric": str, "burn_fast": _NUM,
                   "burn_slow": _NUM, "value": _NUM,
                   "threshold": _NUM, "step": int}

# optional typed fields on the schema-v8 events
_STRAGGLER_OPTIONAL = {"ratio": _NUM, "z": _NUM, "replica_q": _NUM,
                       "fleet_q": _NUM, "q": int, "rounds": int}
_LIFECYCLE_OPTIONAL = {"seq": int, "slot": int, "tick": int,
                       "chunk": int, "tokens": int, "prev": str,
                       "ms_in_prev": _NUM, "resumed": int,
                       # v11: trace context — one trace id per fleet
                       # request, one span per engine attempt, parent
                       # = the router's dispatch span, attempt = the
                       # 0-based cross-engine dispatch counter
                       "trace": str, "span": str, "parent": str,
                       "attempt": int,
                       # v14: `prefill_cached` phase payload — shared
                       # blocks mapped from the prefix index at admit
                       "blocks": int}

# optional typed fields on the schema-v10 routing events (trace/span/
# parent + route wait_ms are the v11 tracing extension;
# dispatch_wall/dispatch_mono are the router's PRE-POST clock pair —
# the only router stamp that happens-before the replica's lifecycle
# "submit", which the stitcher's skew fit uses as its lower bound)
_ROUTE_OPTIONAL = {"queue_depth": int, "score": _NUM,
                   "trace": str, "span": str, "parent": str,
                   "wait_ms": _NUM,
                   "dispatch_wall": _NUM, "dispatch_mono": _NUM,
                   # v14: the sticky prefix-affinity bonus folded into
                   # this dispatch's ranking (0.0 = no locality)
                   "affinity": _NUM}
_FAILOVER_OPTIONAL = {"from": str, "tokens_done": int, "attempt": int,
                      "trace": str, "span": str, "parent": str,
                      "dispatch_wall": _NUM, "dispatch_mono": _NUM}
_SCALE_OPTIONAL = {"replica": str, "reason": str, "n_replicas": int,
                   "burn": _NUM}

# optional typed fields on the schema-v12 "profile" snapshot:
# `folded` maps "frame;frame;..." strings to exact sample counts
# (top-K; `other` is the exact remainder so counts still sum to
# `samples`), `phases` maps innermost span-tag names to counts,
# `step_samples` counts samples inside a step/batch span (the
# attrib_host_frac cross-check), `max_gap_ms` is the worst
# inter-sample gap (the GIL-safety bound the tests pin)
_PROFILE_OPTIONAL = {"step_samples": int, "hz": _NUM, "top_k": int,
                     "folded": dict, "other": int, "phases": dict,
                     "max_gap_ms": _NUM, "window_s": _NUM,
                     "mode": str, "captures": list}

# telemetry fields a step line MAY carry; when present they must type
_STEP_TELEMETRY = {
    "compiles": int, "recompiles": int,
    "hbm_live_mib": _NUM, "hbm_static_mib": _NUM,
    "hbm_alloc_peak_mib": _NUM, "hbm_within_bound": bool,
    "coll_bytes_per_step": int, "coll_bytes_by_axis": dict,
    "coll_bytes_measured": dict,
    "coll_gbps": _NUM, "bubble_static": _NUM, "bubble_measured": _NUM,
    # --- schema v2: training-health fields (telemetry/health.py)
    "health_grad_norm": _NUM, "health_param_norm": _NUM,
    "health_update_ratio": _NUM, "health_nonfinite": int,
    "health_skipped_total": int, "health_verdicts": list,
    "health_groups": dict,
    # --- schema v3: comm/compute-overlap fields (parallel/overlap.py)
    "exposed_comm_frac": _NUM, "overlap_ratio": _NUM, "overlap": bool,
    # --- schema v4: time-attribution waterfall (telemetry/
    # attribution.py) — fractions of the measured (fenced) step time
    "attrib_compute_frac": _NUM, "attrib_mxu_frac": _NUM,
    "attrib_comm_exposed_frac": _NUM, "attrib_bubble_frac": _NUM,
    "attrib_host_frac": _NUM, "attrib_unexplained_frac": _NUM,
    "attrib_t_step_ms": _NUM, "attrib_rates_source": str,
    "attrib_compute_scale": _NUM,
    # --- schema v13: numerics-observatory fields (telemetry/
    # numerics.py) — the fp8 pack's host-side reduction + the
    # shadow-parity series vs the frozen master-precision oracle
    "num_overflow_max": _NUM, "num_underflow_max": _NUM,
    "num_scale_min": _NUM, "num_amax_max": _NUM,
    "num_drift_z": _NUM, "num_osc": _NUM,
    "num_parity_loss_rel": _NUM, "num_parity_grad_relmax": _NUM,
    "num_shadow_total": int, "num_precision": str,
    "num_verdicts": list,
    # --- schema v15: memory-observatory fields (telemetry/memory.py)
    # — the per-owner HBM decomposition (owner name -> resident MiB),
    # the unclaimed residual, host RSS, and the drained MemoryWatch
    # verdict window
    "hbm_owned_mib": dict, "hbm_untracked_mib": _NUM,
    "host_rss_mib": _NUM, "mem_verdicts": list,
}

# "M" (schema v8): Chrome metadata events — the named per-request
# lifecycle tracks (thread_name) the serving engine emits
_SPAN_PH = {"X", "i", "C", "M"}


def validate_line(rec: dict) -> list[str]:
    """Problems with one parsed JSONL record (empty list = valid)."""
    if not isinstance(rec, dict):
        return ["line is not a JSON object"]
    if "event" in rec:
        return _validate_metric(rec)
    if "ph" in rec or "name" in rec:
        return _validate_span(rec)
    return ["neither a metrics line ('event') nor a span line ('ph')"]


def _validate_metric(rec: dict) -> list[str]:
    probs = []
    ev = rec["event"]
    if ev not in _METRIC_EVENTS:
        return [f"unknown metrics event {ev!r}"]
    if ev == "run_start" and "schema_version" in rec \
            and (not isinstance(rec["schema_version"], int)
                 or isinstance(rec["schema_version"], bool)
                 or rec["schema_version"] < 1):
        probs.append("run_start: schema_version must be a positive int")
    for field, typ in _METRIC_EVENTS[ev].items():
        if field not in rec:
            probs.append(f"{ev}: missing field {field!r}")
        elif not isinstance(rec[field], typ) \
                or isinstance(rec[field], bool):
            probs.append(f"{ev}: field {field!r} is "
                         f"{type(rec[field]).__name__}, want {typ}")
    if ev == "step":
        for field, typ in _STEP_TELEMETRY.items():
            if field in rec and rec[field] is not None \
                    and not isinstance(rec[field], typ):
                probs.append(f"step: telemetry field {field!r} is "
                             f"{type(rec[field]).__name__}")
    if ev == "ledger":
        for field, typ in _LEDGER_OPTIONAL.items():
            if field in rec and (not isinstance(rec[field], typ)
                                 or isinstance(rec[field], bool)):
                probs.append(f"ledger: field {field!r} is "
                             f"{type(rec[field]).__name__}")
    if ev == "fault":
        for field, typ in _FAULT_OPTIONAL.items():
            if field in rec and (not isinstance(rec[field], typ)
                                 or isinstance(rec[field], bool)):
                probs.append(f"fault: field {field!r} is "
                             f"{type(rec[field]).__name__}")
    if ev == "request":
        for field, typ in _REQUEST_OPTIONAL.items():
            if field in rec and (not isinstance(rec[field], typ)
                                 or isinstance(rec[field], bool)):
                probs.append(f"request: field {field!r} is "
                             f"{type(rec[field]).__name__}")
    if ev == "generate":
        for field, typ in _GENERATE_OPTIONAL.items():
            if field in rec and (not isinstance(rec[field], typ)
                                 or isinstance(rec[field], bool)):
                probs.append(f"generate: field {field!r} is "
                             f"{type(rec[field]).__name__}")
    if ev in ("monitor", "alert", "straggler", "lifecycle", "route",
              "failover", "scale", "profile"):
        opt = {"monitor": _MONITOR_OPTIONAL, "alert": _ALERT_OPTIONAL,
               "straggler": _STRAGGLER_OPTIONAL,
               "lifecycle": _LIFECYCLE_OPTIONAL,
               "route": _ROUTE_OPTIONAL,
               "failover": _FAILOVER_OPTIONAL,
               "scale": _SCALE_OPTIONAL,
               "profile": _PROFILE_OPTIONAL}[ev]
        for field, typ in opt.items():
            if field in rec and (not isinstance(rec[field], typ)
                                 or isinstance(rec[field], bool)):
                probs.append(f"{ev}: field {field!r} is "
                             f"{type(rec[field]).__name__}")
    # schema v4: any metrics line may carry an absolute `wall` stamp
    if "wall" in rec and not isinstance(rec["wall"], _NUM):
        probs.append("metrics: 'wall' is not numeric")
    # schema v11: ... and the monotonic half of the clock pair
    if "mono" in rec and not isinstance(rec["mono"], _NUM):
        probs.append("metrics: 'mono' is not numeric")
    return probs


def _validate_span(rec: dict) -> list[str]:
    probs = []
    if "name" not in rec or not isinstance(rec["name"], str):
        probs.append("span: missing/non-string 'name'")
    ph = rec.get("ph")
    if ph not in _SPAN_PH:
        probs.append(f"span: ph {ph!r} not in {sorted(_SPAN_PH)}")
    if not isinstance(rec.get("ts"), _NUM):
        probs.append("span: missing/non-numeric 'ts'")
    if ph == "X" and not isinstance(rec.get("dur"), _NUM):
        probs.append("span: 'X' event without numeric 'dur'")
    if "args" in rec and not isinstance(rec["args"], dict):
        probs.append("span: 'args' is not an object")
    return probs


def parse_metrics_jsonl(path) -> list[dict]:
    """Read one metrics JSONL tolerantly: skip blank lines and
    unparseable JSON (a torn tail mid-write), keep only dicts carrying
    an "event" key — the one line-level dialect every offline reducer
    (goodput, the trace stitcher) consumes. Shared here so hardening
    lands in both."""
    out = []
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and "event" in rec:
            out.append(rec)
    return out


def validate_file(path) -> list[str]:
    """All problems in one JSONL file, prefixed path:lineno."""
    path = Path(path)
    out = []
    for i, line in enumerate(path.read_text().splitlines(), 1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            out.append(f"{path}:{i}: not JSON ({e.msg})")
            continue
        out.extend(f"{path}:{i}: {p}" for p in validate_line(rec))
    return out
