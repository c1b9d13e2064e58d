"""Run-level goodput ledger — where every wall-clock second went.

A copy of `shallowspeed_tpu/telemetry/goodput.py` (pure Python over
the port's own `schema`, `tracing`, `report`, `profiler` and `sketch`;
the port keeps its own copy rather than import the JAX package). The
reducer reads either package's metrics JSONL.

The `compile` loss is derived as the reference derives it: the first
window's excess over the steady step rate. In the port that excess is
not an XLA compile: it is the first use's `nvcc` build of the
hand-written kernels (unless `csrc/_build/` already holds them), the
cuBLAS handles' creation and the CUDA caching allocator's growth. No
compile or recompile count is invented for it: an eager port compiles
no executables, so `recompiles` stays 0 unless a line stamps one.

`metrics.StepRates` answers *how fast were the steps*; this module
answers *how much of the run was steps at all*. The ledger is a stream
of `{"event": "ledger", "kind": ..., "seconds"/"count": ...}` lines in
the SAME metrics JSONL the step lines live in — so it survives process
death, spans supervisor restarts (`elastic.py` stamps restart downtime
into the same file), and a single reducer (`run_goodput`) can replay
the whole history into

    goodput = productive-step-time / wall-clock

with a named loss breakdown: init, checkpoint restore/save, validation
pauses, data-prefetch stalls, guarded skipped steps, compile (derived
from the first window's excess over the steady step rate),
replayed-from-checkpoint steps (derived from step numbers that re-run
after a restart), and restart downtime (measured from the wall gap
between one process's last line and the next's run_start); recompile
counts are itemized alongside.

Two classes of ledger kind:

- **excluded** kinds are pauses `StepRates` removes from its
  throughput windows (val, ckpt_save, restore, init, telemetry,
  calibration). Because every `StepRates.pause(seconds, kind=...)`
  call also stamps the ledger, window-sum + excluded-ledger-seconds ==
  wall clock BY CONSTRUCTION — the step-rate windows and the ledger
  can never disagree (pinned by tests/test_goodput.py).
- **in-window** kinds annotate time that stays inside the windows but
  is not productive (data_stall seconds; skipped_steps counts, priced
  at the steady per-step rate by the reducer; recompiles counts,
  itemized — their wall cost already shows in the step rate).

Schema v5: the supervisor's restart stamps carry the
failure class it diagnosed (crash / hang / numeric / corrupt_ckpt),
and the reducer folds them into per-class **MTTR** (mean
detection-to-respawn seconds) plus run **availability**
(1 - downtime/wall); injected chaos faults (`"fault"` events,
the reference's chaos.py) are tallied alongside so a drill's report
names what was injected next to what it cost.
"""

from __future__ import annotations

import json

# Pause kinds StepRates excludes from its throughput windows. Anything
# else noted with seconds is treated as an in-window loss.
# `shadow_parity` (schema v13) is the numerics observatory's frozen
# master-precision oracle step — diagnostic compute, not training, so
# its seconds are itemized as a named loss rather than counted
# productive.
EXCLUDED_KINDS = ("init", "restore", "val", "ckpt_save", "telemetry",
                  "calibration", "pause", "shadow_parity")


class GoodputLedger:
    """Stamps ledger events into a MetricsLogger (or just accumulates
    in-process totals when `metrics` is None)."""

    def __init__(self, metrics=None):
        self.metrics = metrics
        self._seconds: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    def note(self, kind: str, seconds: float | None = None,
             count: int | None = None, **extra) -> None:
        fields: dict = {}
        if seconds is not None:
            self._seconds[kind] = (self._seconds.get(kind, 0.0)
                                   + float(seconds))
            fields["seconds"] = round(float(seconds), 6)
        if count is not None:
            self._counts[kind] = self._counts.get(kind, 0) + int(count)
            fields["count"] = int(count)
        if self.metrics is not None:
            self.metrics.log(event="ledger", kind=kind, **fields,
                             **extra)

    def seconds(self) -> dict:
        return dict(self._seconds)

    def counts(self) -> dict:
        return dict(self._counts)

    def excluded_seconds(self) -> float:
        return sum(v for k, v in self._seconds.items()
                   if k in EXCLUDED_KINDS)


def stamp_ledger_line(path, kind: str, **fields) -> None:
    """Append one ledger line to a metrics JSONL from OUTSIDE the
    training process (the elastic supervisor's restart stamps). Best
    effort — a supervisor must never die on a full disk."""
    import time

    rec = {"event": "ledger", "kind": kind,
           "wall": round(time.time(), 3), **fields}
    try:
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        pass


# ------------------------------------------------------------ reducer


def _parse(path) -> list[dict]:
    from shallowspeed_tpu_torch.telemetry.schema import parse_metrics_jsonl

    return parse_metrics_jsonl(path)


def _wall(rec, stanza_start_wall) -> float | None:
    if isinstance(rec.get("wall"), (int, float)):
        return float(rec["wall"])
    if stanza_start_wall is not None and isinstance(rec.get("t"),
                                                   (int, float)):
        return stanza_start_wall + float(rec["t"])
    return None


def run_goodput(path, extra_paths=()) -> dict:
    """Reduce one metrics JSONL (one run, possibly spanning supervisor
    restarts) to the goodput report. Returns

        {"wall_clock_s", "productive_s", "goodput", "accounted_frac",
         "losses": {kind: seconds}, "counts": {...}, "per_step_s",
         "stanzas"}

    `accounted_frac` = (productive + sum(losses)) / wall_clock — the
    acceptance bar is >= 0.95 on a kill/resume run; anything below
    that means time went somewhere the ledger has no name for.

    `extra_paths` (schema v11): additional per-process JSONLs — a
    router log's replica files — joined BY TRACE ID into the
    ``tracing`` block (per-request latency waterfalls, p50/p95 per
    component, worst-``rq_unexplained`` exemplars); the wall-clock /
    ledger reduction above stays scoped to the primary file.
    """
    recs = _parse(path)
    # split into stanzas at run_start lines
    stanzas: list[dict] = []
    for rec in recs:
        if rec["event"] == "run_start" or not stanzas:
            stanzas.append({"start": rec if rec["event"] == "run_start"
                            else None, "lines": []})
        stanzas[-1]["lines"].append(rec)
    losses: dict[str, float] = {}
    counts: dict[str, int] = {"restarts": max(0, len(stanzas) - 1),
                              "replayed_steps": 0, "skipped_steps": 0,
                              "recompiles": 0}
    # MTTR per failure class (schema v5): the supervisor's
    # restart_downtime stamps each carry the class it diagnosed and
    # the detection-to-respawn seconds it measured directly — reduce
    # them to count/total/mean per class. Fault-injection stamps are
    # tallied alongside so a chaos drill's report names what was
    # injected next to what it cost.
    mttr: dict[str, dict] = {}
    faults: dict[str, int] = {}
    # schema v6: serving request-completion stamps reduce to the SLO
    # percentiles (p50/p95 ttft and tpot) — a serving run's metrics
    # JSONL answers "how fast were the requests" through the same
    # reducer that answers "where did the wall clock go"
    request_recs = [r for r in recs if r.get("event") == "request"]
    for rec in recs:
        if rec.get("event") == "fault" and isinstance(rec.get("kind"),
                                                      str):
            faults[rec["kind"]] = faults.get(rec["kind"], 0) + 1
        if rec.get("event") != "ledger":
            continue
        if rec.get("kind") in ("restart_downtime", "poison_step_abort",
                               "supervisor_abort") \
                and isinstance(rec.get("fail_class"), str):
            cls = rec["fail_class"]
            m = mttr.setdefault(cls, {"count": 0, "total_s": 0.0})
            if rec.get("kind") == "restart_downtime":
                m["count"] += 1
                if isinstance(rec.get("seconds"), (int, float)):
                    m["total_s"] += float(rec["seconds"])
            else:
                m[rec["kind"]] = m.get(rec["kind"], 0) + 1
    for m in mttr.values():
        m["total_s"] = round(m["total_s"], 3)
        m["mttr_s"] = (round(m["total_s"] / m["count"], 3)
                       if m["count"] else None)

    def add_loss(kind, secs):
        if secs > 0:
            losses[kind] = losses.get(kind, 0.0) + secs

    # pass 1: walls, step lines, ledger events, per-step rate samples
    rate_samples: list[float] = []
    for st in stanzas:
        start = st["start"] or {}
        st["w0"] = _wall(start, None) if st["start"] else None
        walls = [w for w in (_wall(r, st["w0"]) for r in st["lines"])
                 if w is not None]
        st["first_wall"] = walls[0] if walls else None
        # the crash-gap measurement wants the last line the CHILD
        # wrote ("t" is the process-relative stamp only the child's
        # MetricsLogger adds); a supervisor restart stamp appended
        # after the child died must not shrink the measured downtime
        child_walls = [w for r, w in
                       zip(st["lines"],
                           (_wall(r, st["w0"]) for r in st["lines"]))
                       if w is not None and "t" in r]
        st["last_wall"] = (child_walls[-1] if child_walls
                           else walls[-1] if walls else None)
        st["steps"] = [(r["step"], _wall(r, st["w0"]))
                       for r in st["lines"] if r["event"] == "step"]
        st["ledger"] = [(r.get("kind", "?"), r, _wall(r, st["w0"]))
                        for r in st["lines"] if r["event"] == "ledger"]
        st["start_step"] = int(start.get("start_step", 0) or 0)
        # excluded pause seconds between two walls (for window math)
        ex = [(w, float(r.get("seconds", 0.0)))
              for k, r, w in st["ledger"]
              if k in EXCLUDED_KINDS and w is not None]

        def pauses_between(lo, hi, ex=ex):
            return sum(s for w, s in ex if lo < w <= hi)

        st["pauses_between"] = pauses_between
        for (s1, w1), (s2, w2) in zip(st["steps"], st["steps"][1:]):
            if w1 is None or w2 is None or s2 <= s1:
                continue
            rate_samples.append(
                max(0.0, w2 - w1 - pauses_between(w1, w2)) / (s2 - s1))
    per_step = (float(sorted(rate_samples)[len(rate_samples) // 2])
                if rate_samples else None)

    # pass 2: productive time, compile excess, replay, ledger losses
    productive = 0.0
    high_water = -1
    for i, st in enumerate(stanzas):
        for kind, rec, _w in st["ledger"]:
            secs = rec.get("seconds")
            if isinstance(secs, (int, float)):
                # downtime is re-measured from the wall gap below; the
                # supervisor's own stamp is kept as a cross-check total
                if kind != "restart_downtime":
                    add_loss(kind, float(secs))
            cnt = rec.get("count")
            if isinstance(cnt, (int, float)) and kind in counts:
                counts[kind] += int(cnt)
            elif isinstance(cnt, (int, float)):
                counts[kind] = counts.get(kind, 0) + int(cnt)
        if not st["steps"]:
            high_water = max(high_water, st["start_step"] - 1)
            continue
        s_first, w_first = st["steps"][0]
        s_last, w_last = st["steps"][-1]
        r0 = st["start_step"]
        # steady stepping time between the stanza's step lines
        stepping = 0.0
        if w_first is not None and w_last is not None:
            stepping = max(0.0, w_last - w_first
                           - st["pauses_between"](w_first, w_last))
        # the first segment: run_start -> first step line holds init/
        # restore (itemized above), the steps up to s_first, and the
        # compile excess
        steps_first = max(0, s_first - r0 + 1)
        if per_step is not None and st["first_wall"] is not None \
                and w_first is not None:
            seg = max(0.0, w_first - st["first_wall"]
                      - st["pauses_between"](st["first_wall"], w_first))
            expected = steps_first * per_step
            add_loss("compile", max(0.0, seg - expected))
            stepping += min(seg, expected)
        # replayed steps: work re-run below the previous high-water
        if i > 0 and per_step is not None:
            replayed = max(0, min(high_water, s_last) - r0 + 1)
            counts["replayed_steps"] += replayed
            replay_s = min(replayed * per_step, stepping)
            add_loss("replay", replay_s)
            stepping -= replay_s
        high_water = max(high_water, s_last)
        productive += stepping
        # crash gap to the next stanza = restart downtime (measured)
        nxt = stanzas[i + 1] if i + 1 < len(stanzas) else None
        if nxt is not None and st["last_wall"] is not None \
                and nxt["first_wall"] is not None:
            add_loss("restart_downtime",
                     max(0.0, nxt["first_wall"] - st["last_wall"]))
    # in-window annotated losses come out of productive time
    for kind in ("data_stall",):
        productive -= min(productive, losses.get(kind, 0.0))
    if per_step is not None and counts.get("skipped_steps"):
        skip_s = counts["skipped_steps"] * per_step
        add_loss("skipped_steps", min(skip_s, productive))
        productive -= min(skip_s, productive)

    first = next((s["first_wall"] for s in stanzas
                  if s["first_wall"] is not None), None)
    last = next((s["last_wall"] for s in reversed(stanzas)
                 if s["last_wall"] is not None), None)
    wall = (last - first) if first is not None and last is not None \
        else 0.0
    accounted = productive + sum(losses.values())
    downtime = losses.get("restart_downtime", 0.0)
    return {
        "wall_clock_s": round(wall, 3),
        "productive_s": round(productive, 3),
        "goodput": round(productive / wall, 4) if wall > 0 else None,
        # availability = the run was UP (stepping or pausing inside a
        # live process), as opposed to down between a failure and its
        # recovered successor — the SLA-shaped number MTTR feeds
        "availability": (round(1.0 - min(wall, downtime) / wall, 4)
                         if wall > 0 else None),
        "accounted_frac": (round(min(1.0, accounted / wall), 4)
                           if wall > 0 else None),
        "losses": {k: round(v, 3) for k, v in sorted(losses.items())},
        "counts": counts,
        "mttr": mttr,
        "faults": faults,
        "per_step_s": (round(per_step, 6) if per_step is not None
                       else None),
        "stanzas": len(stanzas),
        # None for training runs (no request events) — the serving
        # block appears only when the JSONL carries schema-v6 stamps
        "requests": _request_block(request_recs),
        # None without schema-v7 monitor snapshots — the merged
        # streaming-sketch quantiles, cross-checked against the exact
        # offline percentiles above (same rank rule; they may differ
        # only by the sketch's recorded rel_err)
        "monitor": _monitor_block(stanzas, request_recs),
        # None without schema-v12 profile snapshots — the host
        # sampling profiler's story: where HOST time went, by tagged
        # phase and hottest frames (last snapshot per stanza, merged
        # labelled across restarts like the monitor sketches)
        "profiling": _profiling_block(stanzas),
        # None without schema-v8 lifecycle events — aggregate
        # per-phase request time (where did request latency go:
        # queued vs prefill vs decoding vs preempted)
        "lifecycle": _lifecycle_block(recs),
        # None without schema-v10 routing events — the fleet block: a
        # ROUTER's log reduces to per-replica MTTR, fleet
        # availability, failover/breaker/scale tallies (the router
        # process itself never restarts, so the per-replica
        # restart_downtime stamps — not stanza gaps — carry the
        # fleet's downtime story)
        "fleet": _fleet_block(recs, wall),
        # None without schema-v11 trace-context lifecycle events —
        # the per-request latency waterfalls, skew-corrected and
        # joined by trace id across this file + extra_paths
        # (telemetry/tracing.goodput_block; `recs` forwarded so the
        # primary log is parsed once, not twice)
        "tracing": _tracing_block([path, *extra_paths], recs),
        # None without schema-v13 num_* step fields — the numerics
        # observatory's run story: worst clamp fractions, the scale
        # floor, shadow-parity extremes, verdicts fired, and whether
        # the run ended on the bf16 fallback
        "numerics": _numerics_block(recs),
        # None without schema-v14 prefix-cache fields — the prefix
        # caching story: hit rate across requests, prefill tokens the
        # shared-block mappings skipped, and the last tick's cold-list
        # / index gauges
        "prefix": _prefix_block(recs, request_recs),
        # None without schema-v15 memory fields — the memory
        # observatory's run story: worst headroom the capacity plane
        # saw, recovered OOM events, the final per-owner
        # decomposition, and any leak/drift verdicts fired
        "memory": _memory_block(recs),
    }


def _prefix_block(recs, request_recs) -> dict | None:
    """Reduce schema-v14 prefix-cache fields: per-request
    `prefix_hit_blocks`/`prefill_skipped_tokens` tallies plus the last
    "generate" tick's `prefix_hit_rate`/`cold_blocks`/`prefix_blocks`
    gauges. None when the run never served with the prefix cache on."""
    reqs = [r for r in request_recs
            if isinstance(r.get("prefix_hit_blocks"), int)
            and not isinstance(r.get("prefix_hit_blocks"), bool)]
    gens = [r for r in recs if r.get("event") == "generate"
            and isinstance(r.get("prefix_hit_rate"), (int, float))]
    if not reqs and not gens:
        return None
    hits = sum(1 for r in reqs if r["prefix_hit_blocks"] > 0)
    skipped = sum(int(r.get("prefill_skipped_tokens") or 0)
                  for r in reqs)
    prefilled = sum(int(r.get("tokens_in") or 0) for r in reqs)
    out = {
        "requests_observed": len(reqs),
        "requests_hit": hits,
        "hit_rate": round(hits / len(reqs), 4) if reqs else None,
        "hit_blocks": sum(r["prefix_hit_blocks"] for r in reqs),
        "prefill_skipped_tokens": skipped,
        # what fraction of submitted prompt tokens never re-prefilled
        "skipped_frac": (round(skipped / prefilled, 4)
                         if prefilled > 0 else None),
    }
    if gens:
        last = gens[-1]
        out["cold_blocks"] = (int(last["cold_blocks"])
                              if isinstance(last.get("cold_blocks"), int)
                              else None)
        out["prefix_blocks"] = (int(last["prefix_blocks"])
                                if isinstance(last.get("prefix_blocks"),
                                              int) else None)
    return out


def _memory_block(recs) -> dict | None:
    """Reduce schema-v15 memory fields to the run's memory story:
    the capacity plane's worst (minimum) admission headroom across
    "generate" ticks, the recovered-OOM ledger tally, the last step's
    per-owner decomposition + untracked residual, peak host RSS, and
    every mem_leak/mem_drift verdict fired. None when the run carries
    no memory-observatory fields at all."""
    gens = [r for r in recs if r.get("event") == "generate"
            and isinstance(r.get("headroom_blocks"), int)
            and not isinstance(r.get("headroom_blocks"), bool)]
    ooms = [r for r in recs if r.get("event") == "ledger"
            and r.get("kind") == "oom"]
    steps = [r for r in recs if r.get("event") == "step"
             and ("hbm_owned_mib" in r or "host_rss_mib" in r
                  or "mem_verdicts" in r)]
    if not gens and not ooms and not steps:
        return None
    out: dict = {}
    if gens:
        worst = min(gens, key=lambda r: r["headroom_blocks"])
        out["worst_headroom_blocks"] = int(worst["headroom_blocks"])
        last = gens[-1]
        out["final_headroom_blocks"] = int(last["headroom_blocks"])
        if isinstance(last.get("live_blocks"), int):
            out["final_live_blocks"] = last["live_blocks"]
    if ooms:
        out["oom_events"] = len(ooms)
        worst_oom = max(ooms,
                        key=lambda r: int(r.get("requested") or 0))
        out["worst_oom"] = {
            k: worst_oom[k] for k in ("requested", "free", "cold",
                                      "live", "id", "tick")
            if k in worst_oom}
    if steps:
        last = steps[-1]
        if isinstance(last.get("hbm_owned_mib"), dict):
            out["owners_mib"] = last["hbm_owned_mib"]
        if isinstance(last.get("hbm_untracked_mib"), (int, float)):
            out["untracked_mib"] = last["hbm_untracked_mib"]
        rss = [r["host_rss_mib"] for r in steps
               if isinstance(r.get("host_rss_mib"), (int, float))]
        if rss:
            out["peak_host_rss_mib"] = round(max(rss), 2)
        verdicts = [v for r in steps
                    for v in (r.get("mem_verdicts") or [])]
        if verdicts:
            out["verdicts"] = [str(v) for v in verdicts]
    return out or None


def _numerics_block(recs) -> dict | None:
    """Reduce schema-v13 ``num_*`` step fields to the run's numerics
    story. Worst-case reductions on purpose: the question --goodput
    answers here is "did the quantized path ever misbehave", so a
    single bad step must survive the reduction."""
    steps = [r for r in recs if r.get("event") == "step"
             and ("num_scale_min" in r or "num_precision" in r)]
    if not steps:
        return None

    def worst(key, fn=max):
        vals = [r[key] for r in steps
                if isinstance(r.get(key), (int, float))]
        return fn(vals) if vals else None

    verdicts: dict[str, int] = {}
    for r in steps:
        for kind in (r.get("num_verdicts") or ()):
            if isinstance(kind, str):
                verdicts[kind] = verdicts.get(kind, 0) + 1
    shadow = worst("num_shadow_total")
    fellback = any(r.get("num_precision") == "bf16" for r in steps)
    return {
        "steps_observed": len(steps),
        "steps_fp8": sum(1 for r in steps
                         if r.get("num_precision") == "fp8"),
        "overflow_max": worst("num_overflow_max"),
        "underflow_max": worst("num_underflow_max"),
        "scale_min": worst("num_scale_min", min),
        "amax_max": worst("num_amax_max"),
        "parity_loss_rel_max": worst("num_parity_loss_rel"),
        "parity_grad_relmax_max": worst("num_parity_grad_relmax"),
        "shadow_samples": int(shadow) if shadow is not None else 0,
        "verdicts": verdicts,
        "final_precision": (str(steps[-1]["num_precision"])
                            if isinstance(steps[-1].get("num_precision"),
                                          str) else None),
        "fell_back_bf16": fellback,
    }


def _tracing_block(paths, first_recs) -> dict | None:
    from shallowspeed_tpu_torch.telemetry.tracing import goodput_block

    try:
        return goodput_block(paths, first_recs=first_recs)
    except OSError:
        return None


def _fleet_block(recs, wall: float) -> dict | None:
    """Reduce schema-v10 routing events + replica-stamped ledger lines
    to the fleet report: routes/failovers/scale decisions, breaker
    trips, per-replica MTTR (from the router's replica-labelled
    restart_downtime stamps), per-replica and mean fleet availability.
    A replica never seen down is fully available; the denominator is
    the router log's wall span (the router observed the whole fleet
    for that long)."""
    routes = fails = 0
    scale = {"up": 0, "drain": 0, "down": 0}
    trips = 0
    names: set[str] = set()
    mttr: dict[str, dict] = {}
    for rec in recs:
        ev = rec.get("event")
        if ev == "route":
            routes += 1
            names.add(str(rec.get("replica")))
        elif ev == "failover":
            fails += 1
            names.add(str(rec.get("replica")))
        elif ev == "scale":
            action = str(rec.get("action"))
            scale[action] = scale.get(action, 0) + 1
            if isinstance(rec.get("replica"), str):
                names.add(rec["replica"])
        elif ev == "ledger" and isinstance(rec.get("replica"), str):
            names.add(rec["replica"])
            if rec.get("kind") == "breaker" \
                    and rec.get("state") == "open":
                trips += 1
            if rec.get("kind") == "restart_downtime" \
                    and isinstance(rec.get("seconds"), (int, float)):
                m = mttr.setdefault(rec["replica"],
                                    {"count": 0, "total_s": 0.0})
                m["count"] += 1
                m["total_s"] += float(rec["seconds"])
    if not (routes or fails or any(scale.values())):
        return None
    names.discard("?")
    for m in mttr.values():
        m["total_s"] = round(m["total_s"], 3)
        m["mttr_s"] = round(m["total_s"] / m["count"], 3)
    avail = {}
    for name in sorted(names):
        down = mttr.get(name, {}).get("total_s", 0.0)
        avail[name] = (round(1.0 - min(down, wall) / wall, 4)
                       if wall > 0 else None)
    vals = [a for a in avail.values() if a is not None]
    return {
        "replicas": sorted(names),
        "routes": routes,
        "failovers": fails,
        "breaker_trips": trips,
        "scale": {k: v for k, v in scale.items() if v},
        "mttr": mttr,
        "availability": avail,
        "fleet_availability": (round(sum(vals) / len(vals), 4)
                               if vals else None),
    }


def _request_block(request_recs) -> dict | None:
    from shallowspeed_tpu_torch.telemetry.report import request_summary

    return request_summary(request_recs)


def _lifecycle_block(recs) -> dict | None:
    """Reduce schema-v8 lifecycle events to run-level phase
    accounting: total ms the fleet's requests spent in each phase —
    the 'which phase' half of the exemplar linkage (the fleet view
    names which request/replica; this names where its time went)."""
    if not any(r.get("event") == "lifecycle" for r in recs):
        return None
    from shallowspeed_tpu_torch.telemetry.report import request_timeline

    timelines = request_timeline(recs)
    by_phase: dict[str, float] = {}
    for tl in timelines.values():
        for phase, ms in tl["by_phase_ms"].items():
            by_phase[phase] = by_phase.get(phase, 0.0) + ms
    return {"requests": len(timelines),
            "complete": sum(1 for tl in timelines.values()
                            if tl["complete"]),
            "by_phase_ms": {k: round(v, 3)
                            for k, v in sorted(by_phase.items())}}


def _profiling_block(stanzas) -> dict | None:
    """Reduce schema-v12 ``"profile"`` events to the run's host-time
    story. Snapshots are cumulative, so the last per stanza is that
    process's total (the monitor-block convention); multiple stanzas
    merge replica/stanza-labelled via the profiler's own reducer."""
    last: dict[str, dict] = {}
    for k, st in enumerate(stanzas):
        snaps = [r for r in st["lines"] if r.get("event") == "profile"]
        if not snaps:
            continue
        label = next((r["replica"] for r in st["lines"]
                      if r.get("event") == "run_start"
                      and isinstance(r.get("replica"), str)), f"s{k}")
        if label in last:
            label = f"{label}#{k}"
        last[label] = snaps[-1]
    if not last:
        return None
    from shallowspeed_tpu_torch.telemetry.profiler import (OTHER_KEY,
                                                     merge_profiles)

    if len(last) == 1:
        (snap,) = last.values()
        folded = dict(snap.get("folded") or {})
        if snap.get("other"):
            folded[OTHER_KEY] = (folded.get(OTHER_KEY, 0)
                                 + int(snap["other"]))
        merged = {"samples": int(snap.get("samples") or 0),
                  "step_samples": int(snap.get("step_samples") or 0),
                  "phases": dict(snap.get("phases") or {}),
                  "folded": folded}
    else:
        merged = merge_profiles(last)
        folded = dict(merged["folded"])
    phases = {name: n for name, n
              in sorted((merged.get("phases") or {}).items(),
                        key=lambda kv: -kv[1])}
    top = [{"frame": stack.rsplit(";", 1)[-1], "samples": int(n)}
           for stack, n in sorted(folded.items(),
                                  key=lambda kv: -kv[1])[:3]
           if not stack.endswith(OTHER_KEY)]
    return {"snapshots": len(last),
            "samples": int(merged.get("samples") or 0),
            "step_samples": int(merged.get("step_samples") or 0),
            "phases": phases, "top_frames": top}


def _monitor_block(stanzas, request_recs) -> dict | None:
    """Merge each stanza's LAST schema-v7 ``"monitor"`` snapshot (a
    process's sketches are cumulative, so its last snapshot is its
    total; summing the last per stanza is the whole run) and
    cross-check the merged sketch quantiles against the exact offline
    request percentiles. `within_bound` uses the sketch's own recorded
    rel_err — the live/offline parity contract the acceptance pins."""
    from shallowspeed_tpu_torch.telemetry.report import percentile
    from shallowspeed_tpu_torch.telemetry.sketch import MetricSketches

    last_snaps = []
    for st in stanzas:
        snaps = [r for r in st["lines"] if r.get("event") == "monitor"
                 and isinstance(r.get("sketches"), dict)]
        if snaps:
            last_snaps.append(snaps[-1])
    if not last_snaps:
        return None
    # bucket indices are only comparable on ONE gamma grid
    # (LogHistogram.merge raises on a rel_err mismatch) — snapshots
    # from mixed-precision producers (two builds/configs in one
    # supervised history) reduce to the LARGEST same-rel_err group
    # and the report says how many were left out, instead of the
    # reducer crashing on a schema-valid file
    by_err: dict[float, list] = {}
    for s in last_snaps:
        by_err.setdefault(float(s.get("rel_err", 0.01)), []).append(s)
    rel_err, group = max(by_err.items(), key=lambda kv: len(kv[1]))
    merged = MetricSketches(rel_err=rel_err)
    n_merged = 0
    for snap in group:
        try:
            merged.merge_dict(snap["sketches"])
            n_merged += 1
        except (ValueError, TypeError):
            # a hand-edited snapshot whose per-sketch rel_err
            # disagrees with its own header; skip it, keep reducing
            continue
    if not n_merged:
        return None
    out = {"snapshots": n_merged, "rel_err": rel_err,
           "quantiles": merged.summary()}
    if n_merged < len(last_snaps):
        out["skipped_mixed_rel_err"] = len(last_snaps) - n_merged
    parity = {}
    for name in ("ttft_ms", "tpot_ms"):
        exact_vals = [r[name] for r in request_recs
                      if isinstance(r.get(name), (int, float))]
        sk = merged.sketches.get(name)
        if not exact_vals or sk is None or not sk.n:
            continue
        for q in (50, 95):
            exact = percentile(exact_vals, q)
            live = sk.quantile(q)
            parity[f"{name}_p{q}"] = {
                "sketch": round(live, 3), "exact": round(exact, 3),
                "within_bound": abs(live - exact)
                <= rel_err * abs(exact) + 1e-9,
            }
    if parity:
        out["parity"] = parity
    return out


def format_report(rep: dict) -> str:
    """Human-readable goodput report (the --goodput CLI surface)."""
    lines = [
        f"wall clock     {rep['wall_clock_s']:>10.2f} s",
        f"productive     {rep['productive_s']:>10.2f} s   "
        f"goodput {rep['goodput'] if rep['goodput'] is not None else '—'}",
    ]
    wall = rep["wall_clock_s"] or 1.0
    for kind, secs in sorted(rep["losses"].items(),
                             key=lambda kv: -kv[1]):
        lines.append(f"  - {kind:<18} {secs:>8.2f} s  "
                     f"({secs / wall:6.1%})")
    extra = {k: v for k, v in rep["counts"].items() if v}
    if extra:
        lines.append(f"counts: {extra}")
    for cls, m in sorted(rep.get("mttr", {}).items()):
        aborts = {k: v for k, v in m.items()
                  if k.endswith("_abort") and v}
        lines.append(
            f"mttr[{cls:<12}] {m['count']} recover(ies), mean "
            f"{m['mttr_s'] if m['mttr_s'] is not None else '—'} s"
            + (f"  {aborts}" if aborts else ""))
    if rep.get("faults"):
        lines.append(f"injected faults: {rep['faults']}")
    req = rep.get("requests")
    if req:
        def ms(v):
            return "—" if v is None else f"{v:.1f}"

        lines.append(
            f"requests {req['n_requests']}  "
            f"ttft p50/p95 {ms(req['ttft_ms_p50'])}/"
            f"{ms(req['ttft_ms_p95'])} ms  "
            f"tpot p50/p95 {ms(req['tpot_ms_p50'])}/"
            f"{ms(req['tpot_ms_p95'])} ms  "
            f"tokens {req['tokens_in']}->{req['tokens_out']}  "
            f"preempted {req['preempted']}")
    pfx = rep.get("prefix")
    if pfx:
        hr = pfx.get("hit_rate")
        sf = pfx.get("skipped_frac")
        lines.append(
            f"prefix cache: {pfx['requests_hit']}/"
            f"{pfx['requests_observed']} request(s) hit"
            + (f" ({hr:.0%})" if hr is not None else "")
            + f", {pfx['prefill_skipped_tokens']} prefill "
            f"token(s) skipped"
            + (f" ({sf:.0%} of prompt tokens)" if sf is not None else "")
            + (f", {pfx['cold_blocks']} cold block(s)"
               if pfx.get("cold_blocks") is not None else ""))
    mem = rep.get("memory")
    if mem:
        bits = []
        if mem.get("worst_headroom_blocks") is not None:
            bits.append(f"worst headroom "
                        f"{mem['worst_headroom_blocks']} blocks")
        if mem.get("oom_events"):
            oo = mem.get("worst_oom") or {}
            bits.append(
                f"{mem['oom_events']} recovered OOM(s)"
                + (f" (worst: need {oo['requested']}, "
                   f"{oo.get('free', 0)} free + {oo.get('cold', 0)} "
                   f"cold)" if "requested" in oo else ""))
        if mem.get("untracked_mib") is not None:
            bits.append(f"untracked {mem['untracked_mib']} MiB")
        if mem.get("peak_host_rss_mib") is not None:
            bits.append(f"host rss peak {mem['peak_host_rss_mib']} MiB")
        if bits:
            lines.append("memory: " + "  ".join(bits))
        if mem.get("owners_mib"):
            top = sorted(mem["owners_mib"].items(),
                         key=lambda kv: -kv[1])[:4]
            lines.append("  owners: " + "  ".join(
                f"{k} {v} MiB" for k, v in top))
        if mem.get("verdicts"):
            lines.append(f"  MEMORY verdicts: {mem['verdicts']}")
    lc = rep.get("lifecycle")
    if lc:
        top = sorted(lc["by_phase_ms"].items(),
                     key=lambda kv: -kv[1])[:4]
        lines.append(
            f"lifecycle ({lc['complete']}/{lc['requests']} complete): "
            + "  ".join(f"{k} {v:.0f} ms" for k, v in top))
    fl = rep.get("fleet")
    if fl:
        lines.append(
            f"fleet [{', '.join(fl['replicas'])}]: "
            f"{fl['routes']} route(s), {fl['failovers']} failover(s), "
            f"{fl['breaker_trips']} breaker trip(s)"
            + (f", scale {fl['scale']}" if fl["scale"] else ""))
        for name, m in sorted(fl["mttr"].items()):
            lines.append(
                f"  mttr[{name:<8}] {m['count']} recover(ies), mean "
                f"{m['mttr_s']} s   availability "
                f"{fl['availability'].get(name)}")
        if fl["fleet_availability"] is not None:
            lines.append(
                f"  fleet availability {fl['fleet_availability']:.2%}")
    tr = rep.get("tracing")
    if tr:
        comps = "  ".join(
            f"{name[3:]} {c['p50_ms']:.0f}/{c['p95_ms']:.0f}"
            for name, c in tr["components"].items())
        lines.append(
            f"tracing ({tr['requests']} request(s), e2e p50 "
            f"{tr['e2e_p50_ms']:.0f} ms) p50/p95 ms: {comps}")
        worst = tr["worst_unexplained"][0] \
            if tr["worst_unexplained"] else None
        if worst and abs(worst["rq_unexplained_ms"]) >= 1.0:
            lines.append(
                f"  worst unexplained: request {worst['id']} "
                f"({worst['rq_unexplained_ms']:.1f} ms of "
                f"{worst['e2e_ms']:.1f} ms e2e)")
    mon = rep.get("monitor")
    if mon:
        qs = mon["quantiles"]
        parts = [f"{name} p50/p95 {sk.get('p50')}/{sk.get('p95')}"
                 for name, sk in qs.items()
                 if name in ("step_ms", "ttft_ms", "tpot_ms")]
        lines.append(f"monitor sketches ({mon['snapshots']} snapshot(s)"
                     f", rel_err {mon['rel_err']}): "
                     + "  ".join(parts))
        bad = [k for k, v in mon.get("parity", {}).items()
               if not v["within_bound"]]
        if bad:
            lines.append(f"  WARNING: sketch/offline parity out of "
                         f"bound: {bad}")
    num = rep.get("numerics")
    if num:
        def g(v):
            return "—" if v is None else f"{v:.3g}"

        lines.append(
            f"numerics ({num.get('steps_fp8', num['steps_observed'])} "
            f"fp8 / {num['steps_observed']} observed step(s), "
            f"{num['shadow_samples']} shadow sample(s)): "
            f"overflow max {g(num['overflow_max'])}  "
            f"underflow max {g(num['underflow_max'])}  "
            f"scale min {g(num['scale_min'])}  "
            f"parity loss/grad {g(num['parity_loss_rel_max'])}/"
            f"{g(num['parity_grad_relmax_max'])}")
        if num["verdicts"] or num["fell_back_bf16"]:
            lines.append(
                f"  verdicts: {num['verdicts'] or '{}'}"
                + (f"  FELL BACK to bf16 (final precision "
                   f"{num['final_precision']})"
                   if num["fell_back_bf16"] else ""))
    prof = rep.get("profiling")
    if prof and prof["samples"]:
        tot = prof["samples"]
        parts = [f"{name} {n / tot:.0%}"
                 for name, n in list(prof["phases"].items())[:4]]
        lines.append(
            f"profiling ({tot} host sample(s), {prof['snapshots']} "
            f"snapshot(s)): " + "  ".join(parts))
        if prof["top_frames"]:
            hot = prof["top_frames"][0]
            lines.append(f"  hottest frame: {hot['frame']} "
                         f"({hot['samples'] / tot:.0%})")
    if rep.get("availability") is not None:
        lines.append(f"availability {rep['availability']:.2%}")
    lines.append(f"accounted {rep['accounted_frac'] if rep['accounted_frac'] is not None else '—'}"
                 f" of wall clock over {rep['stanzas']} process(es)")
    return "\n".join(lines)
